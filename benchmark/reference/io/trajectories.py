"""Reference-trajectory datasets of the imitation tasks.

Host-side loading (HDF5, groups ``trajectories/NNN`` with qpos / qvel /
root2site / joint_quat for walking, com_qpos / com_qvel for flight) into
padded tensors (num_traj, max_len, dim) plus lengths;
``TrajectoryDataset.to`` moves them to the env's device, where a snippet
is a tensor index into them, chosen per env.

``synthetic_walking_dataset`` and ``synthetic_flight_dataset`` make small
datasets so the tasks run without data files. They are numpy with the JAX
package's draws, so both packages hold the same datasets bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TrajectoryDataset:
    """Padded snippet store. Reading the sizes needs no device sync."""
    fields: dict               # name -> (num_traj, max_len, ...) tensors
    lengths: torch.Tensor      # (num_traj,) int64
    timestep: float

    @property
    def num_trajectories(self) -> int:
        return int(self.lengths.shape[0])

    @property
    def max_len(self) -> int:
        return int(next(iter(self.fields.values())).shape[1])

    def to(self, device=None, dtype=None) -> "TrajectoryDataset":
        """The dataset on ``device``, its fields cast to ``dtype``."""
        return TrajectoryDataset(
            fields={k: v.to(device=device, dtype=dtype)
                    for k, v in self.fields.items()},
            lengths=self.lengths.to(device=device), timestep=self.timestep)


def _pad_stack(arrays: list) -> tuple:
    max_len = max(a.shape[0] for a in arrays)
    out = np.zeros((len(arrays), max_len) + arrays[0].shape[1:],
                   dtype=np.float32)
    lengths = np.zeros(len(arrays), dtype=np.int32)
    for i, a in enumerate(arrays):
        out[i, :a.shape[0]] = a
        # hold the last frame in the padding region (safe gather targets)
        out[i, a.shape[0]:] = a[-1]
        lengths[i] = a.shape[0]
    return out, lengths


def _dataset(fields: dict, lengths: np.ndarray,
             timestep: float) -> TrajectoryDataset:
    return TrajectoryDataset(
        fields={k: torch.as_tensor(v) for k, v in fields.items()},
        lengths=torch.as_tensor(lengths.astype(np.int64)),
        timestep=timestep)


def load_hdf5_walking(path: str, keys=("qpos", "qvel", "root2site",
                                       "joint_quat")) -> TrajectoryDataset:
    """Load a walking HDF5 dataset (float32 fields, on the CPU)."""
    import h5py

    with h5py.File(path, "r") as f:
        timestep = float(f["timestep_seconds"][()]) \
            if "timestep_seconds" in f else 2e-3
        names = sorted(f["trajectories"].keys())
        fields = {}
        lengths = None
        for key in keys:
            arrays = []
            for n in names:
                g = f["trajectories"][n]
                if key in ("qpos", "qvel") and "root_" + key in g:
                    a = np.concatenate([g["root_" + key][()], g[key][()]],
                                       axis=-1)
                else:
                    a = g[key][()]
                arrays.append(np.asarray(a, np.float32))
            fields[key], lengths = _pad_stack(arrays)
    return _dataset(fields, lengths, timestep)


def synthetic_walking_dataset(qpos0: np.ndarray, n_joints: int,
                              n_sites: int, num_traj: int = 4,
                              length: int = 200, timestep: float = 2e-3,
                              speeds=(0.5, 1.0, 1.5, 2.0),
                              seed: int = 0) -> TrajectoryDataset:
    """Straight-line walking snippets at several speeds, neutral pose with
    a small gait-like joint oscillation.

    qpos layout: [root pos(3), root quat(4), joints(n_joints)]."""
    rng = np.random.RandomState(seed)
    qpos_l, qvel_l, r2s_l, jq_l = [], [], [], []
    for i in range(num_traj):
        v = speeds[i % len(speeds)]
        t = np.arange(length) * timestep
        qpos = np.tile(qpos0[None], (length, 1)).astype(np.float32)
        qpos[:, 0] += v * t                      # walk along +x
        qpos[:, 2] = qpos0[2]
        qvel = np.zeros((length, 6 + n_joints), np.float32)
        qvel[:, 0] = v
        phase = 2 * np.pi * 10.0 * t[:, None] \
            + rng.uniform(0, 2 * np.pi, (1, n_joints))
        qpos[:, 7:] += 0.05 * np.sin(phase).astype(np.float32)
        qvel[:, 6:] = (0.05 * 2 * np.pi * 10.0
                       * np.cos(phase)).astype(np.float32)
        r2s = np.tile(
            rng.uniform(-0.1, 0.1, (1, n_sites, 3)).astype(np.float32),
            (length, 1, 1))
        jq = np.zeros((length, n_joints, 4), np.float32)
        jq[..., 0] = 1.0
        qpos_l.append(qpos)
        qvel_l.append(qvel)
        r2s_l.append(r2s)
        jq_l.append(jq)
    fields = {}
    for name, arrs in (("qpos", qpos_l), ("qvel", qvel_l),
                       ("root2site", r2s_l), ("joint_quat", jq_l)):
        fields[name], lengths = _pad_stack(arrs)
    return _dataset(fields, lengths, timestep)


def load_hdf5_flight(path: str) -> TrajectoryDataset:
    """Load a flight (com) HDF5 dataset (float32 fields, on the CPU); each
    trajectory's initial xy is moved to the origin."""
    import h5py

    with h5py.File(path, "r") as f:
        timestep = float(f["timestep_seconds"][()]) \
            if "timestep_seconds" in f else 2e-4
        names = sorted(f["trajectories"].keys())
        qpos_l, qvel_l = [], []
        for n in names:
            g = f["trajectories"][n]
            qp = np.asarray(g["com_qpos"][()], np.float32)
            qp[:, :2] -= qp[0, :2]
            qpos_l.append(qp)
            qvel_l.append(np.asarray(g["com_qvel"][()], np.float32))
    qpos, lengths = _pad_stack(qpos_l)
    qvel, _ = _pad_stack(qvel_l)
    return _dataset({"com_qpos": qpos, "com_qvel": qvel}, lengths, timestep)


def synthetic_flight_dataset(num_traj: int = 4, length: int = 3000,
                             timestep: float = 2e-4, height: float = 1.0,
                             speeds=(20.0, 30.0, 40.0, 50.0),
                             seed: int = 0) -> TrajectoryDataset:
    """Straight-and-level flight com trajectories (cm units)."""
    qpos_l, qvel_l = [], []
    for i in range(num_traj):
        v = speeds[i % len(speeds)]
        t = np.arange(length) * timestep
        qpos = np.zeros((length, 7), np.float32)
        qpos[:, 0] = v * t
        qpos[:, 2] = height
        qpos[:, 3] = 1.0  # identity quat
        qvel = np.zeros((length, 6), np.float32)
        qvel[:, 0] = v
        qpos_l.append(qpos)
        qvel_l.append(qvel)
    qpos, lengths = _pad_stack(qpos_l)
    qvel, _ = _pad_stack(qvel_l)
    return _dataset({"com_qpos": qpos, "com_qvel": qvel}, lengths, timestep)
