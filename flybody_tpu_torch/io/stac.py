"""STAC output -> the tracking task's clip files (reference
trajectory_rodent.py:174-249).

STAC (simultaneous tracking and calibration) stores each clip's walker
kinematics as transposed feature arrays under ``<clip>/walkers/walker_0``:
position (3, T), quaternion (4, T), joints (nj, T), velocity (3, T),
angular_velocity (3, T), joints_velocity (nj, T).

``convert_stac`` rewrites them into one group per clip with row-major
``qpos`` (T, nq) = [pos, quat, joints] and ``qvel`` (T, nv) = [vel,
angvel, joints_velocity], which ``tasks.tracking.load_hdf5_clips`` loads,
plus the reference's ``id2name`` joint and site name tables,
``timestep_seconds`` and ``trajectory_lengths``. The engine-side features
(body poses, egocentric appendages) are computed from qpos by
``tracking.build_clip_features`` on the compiled model. Both functions
need h5py, imported inside them.
"""

from __future__ import annotations

import numpy as np


def _walker_group(f, clip_key):
    g = f[clip_key]
    if "walkers" in g:
        return g["walkers"]["walker_0"]
    return g


def convert_stac(input_path: str, output_path: str,
                 timestep_seconds: float = 0.02, joint_names=(),
                 site_names=()) -> int:
    """Convert a STAC HDF5 file to the clip layout; returns the number of
    clips."""
    import h5py

    n = 0
    with h5py.File(input_path, "r") as fin, \
            h5py.File(output_path, "w") as fout:
        id2name = fout.create_group("id2name")
        id2name.create_dataset(
            "joints", data=np.array(list(joint_names), dtype="S"))
        id2name.create_dataset(
            "sites", data=np.array(list(site_names), dtype="S"))
        fout.create_dataset("timestep_seconds", data=timestep_seconds)
        lengths = []
        for clip_key in fin.keys():
            w0 = _walker_group(fin, clip_key)
            if "position" not in w0:
                continue
            col = lambda name: np.asarray(w0[name]).T
            qpos = np.concatenate([col("position"), col("quaternion"),
                                   col("joints")], axis=-1)
            qvel = np.concatenate([col("velocity"), col("angular_velocity"),
                                   col("joints_velocity")], axis=-1)
            key = clip_key[5:] if clip_key.startswith("clip_") else clip_key
            g = fout.create_group(key)
            g.create_dataset("qpos", data=qpos.astype(np.float32))
            g.create_dataset("qvel", data=qvel.astype(np.float32))
            lengths.append(qpos.shape[0])
            n += 1
        fout.create_dataset("trajectory_lengths",
                            data=np.asarray(lengths, np.int64))
    return n


def write_stac_fixture(path: str, num_clips: int = 2, length: int = 50,
                       nj: int = 67, seed: int = 0) -> None:
    """A synthetic STAC-layout file (numpy draws from ``seed``, the JAX
    package's), for tests and standalone runs."""
    import h5py

    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        for i in range(num_clips):
            w = f.create_group(f"clip_{i}/walkers/walker_0")
            t = np.arange(length) * 0.02
            w.create_dataset("position",
                             data=np.stack([0.1 * t, 0 * t, 0.06 + 0 * t]))
            w.create_dataset("quaternion", data=np.tile(
                np.array([1.0, 0, 0, 0])[:, None], (1, length)))
            w.create_dataset("joints", data=0.05 * rng.randn(nj, length))
            w.create_dataset("velocity",
                             data=np.stack([0.1 + 0 * t, 0 * t, 0 * t]))
            w.create_dataset("angular_velocity", data=np.zeros((3, length)))
            w.create_dataset("joints_velocity",
                             data=0.01 * rng.randn(nj, length))
