"""Imitation reward features and DeepMimic factored rewards, batched.

Pose features (com, qvel, egocentric root->site vectors, joint orientation
quaternions) of the walker and of the reference trajectory, compared with
per-feature Gaussian factors. Every function takes the whole batch: a
feature keeps the env axis last, as ``Data`` does (com (3, B), qvel
(n, B), root2site (n_sites, 3, B), joint_quat (n_joints + 1, 4, B)).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.math import quaternions as mq
from benchmark.reference.physics.types import Data, Model

# Default stds for fruitfly walking imitation
DEFAULT_STDS = {
    "com": 0.078487,
    "qvel": 53.7801,
    "root2site": 0.0735,
    "joint_quat": 1.2247,
}


def _quat_last(x: torch.Tensor) -> torch.Tensor:
    """(..., 4, B) -> (B, ..., 4), the quaternion helpers' layout."""
    return x.movedim(-1, 0)


def compute_diffs(walker_features: dict, reference_features: dict,
                  n: int = 2) -> dict:
    """Per env (B,), the sum of |differences|^n of each feature; the
    geodesic distance for quaternions."""
    diffs = {}
    for k, w in walker_features.items():
        r = reference_features[k]
        if "quat" not in k:
            d = torch.abs(w - r) ** n
            diffs[k] = d.reshape(-1, d.shape[-1]).sum(dim=0)
        else:
            d = mq.quat_dist_short_arc(_quat_last(w), _quat_last(r)) ** n
            diffs[k] = d.reshape(d.shape[0], -1).sum(dim=1)
    return diffs


def get_walker_features(model: Model, data: Data, joint_dofadr: np.ndarray,
                        joint_ids: np.ndarray, site_ids: np.ndarray,
                        root_qposadr: int = 0) -> dict:
    """Model pose features of the batch.

    joint_ids / joint_dofadr: the walker's scalar joints (not the free
    root); site_ids: end-effector (tracking) sites."""
    a = root_qposadr
    root_pos = data.qpos[a:a + 3].T                     # (B, 3)
    root_quat = data.qpos[a + 3:a + 7].T                # (B, 4)
    sites = data.site_xpos[model.ix(site_ids)].permute(2, 0, 1)  # (B, n, 3)
    root2site = mq.get_egocentric_vec(root_pos[:, None], sites,
                                      root_quat[:, None])

    # joint axes in the root-local frame -> joint orientation quats
    xaxis = data.xaxis[model.ix(joint_ids)].permute(2, 0, 1)     # (B, n, 3)
    xaxis_local = mq.rotate_vec_with_quat(
        xaxis, mq.reciprocal_quat(root_quat)[:, None])
    qadr = np.asarray(model.jnt_qposadr)[np.asarray(joint_ids)]
    qpos_joints = data.qpos[model.ix(qadr)].T                    # (B, n)
    joint_quat = mq.joint_orientation_quat(xaxis_local, qpos_joints)
    joint_quat = torch.cat([root_quat[:, None], joint_quat], dim=1)

    qvel = (torch.cat([data.qvel[:6], data.qvel[model.ix(joint_dofadr)]])
            if root_qposadr == 0 else data.qvel)
    return {
        "com": root_pos.T,
        "qvel": qvel,
        "root2site": root2site.movedim(0, -1),
        "joint_quat": joint_quat.movedim(0, -1),
    }


def get_reference_features(reference: dict, traj_idx: torch.Tensor,
                           step: torch.Tensor) -> dict:
    """Reference pose features of each env's snippet ``traj_idx`` (B,) at
    its step ``step`` (B,). ``reference`` holds the dataset's fields
    qpos / qvel / root2site / joint_quat, (num_traj, max_len, ...); only
    the B frames are gathered."""
    frame = {k: reference[k][traj_idx, step]
             for k in ("qpos", "qvel", "root2site", "joint_quat")}
    qpos_ref = frame["qpos"]                            # (B, nq_ref)
    joint_quat = torch.cat([qpos_ref[:, None, 3:7], frame["joint_quat"]],
                           dim=1)                       # (B, n + 1, 4)
    return {
        "com": qpos_ref[:, :3].T,
        "qvel": frame["qvel"].T,
        "root2site": frame["root2site"].movedim(0, -1),
        "joint_quat": joint_quat.movedim(0, -1),
    }


def reward_factors_deep_mimic(walker_features: dict,
                              reference_features: dict, std=None,
                              weights=(1, 1, 1, 1)) -> torch.Tensor:
    """The four DeepMimic reward factors (com, qvel, end-effectors,
    joints) of each env, (4, B), each times its weight."""
    if std is None:
        std = DEFAULT_STDS
    diffs = compute_diffs(walker_features, reference_features, n=2)
    factors = torch.stack([torch.exp(-0.5 / std[k] ** 2 * diffs[k])
                           for k in walker_features])
    w = torch.as_tensor(weights, dtype=factors.dtype,
                        device=factors.device)
    return factors * w[:, None]
