"""Quaternion helpers with the trailing-component convention (..., 4),
wxyz (scalar first), as in MuJoCo.

The helpers the walker's observables and the imitation rewards need, from
the JAX package's ``math/quaternions.py``. Edge cases are masked with
``torch.where`` (no data-dependent branches), so every function takes any
batch shape and broadcasts."""

from __future__ import annotations

import torch

_EPS = 1e-12


def _safe_norm(x: torch.Tensor, dim: int = -1,
               keepdim: bool = True) -> torch.Tensor:
    """Norm that is safe to evaluate (and differentiate) at zero."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))


def mult_quat(quat1: torch.Tensor, quat2: torch.Tensor) -> torch.Tensor:
    """Hamilton product quat1 * quat2; any leading batch dims,
    broadcasting."""
    a1, b1, c1, d1 = quat1.unbind(-1)
    a2, b2, c2, d2 = quat2.unbind(-1)
    return torch.stack([
        a1 * a2 - b1 * b2 - c1 * c2 - d1 * d2,
        a1 * b2 + b1 * a2 + c1 * d2 - d1 * c2,
        a1 * c2 - b1 * d2 + c1 * a2 + d1 * b2,
        a1 * d2 + b1 * c2 - c1 * b2 + d1 * a2,
    ], dim=-1)


def conj_quat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate: negate the vector part."""
    return torch.cat([quat[..., :1], -quat[..., 1:]], dim=-1)


def reciprocal_quat(quat: torch.Tensor) -> torch.Tensor:
    """Reciprocal: mult_quat(quat, reciprocal_quat(quat)) == [1, 0, 0, 0]."""
    sq = torch.sum(quat * quat, dim=-1, keepdim=True)
    return conj_quat(quat) / torch.clamp(sq, min=_EPS)


def get_dquat(quat1: torch.Tensor, quat2: torch.Tensor) -> torch.Tensor:
    """Delta quaternion: mult_quat(dquat, quat1) == quat2."""
    return mult_quat(quat2, reciprocal_quat(quat1))


def get_dquat_local(quat1: torch.Tensor,
                    quat2: torch.Tensor) -> torch.Tensor:
    """Delta quaternion in quat1's local frame."""
    return mult_quat(reciprocal_quat(quat1), quat2)


def rotate_vec_with_quat(vec: torch.Tensor, quat: torch.Tensor):
    """Rotate vector(s) by unit quaternion(s): vec' = q vec q^-1
    (expanded Rodrigues form; non-unit quats are normalised)."""
    w = quat[..., :1]
    u = quat[..., 1:]
    s2 = torch.sum(quat * quat, dim=-1, keepdim=True)
    u, vec = torch.broadcast_tensors(u, vec)
    uv = torch.linalg.cross(u, vec, dim=-1)
    uuv = torch.linalg.cross(u, uv, dim=-1)
    return vec + 2 * (w * uv + uuv) / torch.clamp(s2, min=_EPS)


def get_egocentric_vec(root_xpos: torch.Tensor, site_xpos: torch.Tensor,
                       root_quat: torch.Tensor) -> torch.Tensor:
    """(site_xpos - root_xpos) expressed in the root's local frame."""
    return rotate_vec_with_quat(site_xpos - root_xpos, conj_quat(root_quat))


def axis_angle_to_quat(axis: torch.Tensor,
                       angle: torch.Tensor) -> torch.Tensor:
    """Axis-angle -> unit quaternion; axis need not be normalised. axis
    (..., 3), angle (...)."""
    axis = axis / _safe_norm(axis)
    half = angle[..., None] / 2
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_z2vec(vec: torch.Tensor) -> torch.Tensor:
    """Unit quaternion rotating the z-axis onto ``vec``. Rows with
    x == y == 0 (zero, +z, -z) are degenerate: -z gives 180 degrees about
    x, the others the identity."""
    degenerate = torch.all(vec[..., :2] == 0.0, dim=-1, keepdim=True)
    ex = vec.new_tensor([1.0, 0.0, 0.0])
    # a placeholder direction keeps the math below finite on those rows
    safe_vec = torch.where(degenerate, ex, vec)
    unit = safe_vec / _safe_norm(safe_vec)
    axis = torch.stack([-unit[..., 1], unit[..., 0],
                        torch.zeros_like(unit[..., 0])], dim=-1)
    axis = axis / _safe_norm(axis)
    angle = torch.arccos(torch.clamp(unit[..., 2:3], -1.0, 1.0))
    quat = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2) * axis],
                     dim=-1)
    neg_z = degenerate & (vec[..., 2:3] < 0)
    quat = torch.where(degenerate, vec.new_tensor([1.0, 0.0, 0.0, 0.0]),
                       quat)
    return torch.where(neg_z, vec.new_tensor([0.0, 1.0, 0.0, 0.0]), quat)


def quat_dist_short_arc(quat1: torch.Tensor,
                        quat2: torch.Tensor) -> torch.Tensor:
    """Shortest geodesic angle between two unit quaternions, in [0, pi).
    arccos(2 <q1, q2>^2 - 1): near identical quaternions a rounding error
    e of the argument becomes an angle of ~sqrt(2 e)."""
    q1 = quat1 / _safe_norm(quat1)
    q2 = quat2 / _safe_norm(quat2)
    x = 2 * torch.sum(q1 * q2, dim=-1) ** 2 - 1
    return torch.arccos(torch.clamp(x, -1.0, 1.0))


def joint_orientation_quat(xaxis: torch.Tensor,
                           qpos: torch.Tensor) -> torch.Tensor:
    """Joint orientation quat from the joint axis (..., 3) and the joint
    angle (...)."""
    return mult_quat(axis_angle_to_quat(xaxis, qpos), quat_z2vec(xaxis))
