"""Quaternion helpers with the trailing-component convention (..., 4),
wxyz (scalar first), as in MuJoCo.

The JAX package's ``math/quaternions.py``: the helpers of the walkers'
observables, the imitation and tracking rewards, the tracking clips and
the conversions. Edge cases are masked with ``torch.where`` (no
data-dependent branches), so every function takes any batch shape and
broadcasts."""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _safe_norm(x: torch.Tensor, dim: int = -1,
               keepdim: bool = True) -> torch.Tensor:
    """Norm that is safe to evaluate (and differentiate) at zero."""
    sq = torch.sum(x * x, dim=dim, keepdim=keepdim)
    return torch.sqrt(torch.clamp(sq, min=_EPS * _EPS))


def get_quat(theta, rot_axis=(0.0, 0.0, 1.0), dtype=None,
             device=None) -> torch.Tensor:
    """Unit quaternion of angle ``theta`` (radians; a number or a tensor
    (...), whose dtype it keeps) about ``rot_axis`` (3,), (..., 4)."""
    if dtype is None and not torch.is_tensor(theta):
        dtype = torch.get_default_dtype()
    theta = torch.as_tensor(theta, dtype=dtype, device=device)
    axis = torch.as_tensor(rot_axis, dtype=theta.dtype, device=theta.device)
    axis = axis / _safe_norm(axis)
    half = theta / 2
    return torch.cat([torch.cos(half)[..., None],
                      torch.sin(half)[..., None] * axis], dim=-1)


def random_quat(generator=None, shape=(), dtype=None,
                device=None) -> torch.Tensor:
    """Random unit quaternions (*shape, 4) from ``generator``: the angle
    uniform in [0, 2 pi) is drawn first, then the axis uniform in the cube
    [-1, 1]^3 (as the JAX package's draw, from another generator)."""
    dtype = dtype or torch.get_default_dtype()
    shape = tuple(shape)
    theta = 2 * math.pi * torch.rand(shape, generator=generator,
                                     dtype=dtype, device=device)
    axis = 2 * torch.rand(shape + (3,), generator=generator, dtype=dtype,
                          device=device) - 1
    return axis_angle_to_quat(axis, theta)


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


def vec_world_to_local(world_vec: torch.Tensor, root_quat: torch.Tensor,
                       hover_up_dir_quat=None) -> torch.Tensor:
    """A world-frame vector in the root's local frame (re-framed by
    ``hover_up_dir_quat`` where given)."""
    q = conj_quat(root_quat)
    if hover_up_dir_quat is not None:
        hover = torch.as_tensor(hover_up_dir_quat, dtype=q.dtype,
                                device=q.device).expand(q.shape)
        q = mult_quat(conj_quat(hover), q)
    return rotate_vec_with_quat(world_vec, q)


def vec_global_to_local(vec: torch.Tensor,
                        body_quat: torch.Tensor) -> torch.Tensor:
    """A vector in global coordinates in the body's local frame."""
    return rotate_vec_with_quat(vec, reciprocal_quat(body_quat))


def log_quat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion logarithm (non-unit quaternions too)."""
    norm_q = _safe_norm(quat)
    norm_v = _safe_norm(quat[..., 1:])
    angle = torch.arccos(torch.clamp(quat[..., :1] / norm_q, -1.0, 1.0))
    return torch.cat([torch.log(norm_q), quat[..., 1:] / norm_v * angle],
                     dim=-1)


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


def quat_to_angvel(quat: torch.Tensor, dt=1.0) -> torch.Tensor:
    """Orientation-difference quaternion -> angular velocity
    (mju_quat2Vel)."""
    sin_a_2 = _safe_norm(quat[..., 1:])
    axis = quat[..., 1:] / sin_a_2
    speed = 2 * torch.atan2(sin_a_2, quat[..., :1])
    speed = torch.where(speed > math.pi, speed - 2 * math.pi, speed)
    return speed * axis / dt


def quat_seq_to_angvel(quats: torch.Tensor, dt=1.0,
                       local_ref_frame: bool = False) -> torch.Tensor:
    """A sequence of orientations (T, 4) -> angular velocities (T-1, 3)."""
    ang_vel = quat_to_angvel(get_dquat(quats[:-1], quats[1:]), dt=dt)
    if local_ref_frame:
        ang_vel = vec_global_to_local(ang_vel, quats[:-1])
    return ang_vel


def quat_to_mat(quat: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix, (..., 3, 3)."""
    w, x, y, z = quat.unbind(-1)
    r = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return r.reshape(quat.shape[:-1] + (3, 3))


def mat_to_quat(mat: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (wxyz) with w >= 0. Four
    constructions, the trace's where it is positive, else the one of the
    largest diagonal entry, picked by ``torch.where``."""
    m = mat
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    tr = d0 + d1 + d2
    root = lambda x: torch.sqrt(torch.clamp(x, min=_EPS)) / 2
    qw, qx = root(1 + tr), root(1 + d0 - d1 - d2)
    qy, qz = root(1 - d0 + d1 - d2), root(1 - d0 - d1 + d2)
    a, b = m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0]
    c = m[..., 1, 0] - m[..., 0, 1]
    s01, s02 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]
    s12 = m[..., 1, 2] + m[..., 2, 1]
    q0 = torch.stack([qw, a / (4 * qw), b / (4 * qw), c / (4 * qw)], -1)
    q1 = torch.stack([a / (4 * qx), qx, s01 / (4 * qx), s02 / (4 * qx)], -1)
    q2 = torch.stack([b / (4 * qy), s01 / (4 * qy), qy, s12 / (4 * qy)], -1)
    q3 = torch.stack([c / (4 * qz), s02 / (4 * qz), s12 / (4 * qz), qz], -1)
    pick1 = ((d0 >= d1) & (d0 >= d2))[..., None]
    pick2 = (d1 >= d2)[..., None]
    q = torch.where((tr > 0)[..., None], q0,
                    torch.where(pick1, q1, torch.where(pick2, q2, q3)))
    q = q / _safe_norm(q)
    return torch.where(q[..., :1] < 0, -q, q)


def quat_integrate(quat: torch.Tensor, angvel: torch.Tensor,
                   dt) -> torch.Tensor:
    """``quat`` turned by the local angular velocity ``angvel`` over
    ``dt`` (mju_quatIntegrate: q exp(dt / 2 [0, w])), normalised."""
    angle = _safe_norm(angvel) * dt
    axis = angvel / _safe_norm(angvel)
    dq = torch.cat([torch.cos(angle / 2), torch.sin(angle / 2) * axis],
                   dim=-1)
    out = mult_quat(quat, dq)
    return out / _safe_norm(out)
