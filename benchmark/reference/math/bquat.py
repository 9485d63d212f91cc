"""Quaternion/rotation ops for batch-native physics tensors.

Layout of the engine (physics/types.py): entity-major with a trailing batch
axis: quats are (..., 4, B), vectors (..., 3, B), matrices (..., 3, 3, B).
The component axis is ``-2`` everywhere here.
"""

from __future__ import annotations

import torch


def _c(x, i):
    return x[..., i, :]


def mult(u, v):
    """Hamilton product, component axis -2."""
    w1, x1, y1, z1 = _c(u, 0), _c(u, 1), _c(u, 2), _c(u, 3)
    w2, x2, y2, z2 = _c(v, 0), _c(v, 1), _c(v, 2), _c(v, 3)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-2)


def conj(q):
    return torch.cat([q[..., :1, :], -q[..., 1:, :]], dim=-2)


def rotate(v, q):
    """Rotate vectors v (..., 3, B) by quats q (..., 4, B)."""
    w, x, y, z = _c(q, 0), _c(q, 1), _c(q, 2), _c(q, 3)
    vx, vy, vz = _c(v, 0), _c(v, 1), _c(v, 2)
    # t = 2 q_vec x v ; out = v + w t + q_vec x t
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return torch.stack([
        vx + w * tx + (y * tz - z * ty),
        vy + w * ty + (z * tx - x * tz),
        vz + w * tz + (x * ty - y * tx),
    ], dim=-2)


def rotate_inv(v, q):
    return rotate(v, conj(q))


def axis_angle(axis, angle):
    """axis (..., 3, B) unit, angle (..., B) -> quat (..., 4, B)."""
    half = 0.5 * angle
    s = torch.sin(half)
    return torch.cat([torch.cos(half)[..., None, :],
                      axis * s[..., None, :]], dim=-2)


def to_mat(q):
    """(..., 4, B) -> rotation matrices (..., 3, 3, B)."""
    w, x, y, z = _c(q, 0), _c(q, 1), _c(q, 2), _c(q, 3)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-2),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-2),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-2),
    ], dim=-3)


def _sign_nz(x):
    """sign(x) with x == 0 treated as +1e-30 (i.e. +1)."""
    return torch.where(x == 0, torch.ones_like(x), torch.sign(x))


def from_mat(R):
    """(..., 3, 3, B) -> quat (..., 4, B). Branchless Shepperd variant."""
    m00, m01, m02 = R[..., 0, 0, :], R[..., 0, 1, :], R[..., 0, 2, :]
    m10, m11, m12 = R[..., 1, 0, :], R[..., 1, 1, :], R[..., 1, 2, :]
    m20, m21, m22 = R[..., 2, 0, :], R[..., 2, 1, :], R[..., 2, 2, :]
    tr = m00 + m11 + m22
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-20))
    qx = 0.5 * torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-20))
    qy = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-20))
    qz = 0.5 * torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-20))
    qx = qx * _sign_nz(m21 - m12)
    qy = qy * _sign_nz(m02 - m20)
    qz = qz * _sign_nz(m10 - m01)
    q = torch.stack([qw, qx, qy, qz], dim=-2)
    return q / torch.linalg.vector_norm(q, dim=-2, keepdim=True)


def integrate(q, w, h):
    """Integrate quats by angular velocity w (local frame) over h
    (mju_quatIntegrate: rotation by |w| h about w-hat, on the right)."""
    angle = torch.sqrt(torch.sum(w * w, dim=-2)) + 1e-30
    axis = w / angle[..., None, :]
    dq = axis_angle(axis, angle * h)
    out = mult(q, dq)
    return out / torch.linalg.vector_norm(out, dim=-2, keepdim=True)


def cross(a, b):
    """Cross product with component axis -2."""
    ax, ay, az = _c(a, 0), _c(a, 1), _c(a, 2)
    bx, by, bz = _c(b, 0), _c(b, 1), _c(b, 2)
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-2)


def norm(v, axis=-2):
    return torch.sqrt(torch.sum(v * v, dim=axis))


def dot(a, b, axis=-2):
    return torch.sum(a * b, dim=axis)


def matvec(R, v):
    """(..., 3, 3, B) @ (..., 3, B) -> (..., 3, B)."""
    return torch.sum(R * v[..., None, :, :], dim=-2)


def matvec_t(R, v):
    """R^T v with R (..., 3, 3, B)."""
    return torch.sum(R * v[..., :, None, :], dim=-3)


def matmat(A, Bm):
    """(..., 3, 3, B) @ (..., 3, 3, B)."""
    return torch.einsum("...ikB,...kjB->...ijB", A, Bm)
