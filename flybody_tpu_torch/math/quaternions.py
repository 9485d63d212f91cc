"""Quaternion helpers with the trailing-component convention (..., 4).

The two helpers the walker's observables need, from the JAX package's
``math/quaternions.py``."""

from __future__ import annotations

import torch

_EPS = 1e-12


def conj_quat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate: negate the vector part."""
    return torch.cat([quat[..., :1], -quat[..., 1:]], dim=-1)


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
