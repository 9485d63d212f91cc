"""Inverse kinematics by differentiating the forward kinematics.

The JAX package's ``inverse_kinematics.py`` (reference
vnl_ray/inverse_kinematics.py: momentum gradient descent on
||s(q) - s*||^2 + a ||q - q0||^2). The gradient comes from
``torch.autograd.grad`` through the port's ``physics.kinematics`` (its
level-by-level writes into preallocated tensors are differentiable index
writes), on every device: the forward pass's CUDA kernel
(``ops/kinematics_kernel.py``) has no backward. One objective is summed
over the whole batch, so each env gets its own gradient; the descent is
a plain loop of ``max_steps`` steps, batched over the env axis (e.g.
every frame of a clip at once).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics.types import Data, Model


@dataclasses.dataclass
class IKResult:
    qpos: torch.Tensor        # (nq, B)
    err_norm: torch.Tensor    # sqrt of the objective, over the batch
    site_error: torch.Tensor  # sqrt of the site term, over the batch
    steps: int


def qpos_from_site_xpos(model: Model, data: Data, site_ids,
                        target_xpos: torch.Tensor, dof_qposadr,
                        reg_strength: float = 0.0, lr: float = 0.01,
                        beta: float = 0.99, max_steps: int = 2000,
                        include_mask: torch.Tensor | None = None
                        ) -> IKResult:
    """qpos whose sites ``site_ids`` (S,) reach ``target_xpos`` (S, 3) or
    (S, 3, B), moving the qpos addresses ``dof_qposadr`` of ``data``.

    ``include_mask`` (S, 3) or (S, 3, B) 0/1 picks the Cartesian
    components that count."""
    site_ix = model.ix(np.asarray(site_ids))
    q_ix = model.ix(np.asarray(dof_qposadr))
    if target_xpos.ndim == 2:
        target_xpos = target_xpos[..., None]
    mask = (torch.ones_like(target_xpos) if include_mask is None
            else include_mask.to(target_xpos.dtype).reshape(
                target_xpos.shape))
    q0 = data.qpos[q_ix].detach()

    def objective(q):
        qpos = data.qpos.index_put((q_ix,), q)
        d = K.kinematics(model, data.replace(qpos=qpos))
        err = (d.site_xpos[site_ix] - target_xpos) * mask
        site_err = torch.sum(err ** 2)
        return site_err + reg_strength * torch.sum((q - q0) ** 2), site_err

    q, mom = q0.clone(), torch.zeros_like(q0)
    for _ in range(max_steps):
        q.requires_grad_(True)
        with torch.enable_grad():
            g = torch.autograd.grad(objective(q)[0], q)[0]
        mom = beta * mom + g
        q = (q - lr * mom).detach()
    with torch.no_grad():
        final, site_err = objective(q)
        qpos = data.qpos.index_put((q_ix,), q)
    return IKResult(qpos=qpos, err_norm=torch.sqrt(final),
                    site_error=torch.sqrt(site_err), steps=max_steps)
