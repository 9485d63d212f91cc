"""Task utilities on tensors: the fly's CoM <-> root frame maps and the
canonical action maps (reference vnl_ray/tasks/task_utils.py subset).

Each function takes any batch shape with the vector or quaternion on the
last axis and computes in the dtype of its first argument."""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import quaternions as mq

# Fixed fly CoM offset from the root (thorax) frame, cm
# (reference task_utils.py:174-213).
_COM_OFFSET = np.array([-0.03697634, 0.00029744, -0.01415133])


def _offset(pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    off = torch.as_tensor(_COM_OFFSET, dtype=pos.dtype, device=pos.device)
    return mq.rotate_vec_with_quat(off, quat)


def com2root(com_pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """CoM world position(s) -> root joint position(s)."""
    return com_pos - _offset(com_pos, quat)


def root2com(root_pos: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """Root joint position(s) -> CoM world position(s)."""
    return root_pos + _offset(root_pos, quat)


def real_to_canonical(action, lo, hi):
    """Real env action -> canonical [-1, 1] (reference real2canonical)."""
    return 2.0 * (action - lo) / (hi - lo) - 1.0


def canonical_to_real(action, lo, hi):
    """Canonical [-1, 1] -> real env action (reference canonical2real)."""
    return lo + (torch.clamp(action, -1.0, 1.0) + 1.0) * 0.5 * (hi - lo)
