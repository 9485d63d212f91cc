"""Public environment factories.

Each factory returns a batched ``FlyEnv`` on a CUDA device unless the
caller names another device:

    env = walk_on_ball()                    # cuda
    state = env.reset(4096)
    state = env.autoreset_step(state, actions)
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball


def default_device(device=None) -> torch.device:
    """``device`` as given, else "cuda"; raises if CUDA is asked for and
    absent (the port never slides onto the CPU by itself)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' explicitly to run on "
            "the CPU")
    return device


def walk_on_ball(device=None, dtype=torch.float32, time_limit: float = 2.0):
    """Tethered fly walking on a floating ball."""
    return make_walk_on_ball(default_device(device), dtype=dtype,
                             time_limit=time_limit)
