"""Public environment factories.

Each factory returns a batched ``FlyEnv`` on a CUDA device unless the
caller names another device:

    env = walk_on_ball()                    # cuda
    env = walk_imitation(device="cpu")      # the CPU, when asked for
    state = env.reset(4096)
    state = env.autoreset_step(state, actions)
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.tasks.flight_imitation import make_flight_imitation
from flybody_tpu_torch.tasks.template_task import make_template_task
from flybody_tpu_torch.tasks.vision_flight import make_vision_flight
from flybody_tpu_torch.tasks.walk_imitation import make_walk_imitation
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


def template_task(device=None, time_limit: float = 1.0,
                  dtype=torch.float32):
    """No-op walking task of the free fly on a floor, for testing."""
    return make_template_task(default_device(device), dtype=dtype,
                              time_limit=time_limit)


def walk_imitation(device=None, ref_path: str | None = None,
                   time_limit: float = 10.0, dtype=torch.float32):
    """The free fly on a flat floor tracking reference walking snippets
    (the synthetic dataset unless ``ref_path`` names an HDF5 file)."""
    return make_walk_imitation(default_device(device), dtype=dtype,
                               ref_path=ref_path, time_limit=time_limit)


def flight_imitation(device=None, ref_path: str | None = None,
                     wpg_pattern_path: str | None = None,
                     time_limit: float = 0.6, dtype=torch.float32):
    """The winged fly in air tracking reference flight snippets, its wings
    driven by the wing-beat pattern generator (the synthetic dataset and
    base pattern unless ``ref_path`` names an HDF5 file and
    ``wpg_pattern_path`` an .npy pattern)."""
    return make_flight_imitation(default_device(device), dtype=dtype,
                                 ref_path=ref_path,
                                 wpg_pattern_path=wpg_pattern_path,
                                 time_limit=time_limit)


def vision_guided_flight(device=None, bumps_or_trench: str = "trench",
                         time_limit: float = 0.4, dtype=torch.float32):
    """The winged fly flying over a "trench" or "bumps" heightfield at a
    target height and speed, seeing it through two 32x32 eyes rendered on
    the device, its wings driven by the wing-beat pattern generator."""
    return make_vision_flight(default_device(device),
                              bumps_or_trench=bumps_or_trench,
                              time_limit=time_limit, dtype=dtype)
