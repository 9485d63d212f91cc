"""Plain reference of the vision_flight configuration: the winged fly
driven by the wing-beat pattern generator over the sine trench, its two
32x32 eyes rendered every control step, built from the benchmark's
frozen plain copy (``benchmark/reference``) in any dtype."""

import torch


def make_env(device, dtype=torch.float64, time_limit: float = 0.4,
             bumps_or_trench: str = "trench"):
    from benchmark.reference.tasks.vision_flight import make_vision_flight
    if bumps_or_trench != "trench":
        raise ValueError("the reference has the trench terrain only")
    return make_vision_flight(device, dtype=dtype, time_limit=time_limit)
