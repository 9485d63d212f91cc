"""Plain reference of the fly_walk_imitation configuration: the free fly
on a flat floor tracking the synthetic walking snippets, built from the
benchmark's frozen plain copy (``benchmark/reference``) in any dtype."""

import torch


def make_env(device, dtype=torch.float64, time_limit: float = 10.0):
    from benchmark.reference.tasks.walk_imitation import make_walk_imitation
    return make_walk_imitation(device, dtype=dtype, time_limit=time_limit)
