"""Plain reference of the rat_two_touch configuration: the dm_control rat
on a floor tapping an orb twice (TwoTouch), built from the benchmark's
frozen plain copy (``benchmark/reference``) in any dtype."""

import torch

# the rat's engine budgets, as the program's rodent factories set them
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 24}, contact_solver="fused",
                    fused_sel=(16, 24), ccd_budget=64, col_refresh=10)


def make_env(device, dtype=torch.float64, time_limit: float = 30.0):
    from benchmark.reference.envs.core import FlyEnv
    from benchmark.reference.envs.rodent_walker import RodentWalker
    from benchmark.reference.models import rodent as rm
    from benchmark.reference.tasks import rodent_tasks as rt
    model, _ = rm.make_rodent_model("floor", torch.device(device),
                                        dtype=dtype, seed=0, **PUT_MODEL_KW)
    task = rt.TwoTouch(RodentWalker(model), target_area=(1.5, 1.5),
                       target_type_reward=25.0, time_limit=time_limit)
    return FlyEnv(model, task, dtype=dtype)
