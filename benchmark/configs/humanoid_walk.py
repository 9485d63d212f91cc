"""Plain reference of the humanoid_walk configuration: the CMU humanoid on
a floor tracking two synthetic clips of 120 frames (multi-clip mocap
tracking, the comic reward), built from the benchmark's frozen plain copy
(``benchmark/reference``) in any dtype; the clips' features come from the
reference's own kinematics."""

import torch

# the humanoid's engine budgets, as the program's walk_humanoid sets them:
# the rat's, with a contact selection every 3 of the 6 substeps
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 24}, contact_solver="fused",
                    fused_sel=(16, 24), ccd_budget=64, col_refresh=3)


def make_env(device, dtype=torch.float64, time_limit: float = 10.0,
             termination_error_threshold: float = 0.3):
    from benchmark.reference.envs.core import FlyEnv
    from benchmark.reference.envs.humanoid_walker import HumanoidWalker
    from benchmark.reference.models import rodent as rm
    from benchmark.reference.tasks import tracking as trk
    model = rm.make_humanoid_model(torch.device(device), dtype=dtype,
                                   **PUT_MODEL_KW)
    walker = HumanoidWalker(model)
    clips = trk.synthetic_clips(model, walker, num_clips=2, length=120)
    task = trk.MultiClipTracking(
        walker, clips, ref_steps=(1, 2, 3, 4, 5),
        termination_error_threshold=termination_error_threshold,
        reward_key="comic", tuning="fly", min_steps=1,
        time_limit=time_limit, ctrl_dt=0.03, phys_dt=0.005)
    return FlyEnv(model, task, dtype=dtype)
