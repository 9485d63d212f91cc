"""learner_launches_per_update.train: the launch calls whose start lies
in one of the program's ``learner.update`` spans in the traced tail (the
last rollout step and the iteration's updates), over the number of those
spans; launch calls as in ``kinematics_launches_per_step.sim``. Source:
the program's spans in the host timeline of the device trace. Nothing
where the program has no such span."""

import os

from benchmark import harness

_launches = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "kinematics_launches_per_step.sim.py"),
    "kinematics_launches_per_step.sim")


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "train" or t is None:
        return None
    n, spans = _launches.launches_in(t, "learner.update")
    return n / spans if spans else None
