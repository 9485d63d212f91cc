"""tracking_launches_per_step.sim: the launch calls of one traced control
step whose start lies in one of the program's ``tracking.*`` spans (the
tracking task's clip draws and pose set at reset, its reference previews,
its reward and termination test), a count; launch calls as in
``kinematics_launches_per_step.sim``. Source: the program's spans in the
host timeline of the device trace. Nothing where the program has no such
span."""

import os

from benchmark import harness

_launches = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "kinematics_launches_per_step.sim.py"),
    "kinematics_launches_per_step.sim")

SPANS = ("tracking.reset", "tracking.observe", "tracking.reward")


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None:
        return None
    n = found = 0
    for name in SPANS:
        k, spans = _launches.launches_in(t, name)
        n, found = n + k, found + spans
    return float(n) if found else None
