"""ccd_launches_per_step.sim: the launch calls of one traced control step
whose start lies in one of the program's ``physics.ccd`` spans (each call
of the convex narrowphase, inside ``physics.collision``), the reset's
included, a count; launch calls as in
``kinematics_launches_per_step.sim``. Source: the program's spans in the
host timeline of the device trace. Nothing where the program has no such
span."""

import os

from benchmark import harness

_launches = harness.load_module(
    os.path.join(os.path.dirname(os.path.abspath(__file__)),
                 "kinematics_launches_per_step.sim.py"),
    "kinematics_launches_per_step.sim")


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None:
        return None
    n, spans = _launches.launches_in(t, "physics.ccd")
    return float(n) if spans else None
