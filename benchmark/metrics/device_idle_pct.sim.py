"""device_idle_pct.sim: the share of a steady control step in which no
operation ran on the device, in %: 1 - (union of the device intervals of
one traced control step, with no fence added inside it / the mean wall
time of the window's untraced control steps). The traced step's own wall
time is longer by the profiler's host cost, so the untraced steps give
the wall. Source: the device trace."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None or not ctx["steps"]:
        return None
    return 100.0 * (1.0 - t.busy_s() / (ctx["window_s"] / ctx["steps"]))
