"""launches_per_step.sim: device kernels, copies and memsets of one traced
control step, a count. Source: the device trace."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None or not t.launches():
        return None
    return float(t.launches())
