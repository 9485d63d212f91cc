"""device_idle_pct.train: the share of the last rollout step and the
updates of one iteration in which no operation ran on the device, in %:
1 - (union of the device intervals of that traced stretch / its untraced
wall time). The untraced wall is the window's rollout time per control
step plus the updates of one iteration, from the benchmark's fenced
spans: the traced stretch itself is longer by the profiler's host cost.
Source: the device trace."""


def read(ctx):
    t = ctx.get("trace")
    n_roll = ctx["span_count"].get("rollout")
    n_upd = ctx["span_count"].get("update")
    if ctx.get("driver") != "train" or t is None or not (n_roll and n_upd):
        return None
    unroll = ctx["config"]["train"]["unroll_length"]
    wall = (ctx["span_total"]["rollout"] / (n_roll * unroll)
            + ctx["updates_per_iter"] * ctx["span_total"]["update"] / n_upd)
    return 100.0 * (1.0 - t.busy_s() / wall)
