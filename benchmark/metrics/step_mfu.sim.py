"""step_mfu.sim: the window's counted operations over its time and the
float32 peak, in %. The count is B1's exact operations times the substeps
of each control step (``benchmark/work.py``); the eager stages are not
counted, so this is a floor."""

from benchmark import work


def read(ctx):
    if ctx.get("driver") != "sim" or ctx["window_s"] <= 0:
        return None
    flops = ctx["steps"] * work.sim_step_flops(ctx["body"], ctx["B"])
    return 100.0 * flops / ctx["window_s"] / work.PEAK_F32
