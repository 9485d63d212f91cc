"""solve_rows_roofline_pct.sim: B1 (``solve_rows``, the fused contact
solve) against its roofline in one traced control step, in %: the least
time of its counted operations and bytes at the published peaks
(``benchmark/work.py``), over its device time in the trace. Nothing when
no B1 kernel ran."""

from benchmark import work


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None:
        return None
    secs, n = t.kernel_s("solve_rows_kernel")
    if n == 0 or secs <= 0:
        return None
    flops, moved = work.b1_per_call(ctx["body"], ctx["B"])
    return 100.0 * n * work.bound_s(flops, moved) / secs
