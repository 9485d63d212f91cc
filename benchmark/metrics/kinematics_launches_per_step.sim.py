"""kinematics_launches_per_step.sim: the launch calls of one traced
control step whose start lies in one of the program's
``physics.kinematics`` spans, the reset's included, a count. A launch
call is a host runtime event that launches a kernel, or starts a copy or
a memset, on the device (``LAUNCH_CALLS``). Source: the program's spans
in the host timeline of the device trace. Nothing where the program has
no such span."""

import bisect

LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemcpy", "cudaMemsetAsync"))


def launches_in(trace, span: str) -> tuple:
    """(launch calls of ``trace`` whose start lies in a host range named
    ``span``, the number of such ranges)."""
    ranges = sorted((a, b) for a, b, n in trace.ops if n == span)
    merged = []
    for a, b in ranges:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    starts = [a for a, _ in merged]
    n = 0
    for a, _, name in trace.ops:
        if name in LAUNCH_CALLS:
            i = bisect.bisect_right(starts, a) - 1
            n += i >= 0 and a < merged[i][1]
    return n, len(ranges)


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None:
        return None
    n, spans = launches_in(t, "physics.kinematics")
    return float(n) if spans else None
