"""tracking_host_ms_per_step.sim: host milliseconds of one traced control
step spent inside the program's ``tracking.*`` spans (the tracking task's
reset draws and pose set, its reference previews, its reward and
termination test), the union of their ranges, so a span inside another
counts once. Source: the program's spans in the host timeline of the
device trace. Nothing where the program has no such span."""


def read(ctx):
    t = ctx.get("trace")
    if ctx.get("driver") != "sim" or t is None:
        return None
    ranges = sorted((a, b) for a, b, n in t.ops
                    if n.startswith("tracking."))
    if not ranges:
        return None
    total, end = 0, None
    for a, b in ranges:
        if end is None or a >= end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e6
