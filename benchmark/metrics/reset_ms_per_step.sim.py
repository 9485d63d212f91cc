"""reset_ms_per_step.sim: host milliseconds inside ``env.reset`` per
control step over the window (``apply_autoreset`` resets the batch once a
step), from the benchmark's span wrapped on the instance."""


def read(ctx):
    if ctx.get("driver") != "sim" or not ctx["span_count"].get("reset"):
        return None
    return 1e3 * ctx["span_total"]["reset"] / ctx["steps"]
