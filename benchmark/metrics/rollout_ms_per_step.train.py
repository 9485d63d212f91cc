"""rollout_ms_per_step.train: milliseconds of the trainer's ``rollout_fn``
per control step over the window, from the benchmark's span wrapped on
the instance and fenced by synchronises."""


def read(ctx):
    n = ctx["span_count"].get("rollout") if ctx.get("driver") == "train" \
        else None
    if not n:
        return None
    unroll = ctx["config"]["train"]["unroll_length"]
    return 1e3 * ctx["span_total"]["rollout"] / (n * unroll)
