"""learner_update_ms.train: milliseconds of one ``learner.update`` (the
losses, the backward pass and the three Adam steps), the mean over every
update of the window, from the benchmark's span wrapped on the instance
and fenced by synchronises."""


def read(ctx):
    n = ctx["span_count"].get("update") if ctx.get("driver") == "train" \
        else None
    if not n:
        return None
    return 1e3 * ctx["span_total"]["update"] / n
