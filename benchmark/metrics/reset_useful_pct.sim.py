"""reset_useful_pct.sim: the share of the envs that the auto-reset of one
traced control step built a fresh state for which were done, in %: 100 x
min(``env.done``, ``env.reset_built``) / ``env.reset_built``, the
program's counters of the envs done and of the batch passed to ``reset``
(B, or 1 for a task with a deterministic start); 100 where the reset
built nothing. Source: the program's counters
(``flybody_tpu_torch.utils.telemetry``), which count only while a
profiler records. Nothing where the program has no such counters."""


def read(ctx):
    if ctx.get("driver") != "sim" or ctx.get("trace") is None:
        return None
    try:
        from flybody_tpu_torch.utils import telemetry
    except ImportError:
        return None
    c = telemetry.counters()
    if "env.reset_built" not in c:
        return None
    built = c["env.reset_built"]
    if not built:
        return 100.0
    return 100.0 * min(c.get("env.done", 0.0), built) / built
