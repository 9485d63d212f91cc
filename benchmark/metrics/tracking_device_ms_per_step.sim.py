"""tracking_device_ms_per_step.sim: device milliseconds of one traced
control step inside the program's ``tracking.*`` spans: the sum of the
program's ``tracking.<span>.device_ms`` counters, each the interval
between two CUDA events at the ends of a span (``tracking.reset``,
``tracking.observe``, ``tracking.reward``). Source: the program's counters
(``flybody_tpu_torch.utils.telemetry``), which count only while a
profiler records. Nothing where the program has no such counters."""


def read(ctx):
    if ctx.get("driver") != "sim" or ctx.get("trace") is None:
        return None
    try:
        from flybody_tpu_torch.utils import telemetry
    except ImportError:
        return None
    ms = [v for k, v in telemetry.counters().items()
          if k.startswith("tracking.") and k.endswith(".device_ms")]
    return float(sum(ms)) if ms else None
