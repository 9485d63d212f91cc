"""graph_substeps_pct.sim: the share of the physics substeps of one traced
control step that a CUDA graph's replay ran, in %: 100 x the program's
counter ``physics.graph_substeps`` (the substeps of a replayed loop) /
``physics.substeps`` (the substeps of every control step). Source: the
program's counters (``flybody_tpu_torch.utils.telemetry``), which count
only while a profiler records. Nothing where the program has no such
counters."""


def read(ctx):
    if ctx.get("driver") != "sim" or ctx.get("trace") is None:
        return None
    try:
        from flybody_tpu_torch.utils import telemetry
    except ImportError:
        return None
    c = telemetry.counters()
    if not c.get("physics.substeps"):
        return None
    return 100.0 * c.get("physics.graph_substeps", 0.0) / c["physics.substeps"]
