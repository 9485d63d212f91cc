"""solve_rows_used_pct.sim: the share of B1's contact rows that carry a
force after a substep, over the substeps of one traced control step, in
%: 100 x the program's counter ``solver.rows_used`` (non-zero entries of
``sol_f``, R x B a substep) / ``solver.rows`` (R x B a substep). Source:
the program's counters (``flybody_tpu_torch.utils.telemetry``), which
count only while a profiler records. Nothing where the program has no
such counters."""


def read(ctx):
    if ctx.get("driver") != "sim" or ctx.get("trace") is None:
        return None
    try:
        from flybody_tpu_torch.utils import telemetry
    except ImportError:
        return None
    c = telemetry.counters()
    if not c.get("solver.rows"):
        return None
    return 100.0 * c.get("solver.rows_used", 0.0) / c["solver.rows"]
