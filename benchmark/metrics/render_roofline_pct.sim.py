"""render_roofline_pct.sim: the eye render against its roofline in one
traced control step, in %: the least time of its counted operations and
bytes at the published peaks (``benchmark/render_work.py``,
``benchmark/work.py``), over its device time. Source: the program's
counters (``flybody_tpu_torch.utils.telemetry``), which count only while a
profiler records: ``render.rays`` (B x H x W x eyes a render),
``render.primitives`` (the primitives cast, summed over the eyes, a
render) and ``render.eyes.device_ms`` (CUDA events at the ends of each
``render.eyes`` span). The pairs are B x H x W x ``render.primitives``,
with B the cell's envs and H, W the configuration's ``eyes``. Nothing
where the program has no such counters."""

from benchmark import render_work, work


def read(ctx):
    if ctx.get("driver") != "sim" or ctx.get("trace") is None:
        return None
    eyes = ctx["config"].get("eyes")
    if eyes is None:
        return None
    try:
        from flybody_tpu_torch.utils import telemetry
    except ImportError:
        return None
    c = telemetry.counters()
    ms = c.get("render.eyes.device_ms")
    if not ms or not c.get("render.rays"):
        return None
    rays = c["render.rays"]
    pairs = ctx["B"] * eyes["height"] * eyes["width"] * c.get(
        "render.primitives", 0.0)
    least = work.bound_s(render_work.render_flops(rays, pairs),
                         render_work.render_bytes(rays))
    return 100.0 * least / (1e-3 * ms)
