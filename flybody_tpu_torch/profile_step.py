"""Where the time of one control step goes, on the card.

    python3 -m flybody_tpu_torch.profile_step [B] [TASK]

TASK is a ``train_dmpo --task`` (walk_on_ball by default,
walk_imitation, flight_imitation, vision_guided_flight, rodent_two_touch,
rodent_escape_bowl, rodent_run_gaps, rodent_maze_forage,
rodent_walk_imitation, walk_humanoid). Prints (1) the host-clock time of
one batched ``env.reset`` (the auto-reset of a task that draws its
initial states runs one every control step), (2) on a task with eyes,
the eye render as a stage of its own (both eyes, run twice per control
step: the step's obs and the auto-reset's fresh batch): its host-clock
ms, its device time and launches, its peak device memory and its share
of the control step, (3) from one control step as it runs (its substeps
one CUDA graph's replay, ``envs/substeps.py``) under torch.profiler, with
no fence added inside it: device time by kernel, the device-busy total
against the wall time, the number of kernel launches, the env's spans
and the program's counters (``utils/telemetry.py``), and (4) the
substeps alone, eager and replayed (host-clock ms of each), and from the
eager loop function under torch.profiler one table per fresh and per
update substep of the program's stage spans (host ms, device ms of the
kernels launched inside the span, launches): a replay has no stage
spans. Needs a CUDA device.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import sys
import time

import torch

from flybody_tpu_torch.envs import substeps
from flybody_tpu_torch.train_dmpo import make_env
from flybody_tpu_torch.utils import telemetry as tm


def device_rows(prof) -> list:
    """The device-side entries of a torch.profiler run (kernels, copies,
    memsets); the trace also puts each host op's range on the device
    timeline under the op's name, which would count the same device time
    twice."""
    events = prof.key_averages()
    host = {a.key for a in events
            if a.device_type == torch.autograd.DeviceType.CPU}
    return [a for a in events
            if a.device_type == torch.autograd.DeviceType.CUDA
            and a.key not in host]


# the hand kernels by their names in a device trace (each in an anonymous
# namespace, a template's arguments after it), and the wrapper of each;
# upsolve_yd_kernel<true> builds J on the fly
_HAND = re.compile(r"::(solve_rows|apgd|upsolve_yd|admm|ccd|kin)_kernel"
                   r"(<true>)?[<(]")
HAND_WRAPPERS = {"solve_rows": "solve_rows", "apgd": "apgd_iterate",
                 "upsolve_yd": "upsolve_yd", "upsolve_yd<true>":
                 "upsolve_build_yd", "admm": "admm_iterate",
                 "ccd": "ccd_narrowphase", "kin": "kinematics"}


# the idle margin at both ends of a launch trace, and the marker kernels
# launched inside each end (``torch.cuda._sleep``'s)
TRACE_MARGIN_S = 0.5
MARKERS = 8


@contextlib.contextmanager
def launch_trace():
    """A torch.profiler run of CUDA activity for ``hand_launches``, opened
    and closed on an idle device with TRACE_MARGIN_S of nothing and
    MARKERS marker kernels at both ends. On a card a run without them
    lost device events at its ends: the one kernel of a run opened 10 ms
    before it, the first kernels of a step. The markers and the margins
    stand between those ends and the kernels counted."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_MARGIN_S)
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        yield prof
        for _ in range(MARKERS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(TRACE_MARGIN_S)


def hand_kernels(prof) -> dict:
    """{device name: launches} of the hand kernels in a stopped
    torch.profiler run that traced CUDA activity: the kernels a replayed
    CUDA graph ran count one by one, as they ran."""
    cpu = torch.autograd.DeviceType.CPU
    out: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cpu and _HAND.search(e.name()):
            out[e.name()] = out.get(e.name(), 0) + 1
    return out


def hand_launches(prof) -> dict:
    """{wrapper: launches on the device} of every hand kernel (those of
    ``HAND_WRAPPERS``) in a stopped torch.profiler run, 0 where none
    ran."""
    out = dict.fromkeys(HAND_WRAPPERS.values(), 0)
    for name, n in hand_kernels(prof).items():
        m = _HAND.search(name)
        out[HAND_WRAPPERS[m.group(1) + (m.group(2) or "")]] += n
    return out


LAUNCH_CALLS = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx"))


def timeline(prof) -> tuple:
    """(spans, ops) of a stopped torch.profiler run: the program's spans
    ``[(start ns, end ns, name)]`` (``physics.*``, ``env.*``), and its
    device operations ``[(host start ns, device ns)]``, each placed at
    the start of the host op that launched it (the link by which
    ``key_averages`` gives an op its device time). Device ranges named
    after a host event are left out, as ``device_rows`` leaves them."""
    cpu = torch.autograd.DeviceType.CPU
    events = prof.profiler.kineto_results.events()
    host = [e for e in events if e.device_type() == cpu]
    names = {e.name() for e in host}
    front = {e.correlation_id(): e.start_ns() for e in host
             if e.linked_correlation_id() == 0}
    # a kernel launched outside any aten op (a hand kernel through ctypes)
    # links to no op: it is placed at its runtime launch call instead
    launch = {e.correlation_id(): e.start_ns() for e in host
              if e.name() in LAUNCH_CALLS}
    spans = sorted((e.start_ns(), e.end_ns(), e.name()) for e in host
                   if e.name().startswith(("physics.", "env.")))
    ops = []
    for e in events:
        if e.device_type() == cpu or e.name() in names:
            continue
        t = front.get(e.linked_correlation_id(),
                      launch.get(e.correlation_id()))
        if t is not None:
            ops.append((t, e.duration_ns()))
    return spans, sorted(ops)


def _row(ops, starts, a: int, b: int) -> list:
    """[host ms, device ms, launches] of the span [a, b)."""
    i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
    return [(b - a) / 1e6, sum(d for _, d in ops[i:j]) / 1e6, j - i]


def substep_tables(spans, ops, col_refresh: int) -> dict:
    """{"fresh" | "update": {stage span: [host ms, device ms, launches]}},
    each the mean over the substeps of that kind in ``env.step`` (the
    reset's stages left out), from ``timeline``. A substep opens with its
    ``physics.kinematics`` span; substep k runs the full collision
    selection where k % col_refresh == 0."""
    starts = [a for a, _ in ops]
    step = [(a, b) for a, b, n in spans if n == "env.step"]
    reset = [(a, b) for a, b, n in spans if n == "env.reset"]
    inside = lambda a, b, ivs: any(x <= a and b <= y for x, y in ivs)
    r = max(int(col_refresh or 1), 1)
    acc, seen, k = {}, {"fresh": 0, "update": 0}, -1
    for a, b, n in spans:
        if not (n.startswith("physics.") and inside(a, b, step)
                and not inside(a, b, reset)):
            continue
        if n == "physics.kinematics":
            k += 1
            seen["fresh" if k % r == 0 else "update"] += 1
        kind = "fresh" if k % r == 0 else "update"
        row = acc.setdefault(kind, {}).setdefault(n, [0.0, 0.0, 0])
        for i, v in enumerate(_row(ops, starts, a, b)):
            row[i] += v
    return {kind: {n: [v / seen[kind] for v in row]
                   for n, row in t.items()}
            for kind, t in acc.items()}


def span_rows(spans, ops, prefix: str) -> dict:
    """{span: [host ms, device ms, launches]} summed over the spans whose
    name starts with ``prefix``, from ``timeline``."""
    starts = [a for a, _ in ops]
    out = {}
    for a, b, n in spans:
        if n.startswith(prefix):
            row = out.setdefault(n, [0.0, 0.0, 0])
            for i, v in enumerate(_row(ops, starts, a, b)):
                row[i] += v
    return out


def _print_rows(title: str, rows: dict) -> None:
    print(f"\n{title}")
    print(f"  {'span':24s} {'host ms':>9s} {'device ms':>10s} "
          f"{'launches':>9s}")
    for k, v in sorted(rows.items(), key=lambda kv: -kv[1][0]):
        print(f"  {k:24s} {v[0]:9.3f} {v[1]:10.3f} {v[2]:9.1f}")


def eye_render(env, data) -> dict:
    """The eye render of ``data`` (both eyes) as a stage: host-clock ms
    (median of 3, fenced by syncs), device ms and launches of one render
    (torch.profiler) and its peak device memory over what is held."""
    from torch.profiler import ProfilerActivity, profile
    task, m = env.task, env.model
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        task.render_eyes(m, data)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task.render_eyes(m, data)
        torch.cuda.synchronize()
    rows = device_rows(prof)
    return {"ms": 1e3 * sorted(times)[1],
            "device_ms": sum(a.self_device_time_total for a in rows) / 1e3,
            "launches": sum(a.count for a in rows),
            "peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}


def main(B: int = 4096, task: str = "walk_on_ball") -> None:
    env = make_env(task, "cuda")
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32,
                          device="cuda")[None].expand(B, -1)
    gen = torch.Generator("cuda").manual_seed(0)
    state = env.reset(B, gen)
    for _ in range(2):
        state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    m = env.model
    print(f"device: {torch.cuda.get_device_name(0)}  {task} B={B}, "
          f"{env.n_substeps} substeps per control step, col_refresh "
          f"{m.col_refresh}")
    resets = []
    for _ in range(3):
        t0 = time.perf_counter()
        env.reset(B, gen)
        torch.cuda.synchronize()
        resets.append(time.perf_counter() - t0)
    print(f"batched reset: {1e3 * sorted(resets)[1]:.2f} ms (median of 3; "
          f"runs every control step: "
          f"{not env.task.deterministic_init})")
    render = None
    if hasattr(env.task, "render_eyes"):
        render = eye_render(env, state.data)
        print(f"eye render (both eyes): {render['ms']:.2f} ms host clock "
              f"(median of 3), device {render['device_ms']:.2f} ms in "
              f"{render['launches']} kernels/copies, peak device memory "
              f"{render['peak_gb']:.2f} GB over what is held; 2 per "
              f"control step")
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = env.autoreset_step(state, mid)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
    counts = tm.counters()
    tm.clear()
    rows = device_rows(prof)
    busy = sum(a.self_device_time_total for a in rows) / 1e3     # ms
    launches = sum(a.count for a in rows)
    print(f"\ncontrol step: wall {1e3 * wall:.1f} ms unprofiled, "
          f"{1e3 * wall_prof:.1f} ms profiled; device busy {busy:.1f} ms "
          f"({100 * busy / (1e3 * wall):.1f} % of the unprofiled wall), "
          f"{launches} device kernels/copies")
    if render is not None:
        print(f"eye render share of the control step: host "
              f"{100 * 2e-3 * render['ms'] / wall:.1f} % of the wall, device "
              f"{100 * 2 * render['device_ms'] / busy:.1f} % of the busy "
              f"time")
    print("top device time by kernel:")
    for a in sorted(rows, key=lambda a: -a.self_device_time_total)[:15]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms {a.count:6d}x  "
              f"{a.key[:90]}")
    spans, ops = timeline(prof)
    _print_rows("the env's spans over the step (env.reset lies inside "
                "env.autoreset)", span_rows(spans, ops, "env."))
    print("\ncounters: " + ", ".join(f"{k} {v:.0f}"
                                     for k, v in sorted(counts.items())))
    if counts.get("solver.rows"):
        print(f"B1 rows carrying a force: "
              f"{100 * counts['solver.rows_used'] / counts['solver.rows']:.2f}"
              f" %")
    substep_split(env, state.data)


def substep_split(env, data) -> None:
    """The substeps of a control step from ``data``: host-clock ms of the
    eager loop function and of the graph's replay (median of 3, fenced),
    then the eager loop under torch.profiler, split by stage span."""
    from torch.profiler import ProfilerActivity, profile
    m, n = env.model, env.n_substeps
    ways = {"eager": lambda: substeps.run(m, data, n)}
    if substeps.engages(m, data):
        ways["graph"] = lambda: env._graphs(m, data, n)
    for way, fn in ways.items():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        print(f"\nsubsteps {way}: {1e3 * sorted(times)[1]:.1f} ms "
              f"(median of 3)")
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with tm.span("env.step"):
            substeps.run(m, data, n)
        torch.cuda.synchronize()
    counts = tm.counters()
    tm.clear()
    spans, ops = timeline(prof)
    for kind, table in substep_tables(spans, ops, m.col_refresh).items():
        _print_rows(f"{kind} substep of the eager loop (the mean of the "
                    f"step's): host {sum(v[0] for v in table.values()):.2f}"
                    f" ms", table)
    print("\neager loop counters: " + ", ".join(
        f"{k} {v:.0f}" for k, v in sorted(counts.items())))


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
         sys.argv[2] if len(sys.argv) > 2 else "walk_on_ball")
