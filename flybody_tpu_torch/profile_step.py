"""Where the time of one control step goes, on the card.

    python3 -m flybody_tpu_torch.profile_step [B] [TASK]

TASK is a ``train_dmpo --task`` (walk_on_ball by default,
walk_imitation, flight_imitation, vision_guided_flight, rodent_two_touch,
rodent_escape_bowl, rodent_run_gaps, rodent_maze_forage,
rodent_walk_imitation, walk_humanoid). Prints (1) the
host-clock time of each physics stage of one fresh and one update substep,
each stage fenced by torch.cuda.synchronize, and of one batched
``env.reset`` (the auto-reset of a task that draws its initial states runs
one every control step), (2) on a task with eyes, the eye render as a
stage of its own (both eyes, run twice per control step: the step's obs
and the auto-reset's fresh batch): its host-clock ms, its device time and
launches, its peak device memory and its share of the control step, and
(3) a torch.profiler trace of one control step: device time by kernel, the
device-busy total against the wall time, and the number of kernel
launches. Needs a CUDA device.
"""

from __future__ import annotations

import sys
import time

import torch

from flybody_tpu_torch.physics import actuation as A
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import sensors as S
from flybody_tpu_torch.physics import smooth as SM
from flybody_tpu_torch.train_dmpo import make_env


def _stages(col_update: bool):
    return (("kinematics", K.kinematics), ("com_pos", K.com_pos),
            ("tendon", K.tendon), ("crb", SM.crb),
            ("collision_update" if col_update else "collision",
             COL.collision_update if col_update else COL.collision),
            ("transmission", SM.transmission), ("com_vel", SM.com_vel),
            ("passive", P.passive), ("rne", SM.rne),
            ("act_dynamics", A.act_dynamics), ("actuation", A.actuation),
            ("acceleration", F.fwd_acceleration),
            ("solve", lambda m, d: C.solve(m, d, fresh=not col_update)),
            ("sensor", S.sensor), ("euler", F.euler))


def stage_times(m, d, col_update: bool, reps: int = 3) -> dict:
    """Median host-clock seconds per stage, each fenced by a sync."""
    out = {}
    for _ in range(reps):
        x = d
        for name, fn in _stages(col_update):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x = fn(m, x)
            torch.cuda.synchronize()
            out.setdefault(name, []).append(time.perf_counter() - t0)
    return {k: sorted(v)[len(v) // 2] for k, v in out.items()}


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
    for upd in (False, True):
        t = stage_times(m, state.data, upd)
        total = sum(t.values())
        print(f"\n{'update' if upd else 'fresh'} substep: "
              f"{1e3 * total:.2f} ms (sum of synced stages)")
        for k, v in sorted(t.items(), key=lambda kv: -kv[1]):
            print(f"  {k:18s} {1e3 * v:9.3f} ms  {100 * v / total:5.1f} %")

    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state = env.autoreset_step(state, mid)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t0
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


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
         sys.argv[2] if len(sys.argv) > 2 else "walk_on_ball")
