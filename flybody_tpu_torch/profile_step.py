"""Where the time of one walk_on_ball control step goes, on the card.

    python3 -m flybody_tpu_torch.profile_step [B]

Prints (1) the host-clock time of each physics stage of one fresh and one
update substep, each stage fenced by torch.cuda.synchronize, and (2) a
torch.profiler trace of one control step: device time by kernel, the
device-busy total against the wall time, and the number of kernel
launches. Needs a CUDA device.
"""

from __future__ import annotations

import sys
import time

import torch

from flybody_tpu_torch.fly_envs import walk_on_ball
from flybody_tpu_torch.physics import actuation as A
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import sensors as S
from flybody_tpu_torch.physics import smooth as SM


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


def main(B: int = 4096) -> None:
    env = walk_on_ball()
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32,
                          device="cuda")[None].expand(B, -1)
    state = env.reset(B)
    for _ in range(2):
        state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    m = env.model
    print(f"device: {torch.cuda.get_device_name(0)}  B={B}")
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
    # device-side entries only (kernels, copies, memsets); the trace also
    # puts each host op's range on the device timeline under the op's name,
    # which would count the same device time twice
    events = prof.key_averages()
    host = {a.key for a in events
            if a.device_type == torch.autograd.DeviceType.CPU}
    rows = [a for a in events
            if a.device_type == torch.autograd.DeviceType.CUDA
            and a.key not in host]
    busy = sum(a.self_device_time_total for a in rows) / 1e3     # ms
    launches = sum(a.count for a in rows)
    print(f"\ncontrol step: wall {1e3 * wall:.1f} ms unprofiled, "
          f"{1e3 * wall_prof:.1f} ms profiled; device busy {busy:.1f} ms "
          f"({100 * busy / (1e3 * wall):.1f} % of the unprofiled wall), "
          f"{launches} device kernels/copies")
    print("top device time by kernel:")
    for a in sorted(rows, key=lambda a: -a.self_device_time_total)[:15]:
        print(f"  {a.self_device_time_total / 1e3:9.3f} ms {a.count:6d}x  "
              f"{a.key[:90]}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4096)
