"""Three faults of the tracking task, planted under a run's timed path,
for the benchmark's own tests and for reading their numbers at a cell's
size on the card:

* ``late``: the reference previews read one frame late (each of
  ``ref_steps`` one frame further on);
* ``swap``: every reference feature read from the clip of the env's
  neighbour (envs 0 and 1 trade clips, 2 and 3, ...);
* ``no_term``: the termination test dropped: no env ends for its
  tracking error (or a blow-up), only at its clip's end.

    python3 -m benchmark.tracking_faults --workload humanoid_walk.sim4096 \\
        --fault late --seeds 7 8 9 [--out FILE]

Each reading is taken as ``benchmark.calibrate`` takes the program's, with
the fault planted (``hook(env)`` on the program's env). Needs a CUDA
device; prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from benchmark import calibrate, drivers, harness

KINDS = ("late", "swap", "no_term")


def hook(kind: str):
    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: one of {KINDS}")

    def planted(env):
        task = env.task
        if kind == "late":
            task._offsets = task._offsets + 1
            return
        if kind == "swap":
            ref = task._ref

            def swapped(key, ts, offsets):
                clip = ts["clip"]
                n = clip.shape[0]
                pair = torch.arange(n, device=clip.device) ^ 1
                pair = torch.clamp(pair, max=n - 1)
                return ref(key, dict(ts, clip=clip[pair]), offsets)
            task._ref = swapped
            return
        rtd = task.reward_term_discount

        def untested(model, data, ts, sensor_mean):
            reward, _, discount = rtd(model, data, ts, sensor_mean)
            end_clip = (ts["start"] + ts["step"] + max(task.ref_steps)
                        >= task.clips.lengths[ts["clip"]])
            return reward, end_clip, torch.ones_like(discount)
        task.reward_term_discount = untested
    return planted


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=KINDS)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--envs", type=int, default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("tracking_faults: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.resolve(a.workload)
    ref_env = drivers.reference_env(cell, "cuda")
    prog = drivers.program_env(cell.config, "cuda")
    hook(a.fault)(prog)
    res = {"workload": a.workload, "fault": a.fault,
           "device": torch.cuda.get_device_name(0),
           "program": calibrate.readings(cell, a.seeds, prog, ref_env, None,
                                         envs=a.envs)}
    return calibrate._write(res, a.out)


if __name__ == "__main__":
    sys.exit(main())
