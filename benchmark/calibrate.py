"""The readings that a cell's limits are set from, at the cell's own size.

    python3 -m benchmark.calibrate --workload fly_walk_imitation.sim4096 \\
        --seeds 1 2 3 --control-seeds 4 5 6 [--out FILE]

For each of ``--seeds``, the program runs the cell's path (a sim cell:
reset from the seed, the window's first steps, the step drawn for the
check; a training cell: set-up, its warm iteration) and the plain float64
reference judges it, as a run does: these are the lower readings. For
each of ``--control-seeds`` the control takes the program's place: the
same reference computed in the nearest precision below the
configuration's (float32 with TF32 on, where the configuration states
float32 with TF32 off) and judged alike: the upper readings (a training
cell reads the control beside the program, on the same recorded inputs).
One process builds each side once. Needs a CUDA device; prints one JSON
line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from benchmark import drivers, faults, harness


def readings(cell, seeds, env, ref_env, tf32, device="cuda", envs=None):
    out = []
    for seed in seeds:
        t0 = time.time()
        n = drivers.run_cell(cell, seed, 0.0, False, device, time.time(),
                             numbers_only=True, env=env, ref_env=ref_env,
                             tf32=tf32, envs=envs)
        n["seed"], n["s"] = seed, time.time() - t0
        print(json.dumps(n), file=sys.stderr, flush=True)
        out.append(n)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--envs", type=int, default=None)
    p.add_argument("--fault", default=None,
                   help="plant a fault of benchmark/faults.py under the "
                        "program (its numbers, for the upper readings)")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 3
    cell = harness.resolve(a.workload)
    res = {"workload": a.workload, "device": torch.cuda.get_device_name(0)}
    if cell.traffic["driver"] == "train":
        res["program"], res["control"] = train_readings(
            cell, a.seeds, set(a.control_seeds), fault=a.fault)
        return _write(res, a.out)
    ref_env = drivers.reference_env(cell, "cuda")
    prog = drivers.program_env(cell.config, "cuda")
    if a.fault:
        faults.hook("sim", a.fault)(prog)
    res["program"] = readings(cell, a.seeds, prog, ref_env, None,
                              envs=a.envs)
    del prog
    if a.control_seeds:
        low = drivers.reference_env(cell, "cuda", dtype=torch.float32)
        res["control"] = readings(cell, a.control_seeds, low, ref_env, True,
                                  envs=a.envs)
    return _write(res, a.out)


def train_readings(cell, seeds, control_seeds, device="cuda", fault=None):
    """The training cell's readings: set-up and the reference's follow of
    it per seed, no window; the control beside the program on
    ``control_seeds``."""
    from benchmark import training
    prog, ctl = [], []
    for seed in seeds:
        t0 = time.time()
        hook = faults.hook("train", fault) if fault else None
        n, c = training.run_train(cell, seed, 0.0, False, device,
                                  time.time(), numbers_only=True,
                                  control=seed in control_seeds, hook=hook)
        n["seed"], n["s"] = seed, time.time() - t0
        print(json.dumps(n), file=sys.stderr, flush=True)
        prog.append(n)
        if c is not None:
            c["seed"] = seed
            print(json.dumps({"control": c}), file=sys.stderr, flush=True)
            ctl.append(c)
    return prog, ctl


def _write(res, out) -> int:
    line = json.dumps(res)
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
