"""Two faults of the eye render, planted under a run's timed path, for the
benchmark's own tests and for reading their numbers at a cell's size on
the card:

* ``head``: each eye casts against all the scene's primitives, the head's
  geoms that contain it included, so it sees the inside of the head;
* ``march24``: the terrain march takes 24 samples a ray, not 48.

    python3 -m benchmark.vision_faults --workload vision_flight.sim4096 \\
        --fault head --seeds 7 8 9 [--out FILE]

Each reading is taken as ``benchmark.calibrate`` takes the program's, with
the fault planted (``hook(env)``, the ``sim`` driver's form). Needs a CUDA
device; prints one JSON line and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import sys

import torch

from benchmark import calibrate, drivers, harness

KINDS = ("head", "march24")


def hook(kind: str):
    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: one of {KINDS}")

    def planted(env):
        task = env.task
        if kind == "march24":
            task.march_samples = 24
            return
        from flybody_tpu_torch.ops import raycast
        cast = raycast.make_scene_raycaster(env.model, task.scene_geoms)[0]
        task.eye_geoms = [task.scene_geoms for _ in task.eyes]
        task.eye_casts = [cast for _ in task.eyes]
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
        print("vision_faults: needs a CUDA device", file=sys.stderr)
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
