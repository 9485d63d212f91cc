"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload fly_walk_imitation.sim4096 \\
        --seed 7 --seconds 30 --trace 0

From the root of a checkout on a machine with the cards the cell asks
for. The cell's configuration, traffic mix and per-layer metric readers
are found by name (``benchmark/harness.py``); the traffic's ``driver``
names the loop that runs it (``DRIVERS``). Prints, as the last line of
standard output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each compared number beside its
limit, which also close standard error. Exits non-zero, printing no
result, without the cards the cell needs, or when a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """Wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "flybody_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's, compared as whole names (``flybody_tpu_torch`` is
    not ``flybody_tpu``)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    # every build and kernel cache of the program inside the checkout, at
    # a fixed path, so only a checkout's first run builds (the port's own
    # nvcc builds land in flybody_tpu_torch/_build/, inside it too)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, ".cache",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".cache", "triton")

    import torch
    from benchmark import harness
    cell = harness.resolve(a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {a.workload} needs {cell.chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    from benchmark import drivers
    res = drivers.run_cell(cell, a.seed, a.seconds, bool(a.trace),
                           device="cuda", t_start=T_START)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: JAX or the JAX package is loaded: {bad}",
              file=sys.stderr)
        return 4
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
