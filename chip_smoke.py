#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi)
  2. build    every CUDA source of flybody_tpu_torch/csrc with nvcc
  3. main     walk_on_ball at B=4096, float32: reset, one warm-up control
              step, then 20 autoreset_step calls with mid-range actions;
              obs and reward must be finite and the solve_rows kernel
              must have launched exactly 10 times per control step
  4. check    one substep of 4 envs of the main path's final state on the
              card (float32) against the same substep on the CPU
              (plain versions, float32; float64 sets how far apart two
              float32 runs may be)
  5. kernels  each kernel against its plain PyTorch version on the card,
              at the main path's shapes: (a) inputs captured from the
              main path's final state, (b) random inputs; times of both
  6. the kernel table as JSON, the card line, and the result line
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 4096
STEPS = 20

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and device memory bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances of the kernel against its plain version, float32 on both.
# f, v, qfrc, dqacc: max |kernel - plain| / max |plain| <= 1e-3. Both run
# the same arithmetic in another summation order (~1e-6 relative for sums
# of <= 152 terms); a restart test sum(g (z_new - z)) near zero can flip
# in a few envs and change one Nesterov step there, which moves f by a
# fraction of one step, well under 1e-3 of the batch's force scale.
TOL_MAX_REL = 1e-3
# qacc = qacc_smooth + dqacc by the relative norm over the batch, as the
# JAX package's fused-solver test compares qacc (test_solver_fused.py:58);
# the same reasoning on the aggregate.
TOL_QACC = 1e-4
# One substep of the main path on the card (float32, kernel) against the
# same substep on the CPU (float32, plain versions) from the same state,
# relative norm over the 4 envs. The two runs round in another order
# through an ill-conditioned contact state (small fly masses, stiff
# contacts, 20 APGD iterations), so they can be as far apart as float32
# is from float64: on the card that distance read up to 1.6e-2 for qacc
# and 3.9e-3 for qvel, 4e-4 for qpos and sensordata, over five runs of
# the main path's final state on an H100. qacc and qvel are held at about
# 3x that; qpos and sensordata, which move little in one substep, at 1e-3.
TOL_SUBSTEP = {"qacc": 5e-2, "qvel": 1e-2, "qpos": 1e-3,
               "sensordata": 1e-3}
# A stiff contact state amplifies rounding: two float32 runs that differ
# only in summation order can be as far apart as float32 is from float64
# on the same inputs. So each bound above is raised to F64_FACTOR times
# the plain float32 result's distance from the plain float64 result,
# measured on this run's inputs. A wrong kernel or stage is off by O(1).
F64_FACTOR = 2.0


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def max_rel(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def rel_norm(a, b) -> float:
    """|a - b| / |b| over the whole tensor, in float64."""
    import torch
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def compare(label, got, want, want64, qacc_smooth):
    """Errors of the kernel's (f, v, qfrc, dqacc) and qacc against the
    plain float32 version; each bound is raised to F64_FACTOR times the
    plain float32 version's distance from the plain float64 version
    (``want64``). Fails over a bound; returns the largest abs error."""
    worst = 0.0
    for name, g, w, w64 in zip(("f", "v", "qfrc", "dqacc"), got, want,
                               want64):
        err = (g - w).abs().max().item()
        rel, rel32 = max_rel(g, w), max_rel(w, w64)
        tol = max(TOL_MAX_REL, F64_FACTOR * rel32)
        worst = max(worst, err)
        print(f"  {label} {name:6s} max_abs {err:.3e} max_rel {rel:.3e} "
              f"(plain f32 vs f64 {rel32:.3e}; tol {tol:.3g})", flush=True)
        if not rel <= tol:
            fail(f"{label} {name}: max_rel {rel:.3e} > {tol:.3g}")
    q64 = qacc_smooth.double() + want64[3]
    qp = qacc_smooth + want[3]
    rel, rel32 = rel_norm(qacc_smooth + got[3], qp), rel_norm(qp, q64)
    tol = max(TOL_QACC, F64_FACTOR * rel32)
    print(f"  {label} qacc   rel_norm {rel:.3e} (plain f32 vs f64 "
          f"{rel32:.3e}; tol {tol:.3g})", flush=True)
    if not rel <= tol:
        fail(f"{label} qacc rel_norm {rel:.3e} > {tol:.3g}")
    return worst


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from flybody_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script: {e}",
              file=sys.stderr)
        return 1
    import numpy as np
    from flybody_tpu_torch.fly_envs import walk_on_ball
    from flybody_tpu_torch.ops import solver_kernels as SK
    from flybody_tpu_torch.ops import tree_ldl as TL
    from flybody_tpu_torch.physics import bridge
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.physics import solver_fused as SF
    from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"build: {sorted(cuda_build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # ---- 3. main path ----------------------------------------------------
    env = walk_on_ball()
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32,
                          device=dev)[None].expand(B, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.reset(B)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    state = env.autoreset_step(state, mid)            # warm-up
    torch.cuda.synchronize()
    SK.solve_rows.launches = 0
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = SK.solve_rows.launches
    sps = B * STEPS / dt
    print(f"main: walk_on_ball B={B} reset {reset_s:.3f} s, {STEPS} "
          f"control steps in {dt:.3f} s = {sps:.1f} env-steps/s "
          f"({1e3 * dt / STEPS:.1f} ms per control step)", flush=True)
    print(f"main: solve_rows launches {launches} (expected "
          f"{STEPS * env.n_substeps})", flush=True)
    if launches != STEPS * env.n_substeps:
        fail("solve_rows was not launched once per substep")
    for k, v in state.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"obs {k} not finite")
    if not bool(torch.isfinite(state.reward).all()):
        fail("reward not finite")
    n_obs = sum(v.shape[1] for v in state.obs.values())
    print(f"main: obs {len(state.obs)} keys, {n_obs} floats per env, all "
          f"finite; reward mean {state.reward.mean().item():.4f}, done "
          f"{int(state.done.sum())}", flush=True)

    # ---- 4. small-input reference: the same substep on the CPU ----------
    m = env.model
    small = bridge.to_numpy(state.data)
    small = {k: ({kk: vv[..., :4] for kk, vv in v.items()}
                 if isinstance(v, dict) else v[..., :4])
             for k, v in small.items()}
    out = F.step(m, bridge.data_from_numpy(small, m))
    ref = {}
    for dtype in (torch.float32, torch.float64):
        cpu = make_walk_on_ball("cpu", dtype=dtype).model
        ref[dtype] = F.step(cpu, bridge.data_from_numpy(small, cpu))
    for name in ("qacc", "qvel", "qpos", "sensordata"):
        c32 = getattr(out, name).cpu()
        r32 = getattr(ref[torch.float32], name)
        r64 = getattr(ref[torch.float64], name)
        rel, rel32 = rel_norm(c32, r32), rel_norm(r32, r64)
        tol = max(TOL_SUBSTEP[name], F64_FACTOR * rel32)
        print(f"check: substep {name:10s} card f32 vs cpu f32 rel_norm "
              f"{rel:.3e} (cpu f32 vs f64 {rel32:.3e}; card f32 vs f64 "
              f"{rel_norm(c32, r64):.3e}; tol {tol:.3g})", flush=True)
        if not rel <= tol:
            fail(f"substep {name} rel_norm {rel:.3e} > {tol:.3g}")

    # ---- 5. kernel against its plain version -----------------------------
    d = F.smooth_forward(m, state.data)
    prob = SF.assemble(m, d)
    fly_args, kw = prob["args"], prob["kw"]

    p = SK.random_rows_problem(B, seed=0)
    tree_r = TL.build_tree_meta(p["parent"])
    ld, dinv = TL.factor(tree_r, torch.as_tensor(
        p["Ms"], dtype=torch.float32, device=dev))
    rnd_args = {k: torch.as_tensor(p[k], device=dev).to(
        torch.int32 if p[k].dtype == np.int32 else torch.float32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_args.update(ld=ld, dinv=dinv)
    rnd_kw = dict(kl=32, kc=40, iterations=20, noslip_iterations=3,
                  power_iters=4)

    row = None
    for label, tree, args, kwa in (("fly", m.tree, fly_args, kw),
                                   ("random", tree_r, rnd_args, rnd_kw)):
        n0 = SK.solve_rows.launches
        got = SK.solve_rows(tree, **args, **kwa)
        want = SK.solve_rows_reference(tree, **args, **kwa)
        want64 = SK.solve_rows_reference(
            tree, **{k: x.double() if x is not None and x.is_floating_point()
                     else x for k, x in args.items()}, **kwa)
        torch.cuda.synchronize()
        if SK.solve_rows.launches != n0 + 1:
            fail("the kernel wrapper did not launch")
        err = compare(label, got, want, want64, args["qacc_smooth"])
        k_ms = cuda_ms(lambda: SK.solve_rows(tree, **args, **kwa), 20)
        p_ms = cuda_ms(lambda: SK.solve_rows_reference(tree, **args, **kwa),
                       3)
        R = args["u6"].shape[0]
        flops = SK.solve_rows_work(m.nv, R, B, len(TL.flat_up(tree)),
                                   len(TL.flat_down(tree)),
                                   kwa["iterations"],
                                   kwa["noslip_iterations"],
                                   kwa["power_iters"])
        nbytes = (sum(x.numel() * x.element_size()
                      for x in args.values() if x is not None)
                  + sum(x.numel() * x.element_size() for x in got))
        bound = max(flops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3
        print(f"kernel: solve_rows {label} B={B} kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms, bound {bound:.4f} ms "
              f"({flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)",
              flush=True)
        if label == "fly":
            row = {"name": "solve_rows", "route": "cuda",
                   "source": "flybody_tpu_torch/csrc/solve_rows.cu",
                   "replaces": "flybody_tpu/ops/solver_kernels.py:556",
                   "launches": launches, "max_abs_err": err,
                   "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound,
                   "bound_by": ("operations" if flops / PEAK_F32
                                >= nbytes / PEAK_BYTES else "bytes"),
                   "library_ms": None}

    # ---- 6. result -------------------------------------------------------
    print(json.dumps({"kernels": [row]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
