#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi)
  2. build    every CUDA source of flybody_tpu_torch/csrc with nvcc, one
              process per source, all started together
  3. main     walk_on_ball at B=4096, float32: reset, one warm-up control
              step, then 20 autoreset_step calls with mid-range actions;
              obs and reward must be finite and the solve_rows kernel
              must have launched exactly 10 times per control step
  4. check    one substep of 4 envs of the main path's final state on the
              card (float32) against the same substep on the CPU
              (plain versions, float32; float64 sets how far apart two
              float32 runs may be)
  5. kernels  solve_rows against its plain version on the card, at the
              main path's shapes: (a) inputs captured from the main path's
              final state, (b) random inputs; times of both, and of (a)
              with the solver loop switched off (where the time goes)
  6. stages   the stage split of the same solve on phase 5's fly inputs:
              upsolve_build_yd, upsolve_yd (on J^T of the same rows, held
              against upsolve_build_yd and against its plain version) and
              apgd_iterate (its f held against solve_rows' f) against
              their plain versions, and solve_fused(_stage="yd" / "apgd")
              launching them; upsolve_yd's library yardstick, one batched
              torch.linalg.solve_triangular on the dense factor L^T D^{1/2}
              (its Yd only, not b), timed on env-major tensors made before
              the clock starts
  7. solvers  contact_solver "apgd" and "admm": one substep of 4 envs on
              the card against the CPU as in phase 4, each solver's qacc
              distance from an 800-iteration float64 APGD solve; then
              wob-admm (contact_solver "admm_kernel", budgets cut so the
              dense system has 226 rows) at B=4096 for 2 control steps
              with the admm_iterate kernel launched 10 times per control
              step, and that kernel against its plain version env by env,
              after 1 and after 20 iterations; its time at 0 iterations
  8. train    DMPOTrainer on walk_on_ball (float32, the shipped network
              widths, 256 envs, unroll 20, batch 256, 20 action samples,
              32 samples per insert = 640 updates per iteration, a replay
              ring of 1,000,000) for 2 iterations: exactly 400 solve_rows
              launches, 1280 learner updates, 10240 transitions in replay,
              finite stats, moved parameters and both target copies;
              solve_rows against its plain version on the inputs of the
              rollout's final state (B=256) as in phase 5; then three
              consecutive learner updates on the card against the same
              updates on the CPU: the losses of each, the last one's
              clipped gradients and the parameters (float32; float64 sets
              how far apart two float32 runs may be)
  9. imitation walk_imitation (the free fly on a floor, the JAX package's
              budgets: solve_rows at 176 rows, the kernel's wide instance)
              at B=4096, float32: reset from a seeded CUDA generator, one
              warm-up control step, then 10 autoreset_step calls with
              mid-range actions; obs and reward finite, solve_rows launched
              exactly 10 times per control step, floor contacts selected
              and penetrating in the final state (and taken by the
              solver); one substep of 4 envs on the card against the CPU
              as in phase 4; solve_rows against its plain version on the
              final state's inputs as in phase 5, its time with and
              without the solver loop; solve_rows' wide instance on random
              inputs over walk_imitation's tree at 176 rows; upsolve_yd
              against its plain version on J^T of the final state's rows,
              timed
 10. flight   flight_imitation (the winged fly in air, the wing fluid, the
              wing-beat pattern generator; solve_rows at 64 rows over 42
              dofs, the kernel's narrow instance) at B=4096, float32: reset
              from a seeded CUDA generator, one warm-up control step, then
              10 autoreset_step calls with mid-range actions (user action
              0); obs and reward finite, solve_rows launched exactly once
              per substep (4 per control step), the fluid force nonzero in
              every env; one substep of 4 envs on the card against the CPU
              as in phase 4; solve_rows against its plain version on the
              final state's inputs as in phase 5, its time with and without
              the solver loop. Then the template task (the free fly on a
              floor, contact solver "apgd"): 8 envs, one control step,
              finite obs and no hand kernel launched
 11. registers, shared memory, resident blocks and warps per SM and local
     (spill) bytes of every kernel (solve_rows in both instances and at
     flight's shapes), also as each kernel row's "occupancy"; the kernel
     table as JSON ("launches" on the main path of phase 3 or 6-7,
     "launches_train" in phase 8, solve_rows' "launches_imitation",
     "ms_imitation", "plain_ms_imitation" and "bound_ms_imitation" in phase
     9 and the same "*_flight" keys in phase 10, upsolve_yd's
     "ms_imitation", "plain_ms_imitation" and "bound_ms_imitation" in phase
     9), the card line, the result line
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 4096
STEPS = 20
ADMM_STEPS = 2
IMIT_STEPS = 10
FLIGHT_STEPS = 10
TEMPLATE_B = 8

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and device memory bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances of a kernel against its plain version, float32 on both.
# Every output: max |kernel - plain| / max |plain| <= 1e-3. Both run the
# same arithmetic in another summation order (~1e-6 relative for sums of
# <= 152 terms); a restart test sum(g (z_new - z)) near zero can flip in a
# few envs and change one Nesterov step there, which moves f by a fraction
# of one step, well under 1e-3 of the batch's force scale.
TOL_MAX_REL = 1e-3
# qacc = qacc_smooth + dqacc by the relative norm over the batch, as the
# JAX package's fused-solver test compares qacc (test_solver_fused.py:58);
# the same reasoning on the aggregate.
TOL_QACC = 1e-4
# One substep of 4 envs on the card (float32, kernels) against the same
# substep on the CPU (float32, plain versions) from the same state,
# relative norm over the 4 envs. The two runs round in another order
# through an ill-conditioned contact state (small fly masses, stiff
# contacts, 20 solver iterations), so they can be as far apart as float32
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

# admm_iterate against its plain version, every env on its own scale
# (max |z| of the env). The plain version takes the kernel's roundings in
# the kernel's order (admm_kernel.admm_iterate_reference), so the two
# agree bit for bit unless the card rounds an operation otherwise. No
# float64 raise: any other order of the float32 sums moves a bf16 rhs
# entry across a rounding boundary in some envs and 20 over-relaxed
# iterations carry that to ~1e-2 of the env's scale, so a bound that
# admitted it would admit a wrong kernel too.
TOL_ADMM_ENV = 1e-4

# UPDATE_STEPS consecutive learner updates on the card (float32) against
# the same updates on the CPU (float32) from the same params, batches and
# action normals: the losses of every step by relative error, the last
# step's clipped gradients of each group (policy, critic, duals) and the
# updated parameters by relative norm. The two differ in the summation
# order of the networks' float32 products (~1e-6 relative for sums of
# <= 512 terms). Adam's first step is ~lr * sign(g) per entry; from the
# second step on it depends on the gradients' magnitudes, and the
# gradients themselves are compared after the global-norm clip. A step
# that is wrong moves the parameters by O(lr) = 1e-4 per entry, ~2e-3 of
# their norm. Raised by F64_FACTOR times the CPU float32 run's distance
# from the CPU float64 run, as above. The parameter change alone (updated
# minus initial) is held at 1e-2: a wrong step is off by O(1) of it.
TOL_UPDATE = 1e-4
TOL_DELTA = 1e-2
UPDATE_STEPS = 3
TRAIN_ITERATIONS = 2

ROW_ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
            "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr")
UP_ARGS = ROW_ARGS[7:]
APGD_ARGS = ("rreg", "active", "mu", "f0", "v0")


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


def hold(label, names, got, want, want64, tol=TOL_MAX_REL, rel32=None):
    """Each output of ``got`` against ``want`` by max_rel, the bound
    ``tol`` raised to F64_FACTOR times the distance of the plain float32
    result from the plain float64 result ``want64`` (or ``rel32`` where
    given). Fails over a bound; returns the largest abs error."""
    worst = 0.0
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        err = (g - w).abs().max().item()
        rel = max_rel(g, w)
        r32 = rel32[i] if rel32 is not None else max_rel(w, want64[i])
        bound = max(tol, F64_FACTOR * r32)
        worst = max(worst, err)
        print(f"  {label} {name:6s} max_abs {err:.3e} max_rel {rel:.3e} "
              f"(plain f32 vs f64 {r32:.3e}; tol {bound:.3g})", flush=True)
        if not rel <= bound:
            fail(f"{label} {name}: max_rel {rel:.3e} > {bound:.3g}")
    return worst


def hold_envs(label, got, want, tol):
    """``got`` against ``want`` (rows, B) env by env: each env's
    max |got - want| over its own max |want|. Fails if any env is over
    ``tol``; returns the largest abs error."""
    diff = (got.double() - want.double()).abs().amax(dim=0)
    rel = diff / want.double().abs().amax(dim=0).clamp_min(1e-30)
    n_over = int((rel > tol).sum())
    print(f"  {label}: max_abs {diff.max().item():.3e}, largest env max_rel "
          f"{rel.max().item():.3e} (tol {tol:.0e}); envs that differ at all "
          f"{int((diff > 0).sum())}, over tol {n_over} of {diff.numel()}",
          flush=True)
    if n_over:
        fail(f"{label}: {n_over} envs over {tol:.0e} of their own scale")
    return diff.max().item()


def as64(x):
    return x.double() if x is not None and x.is_floating_point() else x


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None)


def bound(flops, moved) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32, moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, flops,
               moved, library_ms=None) -> dict:
    """One entry of the kernels line; bound_ms from this run's inputs."""
    b_ms, by = bound(flops, moved)
    row = {"name": name, "route": "cuda",
           "source": f"flybody_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": library_ms}
    print(f"kernel: {name} B={B} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB), launches "
          f"{launches}", flush=True)
    return row


def param_vector(*modules):
    """Every parameter of ``modules`` (or of a DualParams) as one float64
    vector on the CPU."""
    import torch
    return torch.cat([p.detach().double().cpu().reshape(-1)
                      for m in modules for p in m.parameters()])


def train_phase(env, cfg, iterations, zero_counts, counts, smi):
    """Phase 8: DMPOTrainer on ``env`` for ``iterations``; fails on any
    gate. Returns every kernel's launches in the run, the learner and the
    final LoopState."""
    import torch
    from flybody_tpu_torch.agents.train import DMPOTrainer
    trainer = DMPOTrainer(env, cfg)
    roll_s = []
    rollout = trainer.rollout_fn

    def timed_rollout(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = rollout(*args)
        torch.cuda.synchronize()
        roll_s.append(time.perf_counter() - t)
        return out

    trainer.rollout_fn = timed_rollout
    loop = trainer.init(0)
    st = loop.train
    start = {k: param_vector(getattr(st, k)) for k in (
        "policy", "critic", "target_policy", "target_critic")}
    torch.cuda.synchronize()
    zero_counts()
    iter_s = []
    for _ in range(iterations):
        t = time.perf_counter()
        loop, metrics = trainer.train_iteration(loop)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    launched = counts()
    st = loop.train
    n_updates = iterations * trainer.updates_per_iter
    n_env_steps = iterations * cfg.num_envs * cfg.unroll_length
    upd_s = [a - b for a, b in zip(iter_s, roll_s)]
    print(f"train: launches {launched} (expected solve_rows "
          f"{n_env_steps // cfg.num_envs * env.n_substeps}, the others 0)",
          flush=True)
    if launched != dict({k: 0 for k in launched},
                        solve_rows=n_env_steps // cfg.num_envs
                        * env.n_substeps):
        fail("train: solve_rows was not launched once per substep")
    print(f"train: learner_steps {st.steps} (expected {n_updates}), replay "
          f"size {loop.replay.size} (expected {n_env_steps}), target copies "
          f"policy {st.target_policy_copies} critic "
          f"{st.target_critic_copies}", flush=True)
    if st.steps != n_updates or loop.replay.size != n_env_steps:
        fail("train: wrong number of updates or transitions")
    periods = (cfg.dmpo.target_policy_update_period,
               cfg.dmpo.target_critic_update_period)
    if (st.target_policy_copies, st.target_critic_copies) != tuple(
            n_updates // p for p in periods) or min(
                n_updates // p for p in periods) < 1:
        fail("train: the target copies did not fire as scheduled")
    bad = [k for k, v in metrics.items()
           if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    if bad:
        fail(f"train: non-finite stats {bad}")
    moved = {k: rel_norm(param_vector(getattr(st, k)), v)
             for k, v in start.items()}
    print(f"train: parameters moved from init by (relative norm) "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in moved.items()})}; "
          f"critic_loss {float(metrics['critic_loss']):.4f}, "
          f"policy_loss_total {float(metrics['policy_loss_total']):.4f}, "
          f"mean_reward {float(metrics['mean_reward']):.4f}", flush=True)
    if not min(moved.values()) > 0:
        fail("train: a network or its target did not move")
    print(f"train: {iterations} iterations of {cfg.num_envs} envs x "
          f"{cfg.unroll_length} control steps + {trainer.updates_per_iter} "
          f"updates; rollout s per iteration "
          f"{[round(x, 3) for x in roll_s]}, update s per iteration "
          f"{[round(x, 3) for x in upd_s]}; actor "
          f"{n_env_steps / sum(roll_s):.1f} env-steps/s, learner "
          f"{n_updates / sum(upd_s):.1f} updates/s | {smi}", flush=True)
    return launched, trainer.learner, loop


def update_check(learner, cfg, seed: int = 1) -> None:
    """Phase 8b: UPDATE_STEPS learner updates on the card against the same
    updates on the CPU, from the same params (the port's init moved with
    .to()), the same numpy-seeded batches at the trainer's shapes and the
    same action normals."""
    import numpy as np
    import torch
    from flybody_tpu_torch.agents.dmpo import DMPOLearner, Transition
    obs, act, n, b = (learner.obs_size, learner.action_size,
                      cfg.num_samples, cfg.batch_size)
    rng = np.random.RandomState(seed)
    steps = [(dict(obs=rng.normal(size=(b, obs)),
                   action=rng.uniform(-1, 1, (b, act)),
                   reward=rng.uniform(0, 1, b),
                   discount=np.full(b, cfg.discount ** cfg.n_step),
                   next_obs=rng.normal(size=(b, obs))),
              rng.normal(size=(n, b, act))) for _ in range(UPDATE_STEPS)]
    card = learner.init(torch.Generator().manual_seed(seed))
    names = ("policy", "critic", "target_policy", "target_critic",
             "dual_params")
    groups = ("policy", "critic", "dual_params")
    start = param_vector(*(getattr(card, g) for g in groups))
    init = {k: copy.deepcopy(getattr(card, k).state_dict()) for k in names}
    runs = {}
    for label, dev, dt in (("card", learner.device, torch.float32),
                           ("cpu32", torch.device("cpu"), torch.float32),
                           ("cpu64", torch.device("cpu"), torch.float64)):
        if label == "card":
            lrn, st = learner, card
        else:
            lrn = DMPOLearner(copy.deepcopy(learner.policy).to("cpu", dt),
                              copy.deepcopy(learner.critic).to("cpu", dt),
                              act, obs, cfg)
            st = lrn.init(torch.Generator().manual_seed(seed + 1))
            for k in names:
                getattr(st, k).load_state_dict(init[k])
        out = {}
        for i, (batch, eps) in enumerate(steps):
            tb = Transition(**{k: torch.as_tensor(v, dtype=dt, device=dev)
                               for k, v in batch.items()})
            stats = lrn.update(st, tb, eps=torch.as_tensor(eps, dtype=dt,
                                                           device=dev))
            for k in ("critic_loss", "policy_loss_total"):
                out[f"{k} {i + 1}"] = float(stats[k])
        # the last step's gradients, as the optimizers took them
        for g in groups:
            out[f"{g} grads"] = torch.cat([
                p.grad.double().cpu().reshape(-1)
                for p in getattr(st, g).parameters()])
        out["params"] = param_vector(*(getattr(st, g) for g in groups))
        out["params - init"] = out["params"] - start
        runs[label] = out
        if dev.type == "cuda":
            torch.cuda.synchronize()
    card, c32, c64 = (runs[k] for k in ("card", "cpu32", "cpu64"))
    for name in card:
        dist = rel_norm if torch.is_tensor(card[name]) else (
            lambda a, b: abs(a - b) / max(abs(b), 1e-30))
        tol = TOL_DELTA if name == "params - init" else TOL_UPDATE
        rel, rel32 = dist(card[name], c32[name]), dist(c32[name], c64[name])
        bound = max(tol, F64_FACTOR * rel32)
        print(f"update: {name:22s} card f32 vs cpu f32 {rel:.3e} (cpu f32 "
              f"vs f64 {rel32:.3e}; tol {bound:.3g})", flush=True)
        if not rel <= bound:
            fail(f"update {name}: {rel:.3e} > {bound:.3g}")


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
    from flybody_tpu_torch.fly_envs import (flight_imitation, template_task,
                                            walk_imitation, walk_on_ball)
    from flybody_tpu_torch.ops import admm_kernel as AK
    from flybody_tpu_torch.ops import solver_kernels as SK
    from flybody_tpu_torch.ops import tree_ldl as TL
    from flybody_tpu_torch.physics import bridge
    from flybody_tpu_torch.physics import constraint as C
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.physics import solver_dense as SD
    from flybody_tpu_torch.physics import solver_fused as SF
    from flybody_tpu_torch.envs.core import FlyEnv
    from flybody_tpu_torch.envs.walker import FlyWalker
    from flybody_tpu_torch.physics import io_mj
    from flybody_tpu_torch.tasks import flight_imitation as FI
    from flybody_tpu_torch.tasks import walk_imitation as WI
    from flybody_tpu_torch.tasks import walk_on_ball as WOB

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # every kernel wrapper of the port, by kernel name
    wrappers = {"solve_rows": SK.solve_rows,
                "apgd_iterate": SK.apgd_iterate,
                "upsolve_build_yd": SK.upsolve_build_yd,
                "upsolve_yd": SK.upsolve_yd,
                "admm_iterate": AK.admm_iterate}

    def zero_counts():
        for w in wrappers.values():
            w.launches = 0

    def counts() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    def with_solver(model, solver):
        return model.replace(opt=model.opt.replace(contact_solver=solver))

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
    mid = torch.as_tensor((lo + hi) / 2, dtype=f32,
                          device=dev)[None].expand(B, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.reset(B)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    state = env.autoreset_step(state, mid)            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = counts()
    sps = B * STEPS / dt
    print(f"main: walk_on_ball B={B} reset {reset_s:.3f} s, {STEPS} "
          f"control steps in {dt:.3f} s = {sps:.1f} env-steps/s "
          f"({1e3 * dt / STEPS:.1f} ms per control step)", flush=True)
    print(f"main: launches {launched} (expected solve_rows "
          f"{STEPS * env.n_substeps}, the others 0)", flush=True)
    if launched != dict({k: 0 for k in wrappers},
                        solve_rows=STEPS * env.n_substeps):
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
    def first_four(data):
        """The numpy state of the first 4 envs of ``data``."""
        return {k: ({kk: vv[..., :4] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[..., :4])
                for k, v in bridge.to_numpy(data).items()}

    m = env.model
    small = first_four(state.data)
    cpu = {dt_: WOB.make_walk_on_ball("cpu", dtype=dt_).model
           for dt_ in (f32, f64)}

    def substep_check(label, model_card, solver, small=small, cpu=cpu):
        """One substep of the 4 ``small`` envs on the card against the CPU
        models ``cpu`` in float32 (bounds raised by the CPU's float32-to-
        float64 distance). Returns the card's Data."""
        mc = with_solver(model_card, solver)
        out = F.step(mc, bridge.data_from_numpy(small, mc))
        ref = {}
        for dt_, mm in cpu.items():
            mm = with_solver(mm, solver)
            ref[dt_] = F.step(mm, bridge.data_from_numpy(small, mm))
        for name in ("qacc", "qvel", "qpos", "sensordata"):
            c32 = getattr(out, name).cpu()
            r32, r64 = getattr(ref[f32], name), getattr(ref[f64], name)
            rel, rel32 = rel_norm(c32, r32), rel_norm(r32, r64)
            bound = max(TOL_SUBSTEP[name], F64_FACTOR * rel32)
            print(f"{label}: substep {name:10s} card f32 vs cpu f32 "
                  f"rel_norm {rel:.3e} (cpu f32 vs f64 {rel32:.3e}; card "
                  f"f32 vs f64 {rel_norm(c32, r64):.3e}; tol {bound:.3g})",
                  flush=True)
            if not rel <= bound:
                fail(f"{label} substep {name} rel_norm {rel:.3e} > "
                     f"{bound:.3g}")
        return out

    fused_out = substep_check("check", m, "fused")

    # ---- 5. solve_rows against its plain version -------------------------
    d = F.smooth_forward(m, state.data)
    prob = SF.assemble(m, d)
    fly_args, kw = prob["args"], prob["kw"]
    fly64 = {k: as64(x) for k, x in fly_args.items()}

    p = SK.random_rows_problem(B, seed=0)
    tree_r = TL.build_tree_meta(p["parent"])
    ld, dinv = TL.factor(tree_r, torch.as_tensor(p["Ms"], dtype=f32,
                                                 device=dev))
    rnd_args = {k: torch.as_tensor(p[k], device=dev).to(
        torch.int32 if p[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_args.update(ld=ld, dinv=dinv)
    rnd_kw = dict(kl=32, kc=40, iterations=20, noslip_iterations=3,
                  power_iters=4)

    def check_rows(label, tree, args, kwa):
        """solve_rows on the card against its plain version (float32, the
        bounds raised by float64) on ``args``; returns the kernel's
        outputs and the largest abs error."""
        n0 = SK.solve_rows.launches
        got = SK.solve_rows(tree, **args, **kwa)
        want = SK.solve_rows_reference(tree, **args, **kwa)
        want64 = SK.solve_rows_reference(
            tree, **{k: as64(x) for k, x in args.items()}, **kwa)
        torch.cuda.synchronize()
        if SK.solve_rows.launches != n0 + 1:
            fail("the kernel wrapper did not launch")
        err = hold(label, ("f", "v", "qfrc", "dqacc"), got, want, want64)
        qs = args["qacc_smooth"]
        qp, q64 = qs + want[3], qs.double() + want64[3]
        rel, rel32 = rel_norm(qs + got[3], qp), rel_norm(qp, q64)
        bound = max(TOL_QACC, F64_FACTOR * rel32)
        print(f"  {label} qacc   rel_norm {rel:.3e} (plain f32 vs f64 "
              f"{rel32:.3e}; tol {bound:.3g})", flush=True)
        if not rel <= bound:
            fail(f"{label} qacc rel_norm {rel:.3e} > {bound:.3g}")
        return got, err

    rows = {}
    b1_f = None
    R = fly_args["u6"].shape[0]
    n_up, n_down = len(TL.flat_up(m.tree)), len(TL.flat_down(m.tree))
    for label, tree, args, kwa in (("fly", m.tree, fly_args, kw),
                                   ("random", tree_r, rnd_args, rnd_kw)):
        got, err = check_rows(label, tree, args, kwa)
        k_ms = cuda_ms(lambda: SK.solve_rows(tree, **args, **kwa), 20)
        p_ms = cuda_ms(lambda: SK.solve_rows_reference(tree, **args, **kwa),
                       3)
        print(f"kernel: solve_rows {label} kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms", flush=True)
        if label == "fly":
            # where the time goes: the same call without the solver loop
            # (inputs, J build, rhs, up-sweep, y* = Yd f and the output
            # sweeps); the difference is power + APGD + noslip
            kw0 = dict(kwa, iterations=0, noslip_iterations=0,
                       power_iters=0)
            k0_ms = cuda_ms(lambda: SK.solve_rows(tree, **args, **kw0), 20)
            print(f"breakdown: solve_rows fly {k_ms:.3f} ms; without the "
                  f"solver loop {k0_ms:.3f} ms; the loop ({kwa['power_iters']}"
                  f" power, {kwa['iterations']} APGD, "
                  f"{2 * kwa['noslip_iterations']} noslip applications) "
                  f"{k_ms - k0_ms:.3f} ms", flush=True)
            b1_f = got[0]
            # library_ms None: no single PyTorch call computes the solve
            rows["solve_rows"] = kernel_row(
                "solve_rows", "solve_rows.cu",
                "flybody_tpu/ops/solver_kernels.py:556",
                launched["solve_rows"], err, k_ms, p_ms,
                SK.solve_rows_work(m.nv, R, B, n_up, n_down,
                                   kwa["iterations"],
                                   kwa["noslip_iterations"],
                                   kwa["power_iters"]),
                nbytes(*args.values(), *got))

    # ---- 6. the stage split on the fly inputs ----------------------------
    tree = m.tree
    row_in = [fly_args[k] for k in ROW_ARGS]
    up_in = [fly_args[k] for k in UP_ARGS]
    apgd_in = [fly_args[k] for k in APGD_ARGS]
    apgd64 = [fly64[k] for k in APGD_ARGS]

    # upsolve_build_yd
    got3 = SK.upsolve_build_yd(tree, *row_in)
    want3 = SK.upsolve_build_yd_reference(tree, *row_in)
    want3_64 = SK.upsolve_build_yd_reference(
        tree, *(fly64[k] for k in ROW_ARGS))
    torch.cuda.synchronize()
    err3 = hold("upsolve_build_yd", ("yd", "b"), got3, want3, want3_64)
    rel32_3 = [max_rel(w, w64) for w, w64 in zip(want3, want3_64)]

    # upsolve_yd: the up-solve of J^T of the same rows, driven alone (its
    # one use is a J^T built beforehand), held against upsolve_build_yd
    jt = SK.build_jt_reference(*row_in[:7]).contiguous()
    zero_counts()
    got4 = SK.upsolve_yd(tree, jt, *up_in)
    torch.cuda.synchronize()
    launched4 = counts()
    if launched4 != dict({k: 0 for k in wrappers}, upsolve_yd=1):
        fail(f"upsolve_yd path launches {launched4}")
    err4 = hold("upsolve_yd vs upsolve_build_yd", ("yd", "b"), got4, got3,
                None, rel32=rel32_3)
    want4 = SK.upsolve_yd_reference(tree, jt, *up_in)
    want4_64 = SK.upsolve_yd_reference(tree, jt.double(),
                                       *(fly64[k] for k in UP_ARGS))
    torch.cuda.synchronize()
    err4 = max(err4, hold("upsolve_yd", ("yd", "b"), got4, want4, want4_64))
    # the library yardstick: Yd = U^{-1} J^T with U = L^T D^{1/2} dense,
    # both env-major and made before the clock starts (Yd only, not b)
    lib_u = SK.upsolve_dense_factor(tree, fly_args["ld"], fly_args["dinv"])
    lib_j = jt.permute(2, 0, 1).contiguous()
    lib_yd = torch.linalg.solve_triangular(lib_u, lib_j, upper=True)
    torch.cuda.synchronize()
    print(f"  upsolve_yd library yardstick (solve_triangular, Yd only) vs "
          f"plain: max_rel {max_rel(lib_yd.permute(1, 2, 0), want4[0]):.3e}",
          flush=True)
    lib4_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
        lib_u, lib_j, upper=True), 20)
    del lib_yd

    # apgd_iterate on upsolve_build_yd's Yd: f as solve_rows' f
    yd, bvec = got3
    got2 = SK.apgd_iterate(yd, bvec, *apgd_in, **kw)
    want2 = SK.apgd_iterate_reference(yd, bvec, *apgd_in, **kw)
    want2_64 = SK.apgd_iterate_reference(yd.double(), bvec.double(),
                                         *apgd64, **kw)
    torch.cuda.synchronize()
    rel32_2 = [max_rel(w, w64) for w, w64 in zip(want2, want2_64)]
    err2 = hold("apgd_iterate vs solve_rows", ("f",), got2[:1], (b1_f,),
                None, rel32=rel32_2[:1])
    err2 = max(err2, hold("apgd_iterate", ("f", "ystar", "v"), got2, want2,
                          want2_64))

    # solve_fused's stage split launches them
    stage_launches = {k: 0 for k in wrappers}
    for stage, expect in (("yd", {"upsolve_build_yd": 1}),
                          ("apgd", {"upsolve_build_yd": 1,
                                    "apgd_iterate": 1})):
        zero_counts()
        out = SF.solve_fused(m, d, _stage=stage)
        torch.cuda.synchronize()
        launched_s = counts()
        print(f"stages: solve_fused(_stage={stage!r}) launches "
              f"{launched_s}", flush=True)
        if launched_s != dict({k: 0 for k in wrappers}, **expect):
            fail(f"solve_fused(_stage={stage!r}) launches {launched_s}")
        if not torch.equal(out.qacc, d.qacc_smooth):
            fail(f"solve_fused(_stage={stage!r}): probe not finite")
        for k, v in launched_s.items():
            stage_launches[k] += v

    yd_bytes = nbytes(*got3)
    flops3 = SK.upsolve_yd_work(m.nv, R, B, n_up, build=True)
    flops4 = SK.upsolve_yd_work(m.nv, R, B, n_up, build=False)
    flops2 = SK.apgd_iterate_work(m.nv, R, B, kw["iterations"],
                                  kw["noslip_iterations"],
                                  kw["power_iters"])
    # library_ms None for two: no single PyTorch call computes the J build
    # + tree up-solve + rhs, or APGD; upsolve_yd's is the dense triangular
    # solve of its Yd (not b)
    rows["upsolve_build_yd"] = kernel_row(
        "upsolve_build_yd", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:218",
        stage_launches["upsolve_build_yd"], err3,
        cuda_ms(lambda: SK.upsolve_build_yd(tree, *row_in), 20),
        cuda_ms(lambda: SK.upsolve_build_yd_reference(tree, *row_in), 3),
        flops3, nbytes(*row_in) + yd_bytes)
    rows["upsolve_yd"] = kernel_row(
        "upsolve_yd", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:84", launched4["upsolve_yd"],
        err4, cuda_ms(lambda: SK.upsolve_yd(tree, jt, *up_in), 20),
        cuda_ms(lambda: SK.upsolve_yd_reference(tree, jt, *up_in), 3),
        flops4, nbytes(jt, *up_in) + yd_bytes, library_ms=lib4_ms)
    print(f"kernel: upsolve_yd {rows['upsolve_yd']['ms']:.3f} ms against "
          f"its library yardstick (Yd only) {lib4_ms:.3f} ms | {smi}",
          flush=True)
    rows["apgd_iterate"] = kernel_row(
        "apgd_iterate", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:410",
        stage_launches["apgd_iterate"], err2,
        cuda_ms(lambda: SK.apgd_iterate(yd, bvec, *apgd_in, **kw), 20),
        cuda_ms(lambda: SK.apgd_iterate_reference(yd, bvec, *apgd_in,
                                                  **kw), 3),
        flops2, nbytes(yd, bvec, *apgd_in, *got2))
    del jt, got3, got4, want3, want3_64, want4, want4_64, yd, bvec, lib_u, \
        lib_j

    # ---- 7. the other contact solvers ------------------------------------
    cpu64 = with_solver(cpu[f64], "apgd")
    d64 = F.smooth_forward(cpu64, bridge.data_from_numpy(small, cpu64))
    qref = C.solve(cpu64, d64, iterations=800).qacc
    print(f"solvers: fused qacc vs 800-iteration apgd (cpu f64) rel_norm "
          f"{rel_norm(fused_out.qacc.cpu(), qref):.3e}", flush=True)
    for solver in ("apgd", "admm"):
        zero_counts()
        out = substep_check(f"solvers {solver}", m, solver)
        print(f"solvers: {solver} qacc vs 800-iteration apgd (cpu f64) "
              f"rel_norm {rel_norm(out.qacc.cpu(), qref):.3e}; launches "
              f"{counts()}", flush=True)
    lim, groups = C.make_efc(cpu64, d64)
    n_dense = (min(len(lim.dadr), SD.LIMIT_ACTIVE)
               + sum(min(g.condim, 3) * g.K for g in groups))
    print(f"solvers: the dense system at the shipped budgets has {n_dense} "
          f"rows (> {SD.KERNEL_MAX_ROWS}: admm_kernel runs the plain loop)",
          flush=True)

    # wob-admm: walk_on_ball's model put with its budgets overridden
    mj = WOB.load_model()
    ma = io_mj.put_model(mj, device=dev, dtype=f32,
                         **{**WOB.PUT_MODEL_KW, **WOB.WOB_ADMM_KW})
    walker = FlyWalker(ma, json.loads(str(mj["action_maps_json"])))
    env_a = FlyEnv(ma, WOB.WalkOnBall(walker), dtype=f32)
    state_a = env_a.reset(B)
    state_a = env_a.autoreset_step(state_a, mid)       # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(ADMM_STEPS):
        state_a = env_a.autoreset_step(state_a, mid)
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    launched_a = counts()
    print(f"wob-admm: B={B} {ADMM_STEPS} control steps in {dt_a:.3f} s = "
          f"{B * ADMM_STEPS / dt_a:.1f} env-steps/s; launches {launched_a}",
          flush=True)
    if launched_a != dict({k: 0 for k in wrappers},
                          admm_iterate=ADMM_STEPS * env_a.n_substeps):
        fail("admm_iterate was not launched once per substep")
    for k, v in state_a.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"wob-admm obs {k} not finite")
    if not bool(torch.isfinite(state_a.reward).all()):
        fail("wob-admm reward not finite")

    # admm_iterate against its plain version on the inputs of the next
    # (update) substep of the final state
    da = F.smooth_forward(ma, state_a.data, col_update=True)
    lim, groups = C.make_efc(ma, da)
    sysd = SD.dense_system(ma, da, lim, groups)
    n_rows = sysd["b"].shape[0]
    use, kl, kc, mu = SD.kernel_layout(sysd["ls"], groups, n_rows)
    if not (use and n_rows == 226):
        fail(f"wob-admm: {n_rows} rows, kernel layout {use}")
    akw = dict(kl=kl, kc=kc, iterations=20)
    a_in = (SD.inverse_operator(sysd["fac"]), sysd["bs"].contiguous(),
            sysd["z0"].contiguous(), mu.contiguous(),
            sysd["active"].contiguous())
    for its in (1, akw["iterations"]):
        kwi = dict(akw, iterations=its)
        got5 = AK.admm_iterate(*a_in, **kwi)
        want5 = AK.admm_iterate_reference(*a_in, **kwi)
        torch.cuda.synchronize()
        err5 = hold_envs(f"admm_iterate {its:2d} iterations", got5, want5,
                         TOL_ADMM_ENV)
    k0_ms = cuda_ms(lambda: AK.admm_iterate(*a_in, **dict(akw,
                                                           iterations=0)),
                    20)
    # library_ms None: no single PyTorch call runs the projected iteration
    rows["admm_iterate"] = kernel_row(
        "admm_iterate", "admm_iterate.cu",
        "flybody_tpu/ops/admm_kernel.py:94", launched_a["admm_iterate"],
        err5, cuda_ms(lambda: AK.admm_iterate(*a_in, **akw), 20),
        cuda_ms(lambda: AK.admm_iterate_reference(*a_in, **akw), 3),
        AK.admm_work(n_rows, B, akw["iterations"]),
        nbytes(*a_in, got5))

    print(f"breakdown: admm_iterate {rows['admm_iterate']['ms']:.3f} ms; "
          f"with 0 iterations (W staged, z0 projected) {k0_ms:.3f} ms",
          flush=True)

    # ---- 8. training -----------------------------------------------------
    from flybody_tpu_torch.agents.dmpo import DMPOConfig
    from flybody_tpu_torch.agents.train import TrainerConfig
    tcfg = TrainerConfig(num_envs=256, unroll_length=20,
                         replay_capacity=1_000_000, min_replay_size=5120,
                         samples_per_insert=32.0,
                         dmpo=DMPOConfig(batch_size=256, n_step=5,
                                         num_samples=20))
    train_launched, learner, loop = train_phase(
        env, tcfg, TRAIN_ITERATIONS, zero_counts, counts, smi)
    # solve_rows on the training path's own inputs: the next substep of the
    # rollout's final state, at the rollout's batch
    d_t = F.smooth_forward(m, loop.env_states.data)
    prob_t = SF.assemble(m, d_t)
    print(f"train: solve_rows on the rollout's final state, B="
          f"{d_t.qacc_smooth.shape[-1]}", flush=True)
    check_rows("train", m.tree, prob_t["args"], prob_t["kw"])
    del loop, d_t, prob_t
    update_check(learner, tcfg.dmpo)
    for k, row in rows.items():
        row["launches_train"] = train_launched[k]
    print(f"kernel: solve_rows launches {launched['solve_rows']} on the main "
          f"path, {train_launched['solve_rows']} in training", flush=True)

    def env_phase(label, env, steps):
        """Phases 9-10: reset B envs from a seeded CUDA generator, one
        warm-up control step, then ``steps`` timed autoreset_step calls
        with mid-range actions; fails unless solve_rows launched once per
        substep (and nothing else) and obs and reward are finite. Returns
        the final state and the launches."""
        lo_e, hi_e = env.action_spec()
        mid_e = torch.as_tensor((lo_e + hi_e) / 2, dtype=f32,
                                device=dev)[None].expand(B, -1)
        gen = torch.Generator(dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = env.reset(B, gen)
        torch.cuda.synchronize()
        reset_e = time.perf_counter() - t0
        st = env.autoreset_step(st, mid_e)               # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            st = env.autoreset_step(st, mid_e)
        torch.cuda.synchronize()
        dt_e = time.perf_counter() - t0
        launched_e = counts()
        print(f"{label}: {env.task.__class__.__name__} B={B} reset "
              f"{reset_e:.3f} s, {steps} control steps in {dt_e:.3f} s = "
              f"{B * steps / dt_e:.1f} env-steps/s "
              f"({1e3 * dt_e / steps:.1f} ms per control step) | {smi}",
              flush=True)
        print(f"{label}: launches {launched_e} (expected solve_rows "
              f"{steps * env.n_substeps}, the others 0)", flush=True)
        if launched_e != dict({k: 0 for k in wrappers},
                              solve_rows=steps * env.n_substeps):
            fail(f"{label}: solve_rows was not launched once per substep")
        for k, v in st.obs.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"{label} obs {k} not finite")
        if not bool(torch.isfinite(st.reward).all()):
            fail(f"{label} reward not finite")
        print(f"{label}: obs {len(st.obs)} keys, "
              f"{sum(v.shape[1] for v in st.obs.values())} floats per env, "
              f"all finite; reward mean {st.reward.mean().item():.4e}, done "
              f"{int(st.done.sum())}, discount 0 in "
              f"{int((st.discount == 0).sum())}", flush=True)
        return st, launched_e

    def hold_rows(label, env, st, launched_e, cpu_model, shape):
        """Phases 9-10 on the final state ``st``: one substep of 4 envs on
        the card against the CPU models ``cpu_model(dtype)`` as in phase 4,
        then solve_rows at the env's (nv, R, instance) ``shape`` against its
        plain version as in phase 5, timed with and without the solver
        loop; B1's kernel row gains the ``*_{label}`` keys. Returns R."""
        me = env.model
        substep_check(label, me, "fused", small=first_four(st.data),
                      cpu={dt_: cpu_model(dt_) for dt_ in (f32, f64)})
        prob_e = SF.assemble(me, F.smooth_forward(me, st.data))
        args_e, kw_e = prob_e["args"], prob_e["kw"]
        R_e = args_e["u6"].shape[0]
        if (me.nv, R_e, SK.tile_cpl(R_e)) != shape:
            fail(f"{label}: nv {me.nv}, {R_e} rows, instance "
                 f"{SK.tile_cpl(R_e)}; expected {shape}")
        out_e, err_e = check_rows(label, me.tree, args_e, kw_e)
        k_ms_e = cuda_ms(lambda: SK.solve_rows(me.tree, **args_e, **kw_e),
                         20)
        p_ms_e = cuda_ms(lambda: SK.solve_rows_reference(me.tree, **args_e,
                                                         **kw_e), 3)
        kw0_e = dict(kw_e, iterations=0, noslip_iterations=0, power_iters=0)
        k0_ms_e = cuda_ms(lambda: SK.solve_rows(me.tree, **args_e, **kw0_e),
                          20)
        n_up_e = len(TL.flat_up(me.tree))
        flops_e = SK.solve_rows_work(me.nv, R_e, B, n_up_e,
                                     len(TL.flat_down(me.tree)),
                                     kw_e["iterations"],
                                     kw_e["noslip_iterations"],
                                     kw_e["power_iters"])
        b_ms_e, by_e = bound(flops_e, nbytes(*args_e.values(), *out_e))
        print(f"kernel: solve_rows {label} (nv {me.nv}, R {R_e}, n_up "
              f"{n_up_e}) B={B} kernel {k_ms_e:.3f} ms, plain {p_ms_e:.3f} "
              f"ms, bound {b_ms_e:.4f} ms ({by_e}: {flops_e / 1e9:.2f} "
              f"GFLOP), launches {launched_e['solve_rows']} | {smi}",
              flush=True)
        print(f"breakdown: solve_rows {label} {k_ms_e:.3f} ms; without the "
              f"solver loop {k0_ms_e:.3f} ms; the loop "
              f"{k_ms_e - k0_ms_e:.3f} ms", flush=True)
        rows["solve_rows"].update(**{
            f"launches_{label}": launched_e["solve_rows"],
            f"max_abs_err_{label}": err_e, f"ms_{label}": k_ms_e,
            f"plain_ms_{label}": p_ms_e, f"bound_ms_{label}": b_ms_e,
            f"bound_by_{label}": by_e})
        return R_e

    # ---- 9. walk_imitation -----------------------------------------------
    env_i = walk_imitation()
    mi = env_i.model
    state_i, launched_i = env_phase("imitation", env_i, IMIT_STEPS)
    # the floor in contact: selected contacts with the floor geom on one
    # side (in a plane pair the floor is geom 1) that penetrate, and those
    # of them among the fused solver's cones
    con = state_i.data.contact
    floor = mi.names["geom"]["floor"]
    pen = (con.g1 == floor) & (con.dist < 0)
    lay = SF.fused_layout(mi, C.efc_meta(mi))
    cone_rows = mi.ix(np.concatenate([np.arange(a, b)
                                      for a, b in lay["cone"]]))
    taken = torch.gather(pen, 0, cone_rows[state_i.data.sol_cone_sel.long()])
    print(f"imitation: floor contacts selected "
          f"{int((con.g1 == floor).sum()) / B:.2f} per env, penetrating "
          f"{int(pen.sum()) / B:.2f} per env ({int((pen.sum(0) > 0).sum())} "
          f"of {B} envs), among the solver's {lay['k_cone']} cones "
          f"{int(taken.sum()) / B:.2f} per env", flush=True)
    if not (int(pen.sum()) > 0 and int(taken.sum()) > 0):
        fail("imitation: no penetrating floor contact reached the solver")
    # solve_rows at 176 rows, the wide instance
    R_i = hold_rows("imitation", env_i, state_i, launched_i,
                    lambda dt_: WI.make_walk_imitation("cpu",
                                                       dtype=dt_).model,
                    (108, 176, SK.CPL_WIDE))
    # the wide instance on random inputs over walk_imitation's tree
    p_w = SK.random_rows_problem(B, seed=0, nbody=mi.nbody, kl=32, kc=48,
                                 parent=np.asarray(mi.dof_parentid))
    ld_w, dinv_w = TL.factor(mi.tree, torch.as_tensor(p_w["Ms"], dtype=f32,
                                                      device=dev))
    rnd_w = {k: torch.as_tensor(p_w[k], device=dev).to(
        torch.int32 if p_w[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_w.update(ld=ld_w, dinv=dinv_w)
    check_rows("random wide", mi.tree, rnd_w,
               dict(rnd_kw, kl=32, kc=48))
    del rnd_w, p_w
    # upsolve_yd at 176 rows: J^T of the final state's rows
    args_i = SF.assemble(mi, F.smooth_forward(mi, state_i.data))["args"]
    row_i = [args_i[k] for k in ROW_ARGS]
    up_i = row_i[7:]
    jt_i = SK.build_jt_reference(*row_i[:7]).contiguous()
    got4_i = SK.upsolve_yd(mi.tree, jt_i, *up_i)
    want4_i = SK.upsolve_yd_reference(mi.tree, jt_i, *up_i)
    want4_i64 = SK.upsolve_yd_reference(mi.tree, jt_i.double(),
                                        *(as64(x) for x in up_i))
    torch.cuda.synchronize()
    err4_i = hold("imitation upsolve_yd", ("yd", "b"), got4_i, want4_i,
                  want4_i64)
    ms4_i = cuda_ms(lambda: SK.upsolve_yd(mi.tree, jt_i, *up_i), 20)
    pms4_i = cuda_ms(lambda: SK.upsolve_yd_reference(mi.tree, jt_i, *up_i),
                     3)
    b4_i, by4_i = bound(SK.upsolve_yd_work(mi.nv, R_i, B,
                                           len(TL.flat_up(mi.tree)),
                                           build=False),
                        nbytes(jt_i, *up_i, *got4_i))
    print(f"kernel: upsolve_yd imitation (nv {mi.nv}, R {R_i}) B={B} kernel "
          f"{ms4_i:.3f} ms, plain {pms4_i:.3f} ms, bound {b4_i:.4f} ms "
          f"({by4_i}) | {smi}", flush=True)
    rows["upsolve_yd"].update(max_abs_err_imitation=err4_i,
                              ms_imitation=ms4_i,
                              plain_ms_imitation=pms4_i,
                              bound_ms_imitation=b4_i,
                              bound_by_imitation=by4_i)
    del state_i, con, pen, taken, args_i, row_i, up_i, jt_i, got4_i, \
        want4_i, want4_i64

    # ---- 10. flight_imitation --------------------------------------------
    env_f = flight_imitation()
    mf = env_f.model
    if env_f.n_substeps != 4:
        fail(f"flight: {env_f.n_substeps} substeps per control step")
    state_f, launched_f = env_phase("flight", env_f, FLIGHT_STEPS)
    fluid = state_f.data.qfrc_fluid.abs().amax(dim=0)
    print(f"flight: max |qfrc_fluid| per env: least {fluid.min().item():.3e}"
          f", most {fluid.max().item():.3e}", flush=True)
    if not bool((fluid > 0).all()):
        fail(f"flight: no fluid force in {int((fluid == 0).sum())} envs")
    # solve_rows at 64 rows over 42 dofs, the narrow instance
    R_f = hold_rows("flight", env_f, state_f, launched_f,
                    lambda dt_: FI.make_flight_imitation("cpu",
                                                         dtype=dt_).model,
                    (42, 64, SK.CPL_NARROW))
    del state_f

    # the template task: the APGD solver, no hand kernel
    env_t = template_task()
    lo_t, hi_t = env_t.action_spec()
    mid_t = torch.as_tensor((lo_t + hi_t) / 2, dtype=f32,
                            device=dev)[None].expand(TEMPLATE_B, -1)
    state_t = env_t.reset(TEMPLATE_B)
    torch.cuda.synchronize()
    zero_counts()
    state_t = env_t.autoreset_step(state_t, mid_t)
    torch.cuda.synchronize()
    launched_t = counts()
    print(f"template: B={TEMPLATE_B} one control step ({env_t.n_substeps} "
          f"substeps, contact solver {env_t.model.opt.contact_solver!r}); "
          f"launches {launched_t} (expected 0 of every kernel)", flush=True)
    if any(launched_t.values()):
        fail("template: a hand kernel was launched")
    for k, v in state_t.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"template obs {k} not finite")
    print(f"template: obs {len(state_t.obs)} keys, "
          f"{sum(v.shape[1] for v in state_t.obs.values())} floats per env, "
          f"all finite; reward {state_t.reward.mean().item():.1f}",
          flush=True)

    # ---- 11. result ------------------------------------------------------
    nM = fly_args["ld"].shape[0]
    tabs = SK.pack_tables(m.tree)
    occupancy = (
        ("solve_rows", "", SK.kernel_info("solve_rows", m.nv, R, nM, tabs)),
        ("solve_rows", "_imitation",
         SK.kernel_info("solve_rows", mi.nv, R_i, mi.tree.nM,
                        SK.pack_tables(mi.tree))),
        ("solve_rows", "_flight",
         SK.kernel_info("solve_rows", mf.nv, R_f, mf.tree.nM,
                        SK.pack_tables(mf.tree))),
        ("upsolve_build_yd", "",
         SK.kernel_info("upsolve_build_yd", m.nv, R, nM, tabs)),
        ("upsolve_yd", "", SK.kernel_info("upsolve_yd", m.nv, R, nM, tabs)),
        ("apgd_iterate", "",
         SK.kernel_info("apgd_iterate", m.nv, R, nM, tabs)),
        ("admm_iterate", "", AK.kernel_info(n_rows)))
    for name, at, info in occupancy:
        cpl = (f" ({info['cpl']} columns per lane)" if "cpl" in info
               else "")
        print(f"occupancy: {name}{' at ' + at[1:] if at else ''}{cpl}: "
              f"{info['regs']} registers per thread, {info['local_bytes']} B "
              f"local (spill) per thread, shared memory "
              f"{info['static_smem']} B static + {info['dynamic_smem']} B "
              f"dynamic per block, {info['blocks_per_sm']} blocks and "
              f"{info['warps_per_sm']} warps per SM", flush=True)
        rows[name][f"occupancy{at}"] = {
            "regs": info["regs"], "spill_bytes": info["local_bytes"],
            "smem_bytes": info["static_smem"] + info["dynamic_smem"],
            "blocks_per_sm": info["blocks_per_sm"],
            "warps_per_sm": info["warps_per_sm"]}
    order = ("solve_rows", "apgd_iterate", "upsolve_build_yd", "upsolve_yd",
             "admm_iterate")
    print(json.dumps({"kernels": [rows[k] for k in order]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
