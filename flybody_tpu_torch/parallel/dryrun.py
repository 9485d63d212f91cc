"""A dry run of data-parallel training: one full training iteration over W
ranks (the counterpart of the JAX package's dryrun_multichip and
tools/scaling_dryrun.py).

    python -m flybody_tpu_torch.parallel.dryrun --procs 2 --device cpu
    python -m flybody_tpu_torch.parallel.dryrun --procs 2 --device cuda \\
        --backend gloo              # two ranks may share one card over gloo
    torchrun --standalone --nproc_per_node 1 \\
        -m flybody_tpu_torch.parallel.dryrun --device cuda --backend nccl

With ``--procs`` the ranks are spawned here and join through a file store
in a temporary directory; under torchrun the process is one rank of
torchrun's group (a group of one still goes through the collectives).
Each rank runs walk_on_ball (time_limit 0.05) with the JAX dry run's
sizes scaled by W (one env per rank, unroll 7, n-step 5, 4 action samples,
a batch of 2 per rank) and prints one JSON row: pid, procs, envs, s/iter,
solve_rows launches, the learner steps and a hash of the parameters
(equal on every rank when the gradient all-reduce works).

``spawn`` runs any worker of this module on W ranks and returns each
rank's result: the tests and chip_smoke.py drive the split-batch update
(``split_update_worker``), the multi-task iteration
(``multitask_worker``) and the CLI (``cli_worker``) through it.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from flybody_tpu_torch.parallel import distributed as D

# the tests' and the dry run's short wait on a rank that fails
TIMEOUT_S = 120.0
# the JAX dry run's rollout and learner sizes (dryrun_multichip); the envs
# and the batch are per rank
UNROLL, N_STEP, NUM_SAMPLES = 7, 5, 4
ENVS_PER_RANK, BATCH_PER_RANK = 1, 2


def param_hash(train) -> str:
    """sha256 (16 hex digits) of the online and target networks' and the
    duals' parameters, as bytes."""
    h = hashlib.sha256()
    for m in (train.policy, train.critic, train.target_policy,
              train.target_critic, train.dual_params):
        for p in m.parameters():
            h.update(p.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def iteration_worker(r: int, device, dtype=torch.float32) -> dict:
    """One training iteration of walk_on_ball at the dry run's sizes on
    this rank: its row (and its metrics, as floats)."""
    from flybody_tpu_torch.agents.dmpo import DMPOConfig
    from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig
    from flybody_tpu_torch.fly_envs import walk_on_ball
    from flybody_tpu_torch.ops import solver_kernels

    w = D.world_size()
    env = walk_on_ball(device=device, dtype=dtype, time_limit=0.05)
    cfg = TrainerConfig(
        num_envs=ENVS_PER_RANK * w, unroll_length=UNROLL,
        replay_capacity=128 * w, min_replay_size=w, samples_per_insert=1.0,
        dmpo=DMPOConfig(batch_size=BATCH_PER_RANK * w, n_step=N_STEP,
                        num_samples=NUM_SAMPLES))
    trainer = DMPOTrainer(env, cfg)
    loop = D.make_global_loop_state(trainer, 0)
    _sync(device)
    solver_kernels.solve_rows.launches = 0
    t0 = time.perf_counter()
    loop, metrics = trainer.train_iteration(loop)
    _sync(device)
    dt = time.perf_counter() - t0
    return {"pid": r, "procs": w, "envs": cfg.num_envs,
            "s_per_iter": dt,
            "solve_rows_launches": solver_kernels.solve_rows.launches,
            "learner_steps": loop.train.steps,
            "params": param_hash(loop.train),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def split_update_worker(r: int, device, learner, state_dict, batches,
                        eps) -> dict:
    """``len(batches)`` learner updates from ``state_dict`` on this rank's
    block of each batch (and of its action normals ``eps``, (N, B, A)):
    the updated networks' and duals' state_dicts and each update's stats,
    reduced over the ranks."""
    from flybody_tpu_torch.agents.dmpo import Transition
    from flybody_tpu_torch.parallel.mesh import reduce_metrics, shard_leading

    w = D.world_size()
    learner.policy.to(device)
    learner.critic.to(device)
    learner.device = torch.device(device)
    state = learner.init(torch.Generator().manual_seed(0))
    # the networks, optimizers and counts (the normals are given)
    for k in state._MODULES:
        getattr(state, k).load_state_dict(state_dict[k])
    for k in state._COUNTS:
        setattr(state, k, int(state_dict[k]))
    stats = []
    for batch, e in zip(batches, eps):
        half = Transition(**shard_leading(
            {k: v.to(device) for k, v in vars(batch).items()}, r, w))
        e = e.to(device)
        e = e[:, e.shape[1] // w * r:e.shape[1] // w * (r + 1)]
        s = learner.update(state, half, eps=e)
        stats.append({k: v.cpu() for k, v in reduce_metrics(s).items()})
    nets = {k: {n: t.cpu() for n, t in getattr(state, k).state_dict().items()}
            for k in ("policy", "critic", "target_policy", "target_critic",
                      "dual_params")}
    return {"nets": nets, "stats": stats, "params": param_hash(state),
            "copies": (state.target_policy_copies,
                       state.target_critic_copies)}


def multitask_worker(r: int, device, num_envs: dict, cfg) -> dict:
    """One MultiTaskDMPOTrainer iteration over walk_on_ball and
    walk_imitation (time_limit 0.05) at the global ``num_envs``: the
    metrics as floats and the parameters' hash."""
    from flybody_tpu_torch import fly_envs
    from flybody_tpu_torch.agents.multitask import MultiTaskDMPOTrainer

    envs = {k: getattr(fly_envs, k)(device=device, time_limit=0.05)
            for k in num_envs}
    trainer = MultiTaskDMPOTrainer(envs, num_envs, cfg)
    loop = D.make_global_loop_state(trainer, 0)
    loop, metrics = trainer.train_iteration(loop)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "local_envs": trainer.local_envs,
            "sizes": {k: v.size for k, v in loop.replays.items()},
            "steps": loop.train.steps, "params": param_hash(loop.train)}


def cli_worker(r: int, device, argv) -> int:
    """train_dmpo's main on this rank; its exit code."""
    from flybody_tpu_torch import train_dmpo
    return train_dmpo.main(list(argv))


def run_jobs(r: int, device, jobs) -> list:
    """Each (worker name, args) of ``jobs`` in turn on this rank: their
    results (one spawn for many checks)."""
    return [globals()[name](r, device, *args) for name, args in jobs]


def _rank_main(r: int, procs: int, device: str, backend, store: str,
               timeout: float, worker: str, args) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(procs))
    dev = D.rank_device(device)
    backend = backend or D.BACKENDS[dev.type]
    if backend == "nccl":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{store}/group",
                            world_size=procs, rank=r,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        out = globals()[worker](r, dev, *args)
        torch.save(out, os.path.join(store, f"rank{r}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(worker: str, procs: int, args=(), device="cpu",
          backend: str | None = None, timeout: float = TIMEOUT_S) -> list:
    """``worker(rank, device, *args)`` (a function of this module, by
    name) on ``procs`` spawned ranks joined through a file store in a
    temporary directory: each rank's result. A rank that raises raises
    here (the others give up waiting after ``timeout`` s)."""
    with tempfile.TemporaryDirectory() as store:
        mp.spawn(_rank_main, nprocs=procs, join=True,
                 args=(procs, device, backend, store, timeout, worker,
                       tuple(args)))
        return [torch.load(os.path.join(store, f"rank{r}.pt"),
                           weights_only=False) for r in range(procs)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--procs", type=int, default=2,
                   help="ranks to spawn (ignored under torchrun)")
    p.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    p.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    args = p.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        # one rank of torchrun's group: join it even as a group of one
        dev = D.rank_device(args.device)
        backend = args.backend or D.BACKENDS[dev.type]
        if backend == "nccl":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            rows = [iteration_worker(D.rank(), dev)]
        finally:
            dist.destroy_process_group()
    else:
        rows = spawn("iteration_worker", args.procs, device=args.device,
                     backend=args.backend)
    for row in rows:
        print(json.dumps({k: v for k, v in row.items() if k != "metrics"}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
