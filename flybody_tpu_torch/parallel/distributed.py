"""Multi-GPU runtime: one process per GPU, joined by torch.distributed.

The JAX package runs one SPMD program over a device mesh, its processes
joined by ``jax.distributed`` (flybody_tpu/parallel/distributed.py). The
port runs one process per GPU instead, started by torchrun, each stepping
its contiguous shard of the global env batch on ``cuda:LOCAL_RANK``:

    torchrun --nproc_per_node 4 -m flybody_tpu_torch.train_dmpo ...

    from flybody_tpu_torch.parallel import distributed as dist
    dist.init()                                   # False for one process
    env = walk_on_ball(device=dist.rank_device("cuda"))
    trainer = DMPOTrainer(env, cfg)               # cfg's sizes are global
    loop = dist.make_global_loop_state(trainer, seed)

The collectives go over NCCL on CUDA and gloo on the CPU. A gloo group
reduces host memory, so ``all_reduce_`` and ``broadcast_`` stage a CUDA
tensor through the host there, always (two gloo ranks may share one
card, which NCCL refuses).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# a rank that raises leaves the others blocked in a collective: they give
# up after this long
TIMEOUT_S = 300.0
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init(device="cuda", backend: str | None = None) -> bool:
    """Join the process group that torchrun describes (``WORLD_SIZE``,
    ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) over ``backend`` (NCCL
    for a CUDA ``device``, gloo for the CPU, unless named). Returns False,
    doing nothing, for one process; True in a group (also one already
    joined)."""
    if dist.is_initialized():
        return True
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    backend = backend or BACKENDS[torch.device(device).type]
    if backend == "nccl":
        torch.cuda.set_device(rank_device("cuda"))
    dist.init_process_group(backend, init_method="env://", world_size=world,
                            rank=int(os.environ["RANK"]),
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return True


def in_group() -> bool:
    """True when this process belongs to a process group (of any size):
    the learner then all-reduces its gradients."""
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if in_group() else 1


def rank() -> int:
    return dist.get_rank() if in_group() else 0


def local_rank() -> int:
    """This process's rank on its host (torchrun's ``LOCAL_RANK``)."""
    return int(os.environ.get("LOCAL_RANK", rank()))


def rank_device(kind="cuda") -> torch.device:
    """``cuda:LOCAL_RANK`` (modulo the cards there are, so ranks may share
    one) for "cuda", any other device as it is (and "cuda" as it is where
    there is none: the env factories raise then)."""
    kind = torch.device(kind)
    if (kind.type != "cuda" or kind.index is not None
            or not torch.cuda.is_available()):
        return kind
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def rank_seed(seed: int, r: int | None = None) -> int:
    """The seed of rank ``r``'s own generators (the rollout's, the replay
    sampling's, the target-action normals'): ``seed`` itself on rank 0, so
    one process draws as it always did, and a seed mixed with the rank on
    the others."""
    r = rank() if r is None else r
    if r == 0:
        return int(seed)
    state = np.random.SeedSequence([int(seed), r]).generate_state(2)
    return int(state[0]) << 30 ^ int(state[1])


def process_env_slice(num_envs_global: int) -> tuple[int, int]:
    """(num_local_envs, local_start): this rank's contiguous range of the
    global env batch."""
    return share(num_envs_global, "num_envs"), rank() * (
        num_envs_global // world_size())


def share(n_global: int, what: str = "count") -> int:
    """``n_global`` / world size; raises where it does not divide."""
    w = world_size()
    if n_global % w:
        raise ValueError(f"{what} {n_global} does not divide over {w} ranks")
    return n_global // w


def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend() == "gloo"


def all_reduce_(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the group, in place (staged through the host for
    a CUDA tensor in a gloo group)."""
    if _staged(t):
        host = t.cpu()
        dist.all_reduce(host, op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op)
    return t


def broadcast_(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """``t`` of rank ``src`` on every rank, in place (staged as
    all_reduce_)."""
    if _staged(t):
        host = t.cpu()
        dist.broadcast(host, src)
        t.copy_(host)
    else:
        dist.broadcast(t, src)
    return t


def _comm_device() -> torch.device:
    return rank_device("cuda") if dist.get_backend() == "nccl" \
        else torch.device("cpu")


def host_allreduce_metrics(metrics: dict) -> dict:
    """Host scalar metrics as floats, averaged over the ranks (one
    collective)."""
    if not in_group():
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    x = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                     device=_comm_device())
    all_reduce_(x)
    return dict(zip(keys, (x / world_size()).tolist()))


def make_global_loop_state(trainer, seed: int = 0):
    """The counterpart of the JAX package's make_global_loop_state: each
    rank builds only its shard (the trainer's sizes are its share of the
    global ones, its generators its rank's), and the train state comes
    from rank 0 by broadcast."""
    from flybody_tpu_torch.parallel.mesh import broadcast_train_state
    loop = trainer.init(seed)
    if in_group():
        broadcast_train_state(loop.train)
    return loop
