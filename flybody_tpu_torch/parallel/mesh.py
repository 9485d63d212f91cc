"""The data-parallel plan of the training loop over W ranks.

The JAX package shards its loop state over a 1-D "env" mesh
(flybody_tpu/parallel/mesh.py): the env batch (Data and task state on
their trailing env axis, the observations and per-env bookkeeping on their
leading one), the replay storage on its capacity axis and the rollout tail
on axis 1; the train state is replicated, and XLA inserts the gradient
all-reduce. Here each rank holds its block of every sharded field (rank
r's block is device r's shard of the JAX plan: ``shard_env_states``,
``shard_loop_state``), the train state is the same on every rank
(``broadcast_train_state``), and the learner mean-all-reduces its
gradients in one flat bucket per update (``allreduce_grads_``), so every
rank applies the same update to the same parameters.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from flybody_tpu_torch.parallel import distributed as D


def _block(n: int, r: int, w: int, what: str) -> slice:
    if n % w:
        raise ValueError(f"{what} axis of {n} does not divide over {w} "
                         "ranks")
    return slice(r * (n // w), (r + 1) * (n // w))


def _map(obj, fn):
    """``obj`` with ``fn`` applied to every tensor in it (dicts, tuples,
    lists and dataclasses are walked; other leaves are kept)."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map(v, fn) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map(v, fn) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map(getattr(obj, f.name), fn)
            for f in dataclasses.fields(obj) if f.init})
    return obj


def shard_leading(tree, r: int, w: int):
    """Rank r's block of every tensor of ``tree`` on its leading axis (a
    0-d tensor is replicated)."""
    return _map(tree, lambda x: x[_block(x.shape[0], r, w, "leading")]
                if x.ndim else x)


def shard_trailing(tree, r: int, w: int):
    """Rank r's block of every tensor of ``tree`` on its trailing (env)
    axis, the physics engine's batch axis (a 0-d tensor is replicated)."""
    return _map(tree, lambda x: x[..., _block(x.shape[-1], r, w, "trailing")]
                if x.ndim else x)


def shard_env_states(env_states, r: int, w: int, rng=None):
    """Rank r's EnvState: Data and the task state sharded on the trailing
    axis, obs, reward, done, discount, step_idx and metrics on the leading
    one (the JAX package's _shard_env_states); ``rng`` is the shard's own
    generator (a generator is not sliced)."""
    lead = lambda t: shard_leading(t, r, w)
    return env_states.replace(
        data=shard_trailing(env_states.data, r, w),
        obs=lead(env_states.obs), reward=lead(env_states.reward),
        done=lead(env_states.done), discount=lead(env_states.discount),
        step_idx=lead(env_states.step_idx), rng=rng,
        task_state=shard_trailing(env_states.task_state, r, w),
        metrics=lead(env_states.metrics))


def shard_replay(replay, r: int, w: int):
    """Rank r's ring: its block of the storage's capacity axis, holding
    the filled items of that block (the ring fills from the front)."""
    out = copy.copy(replay)
    sl = _block(replay.capacity, r, w, "replay capacity")
    out.capacity = sl.stop - sl.start
    out.storage = {k: v[sl] for k, v in replay.storage.items()}
    out.size = min(max(replay.size - sl.start, 0), out.capacity)
    out.insert_pos = out.size % out.capacity
    return out


def shard_loop_state(loop, r: int, w: int, generator=None):
    """Rank r's LoopState (the JAX package's loop_shardings): envs and the
    replay storage sharded, the rollout tail on its env axis 1, the train
    state as it is; ``generator`` is the shard's rollout and sampling
    generator."""
    tail = _map(loop.rollout_tail,
                lambda x: x[:, _block(x.shape[1], r, w, "tail env")]
                if x.ndim >= 2 else x)
    return dataclasses.replace(
        loop, env_states=shard_env_states(loop.env_states, r, w, generator),
        replay=shard_replay(loop.replay, r, w), rollout_tail=tail,
        generator=generator)


# ---- collectives ------------------------------------------------------------


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


@torch.no_grad()
def _unflat_(flat: torch.Tensor, tensors) -> None:
    i = 0
    for t in tensors:
        t.copy_(flat[i:i + t.numel()].view_as(t))
        i += t.numel()


@torch.no_grad()
def allreduce_grads_(params) -> None:
    """Replace the gradients of ``params`` (those that require one and
    have one, in the order given, the same on every rank) by their mean
    over the ranks: one collective on one flat bucket."""
    grads = [p.grad for p in params if p.requires_grad and p.grad is not None]
    if not grads:
        return
    flat = D.all_reduce_(_flat(grads))
    _unflat_(flat / D.world_size(), grads)


def _train_tensors(train) -> list:
    return [t for m in (train.policy, train.critic, train.target_policy,
                        train.target_critic, train.dual_params)
            for t in m.parameters()]


@torch.no_grad()
def broadcast_train_state(train) -> None:
    """Rank 0's networks, targets and duals on every rank, in place (one
    collective; the optimizers are fresh, or restored from one
    checkpoint)."""
    tensors = _train_tensors(train)
    _unflat_(D.broadcast_(_flat(tensors)), tensors)


def _reduce_op(key: str) -> str:
    if key == "episodes_done":
        return "sum"
    if key == "obs_absmax" or key.startswith(("obs_max/",
                                              "obs_max_terminal/")):
        return "max"
    return "mean"


@torch.no_grad()
def reduce_metrics(metrics: dict) -> dict:
    """The rollout metrics and learner stats of the ranks' shards as the
    global batch gives them: a sum of counts, a max of maxima, the
    episode return averaged over every rank's finished episodes, and the
    rest (per-env means, and every learner stat, each a mean over the
    batch of per-state terms, ``q_max`` included) the mean of the ranks'
    means. Two collectives; the values stay 0-d device tensors. Outside a
    process group the metrics are returned as they are."""
    if not D.in_group():
        return metrics
    keys = sorted(metrics)
    ops = {k: _reduce_op(k) for k in keys}
    ft = next(v.dtype for v in metrics.values() if v.is_floating_point())
    summed = [k for k in keys if ops[k] != "max"]
    parts = [metrics[k].to(ft) for k in summed]
    if "mean_episode_return" in metrics:
        i = summed.index("mean_episode_return")
        parts[i] = parts[i] * metrics["episodes_done"].to(ft)
    out = {}
    if summed:
        s = D.all_reduce_(torch.stack(parts))
        for k, v in zip(summed, s):
            if k == "mean_episode_return":
                v = v / torch.clamp_min(
                    s[summed.index("episodes_done")], 1)
            elif ops[k] == "mean":
                v = v / D.world_size()
            out[k] = v.to(metrics[k].dtype)
    maxed = [k for k in keys if ops[k] == "max"]
    if maxed:
        m = D.all_reduce_(torch.stack([metrics[k].to(ft) for k in maxed]),
                          D.dist.ReduceOp.MAX)
        out.update({k: v.to(metrics[k].dtype) for k, v in zip(maxed, m)})
    return out
