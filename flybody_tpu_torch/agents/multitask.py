"""Multi-task (generalist) DMPO: K env families, one learner, one device.

The reference's multi-task topology (reference
vnl_ray/train_dmpo_ray.py:328-400, 474-533 and
config/train_config_generalist.yaml) on one device: each task's actor pool
becomes a batch of lockstep envs, each task's Reverb server a replay table
of its own, and the learner's round-robin over table iterators (reference
learning_dmpo.py:425-427) a fixed alternation: each update round samples
one batch from every table, in task-name order.

All tasks share one action space (the reference trains one walker across
its tasks); observation layouts may differ: each task's flat observation
is zero-padded to the union size, the positional analog of the
reference's SameObs normalization (rodent_tasks_modified.py:31-39).

Over W data-parallel ranks (the JAX package's multitask_shardings) each
rank steps its share of every task's envs into its share of every task's
table, the learner's round-robin updates all-reduce their gradients
(``agents/dmpo.py``), and the metrics are those of the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from flybody_tpu_torch.agents.actors import init_rollout_tail, make_rollout_fn
from flybody_tpu_torch.agents.dmpo import TrainState
from flybody_tpu_torch.agents.networks import obs_layout
from flybody_tpu_torch.agents.replay import ReplayBuffer
from flybody_tpu_torch.agents.train import (TrainerBase, TrainerConfig,
                                            check_network)
from flybody_tpu_torch.parallel import distributed as D
from flybody_tpu_torch.parallel.mesh import reduce_metrics


@dataclasses.dataclass
class MultiTaskLoopState:
    train: TrainState
    env_states: dict      # task -> EnvState batch
    replays: dict         # task -> ReplayBuffer
    rollout_tails: dict   # task -> tail dict
    generator: torch.Generator  # rollout actions and replay sampling
    actor_steps: int


class MultiTaskDMPOTrainer(TrainerBase):
    """K envs -> K replay tables -> one DMPO learner, on the envs' device.

    ``envs``: {task_name: FlyEnv}; ``num_envs``: {task_name: batch size}
    (the reference's per-task actor counts, ``actors_envs``)."""

    def __init__(self, envs: Mapping[str, Any], num_envs: Mapping[str, int],
                 cfg: TrainerConfig = TrainerConfig()):
        if not envs:
            raise ValueError("need at least one task env")
        if cfg.network == "vision":
            raise ValueError("multi-task training takes network 'plain' or "
                             "'intention'")
        check_network(cfg)
        self.names = tuple(sorted(envs))
        self.envs = dict(envs)
        self.num_envs = {k: int(num_envs[k]) for k in self.names}
        self.cfg = cfg
        first = self.envs[self.names[0]]
        self.device, self.dtype = first.device, first.dtype
        if any(e.device != self.device or e.dtype != self.dtype
               for e in self.envs.values()):
            raise ValueError("the task envs must share one device and dtype")

        sizes = {k: self.envs[k].action_size for k in self.names}
        if len(set(sizes.values())) != 1:
            raise ValueError(f"tasks must share an action space: {sizes}")
        self.action_size = sizes[self.names[0]]

        # per-task layouts; the networks read the union size, zero-padded.
        # Intention mode keeps each task's task-first order, so the
        # encoder's task prefix lines up across tasks.
        task_keys = set(cfg.task_obs_keys) if cfg.network == "intention" \
            else set()
        self.obs_keys, self.obs_slices = {}, {}
        self.obs_sizes, task_obs_sizes = {}, {}
        for k in self.names:
            keys, slices = obs_layout(self.envs[k].reset(1).obs,
                                      tuple(task_keys))
            self.obs_keys[k], self.obs_slices[k] = keys, slices
            self.obs_sizes[k] = sum(slices[kk][1] for kk in keys)
            task_obs_sizes[k] = sum(slices[kk][1] for kk in keys
                                    if kk in task_keys)
        self.obs_size = max(self.obs_sizes.values())

        self.task_obs_size = 0
        if cfg.network == "intention":
            if len(set(task_obs_sizes.values())) != 1:
                raise ValueError(
                    "intention multi-task needs one task-obs prefix size "
                    f"across tasks, got {task_obs_sizes}")
            self.task_obs_size = task_obs_sizes[self.names[0]]
        self._make_learner()
        self.rollout_fns = {
            k: make_rollout_fn(self.envs[k], cfg.rollout,
                               obs_keys=self.obs_keys[k],
                               obs_pad=self.obs_size - self.obs_sizes[k],
                               action_delay=cfg.action_delay)
            for k in self.names}
        # this rank's share of the global sizes: its envs of each task,
        # its part of each table and its gate, its batch
        self.local_envs = {k: D.share(n, f"{k} envs")
                           for k, n in self.num_envs.items()}
        self.table_capacity = D.share(cfg.replay_capacity // len(self.names),
                                      "replay_capacity per table")
        self.table_gate = D.share(cfg.min_replay_size // len(self.names),
                                  "min_replay_size per table")
        self.batch_size = D.share(cfg.dmpo.batch_size, "batch_size")
        # updates per table from samples_per_insert on the smallest global
        # insert; each update round takes one batch from every table
        inserted = min(self.num_envs[k] for k in self.names) \
            * cfg.unroll_length
        self.updates_per_table = max(
            1, int(inserted * cfg.samples_per_insert // cfg.dmpo.batch_size))

    def init(self, seed: int = 0) -> MultiTaskLoopState:
        g = torch.Generator().manual_seed(seed)
        train = self.learner.init(g)
        loop_gen = self._rank_generators(
            train, int(torch.randint(2 ** 62, (1,), generator=g)))
        env_states, replays, tails = {}, {}, {}
        for k in self.names:
            env_states[k] = self.envs[k].reset(self.local_envs[k], loop_gen)
            replays[k] = ReplayBuffer(self.table_capacity,
                                      self._zero_transition(1),
                                      device=self.device)
            tails[k] = init_rollout_tail(
                self.cfg.rollout, self.local_envs[k], self.obs_size,
                self.action_size, dtype=self.dtype, device=self.device)
        return MultiTaskLoopState(train=train, env_states=env_states,
                                  replays=replays, rollout_tails=tails,
                                  generator=loop_gen, actor_steps=0)

    def train_iteration(self, loop: MultiTaskLoopState):
        """Every task's rollout -> its table, then updates_per_table rounds
        of one update per table, in place on ``loop``; returns (loop,
        metrics). Each task's rollout metrics are "<task>/<key>". The
        learner stats average the last update of each round, as in the
        JAX package; below min_replay_size // K in any table the updates
        are skipped and the stats are zeros with the same keys."""
        cfg = self.cfg
        metrics = {}
        for k in self.names:
            es, tail, transitions, am = self.rollout_fns[k](
                loop.train.policy, loop.env_states[k],
                loop.rollout_tails[k], loop.generator)
            loop.env_states[k], loop.rollout_tails[k] = es, tail
            # equal inserts on every rank: the gate opens on all at once
            assert transitions.reward.shape[0] == \
                self.local_envs[k] * cfg.unroll_length
            loop.replays[k].insert(transitions)
            metrics.update({f"{k}/{mk}": mv
                            for mk, mv in reduce_metrics(am).items()})

        if all(loop.replays[k].size >= self.table_gate for k in self.names):
            rounds = []
            for _ in range(self.updates_per_table):
                for k in self.names:
                    stats = self.learner.update(
                        loop.train, loop.replays[k].sample(
                            loop.generator, self.batch_size))
                rounds.append(stats)
            learn = {k: torch.stack([s[k] for s in rounds]).mean()
                     for k in rounds[0]}
        else:
            learn = {k: torch.zeros((), dtype=self.dtype, device=self.device)
                     for k in self.stat_keys(loop.train)}

        loop.actor_steps += sum(self.num_envs.values()) * cfg.unroll_length
        metrics.update(reduce_metrics(learn))
        metrics["actor_steps"] = loop.actor_steps
        metrics["learner_steps"] = loop.train.steps
        per_task = lambda key: torch.stack(
            [metrics[f"{k}/{key}"] for k in self.names])
        metrics["mean_episode_return"] = per_task("mean_episode_return").mean()
        metrics["mean_reward"] = per_task("mean_reward").mean()
        metrics["obs_absmax"] = per_task("obs_absmax").amax()
        return loop, metrics
