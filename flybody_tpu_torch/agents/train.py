"""Actor-learner training on one device: batched rollout -> replay insert
-> K learner updates, repeated.

Rate limiting (samples_per_insert) is a deterministic number of updates per
rollout chunk. Everything lives on the env's device: the networks, the
replay ring, the generators. Network modes: "plain" (MLP policy +
distributional critic) and "vision" (the fly's two eyes through VisNetFly
in both); the intention mode is ROADMAP A6, and the rodent's one-camera
VisNetRodent comes with the rodent (A7).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Sequence

import torch

from flybody_tpu_torch.agents.actors import (RolloutConfig, init_rollout_tail,
                                             make_rollout_fn)
from flybody_tpu_torch.agents.dmpo import (DMPOConfig, DMPOLearner,
                                           TrainState, Transition)
from flybody_tpu_torch.agents.networks import (VisionCritic, VisionPolicy,
                                               make_policy_critic, obs_layout)
from flybody_tpu_torch.agents.replay import ReplayBuffer

EYE_KEYS = ("left_eye", "right_eye")


@dataclasses.dataclass
class LoopState:
    train: TrainState
    env_states: Any
    replay: ReplayBuffer
    generator: torch.Generator  # rollout actions and replay sampling
    actor_steps: int
    rollout_tail: dict


@dataclasses.dataclass
class TrainerConfig:
    num_envs: int = 64
    unroll_length: int = 20
    replay_capacity: int = 100_000
    min_replay_size: int = 1_000
    samples_per_insert: float = 32.0
    dmpo: DMPOConfig = dataclasses.field(default_factory=DMPOConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)
    # network mode: "plain" or "vision" ("intention": A6)
    network: str = "plain"
    # network shapes (reference network_factory.py:89-113 defaults)
    policy_layers: Sequence[int] = (256, 256, 256)
    critic_layers: Sequence[int] = (512, 512, 256)
    vmin: float = -150.0
    vmax: float = 150.0
    num_atoms: int = 51
    action_delay: int = 0


class DMPOTrainer:
    """The training loop of a FlyEnv, on the env's device (the env
    factories give "cuda" unless the caller names another)."""

    def __init__(self, env, cfg: TrainerConfig = TrainerConfig()):
        if cfg.network not in ("plain", "vision"):
            raise NotImplementedError(
                f"network={cfg.network!r} is not ported yet (ROADMAP A6)")
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.dtype = env.dtype
        self.obs_keys, self.obs_slices = obs_layout(env.reset(1).obs)
        self.obs_size = sum(self.obs_slices[k][1] for k in self.obs_keys)
        self.action_size = env.action_size
        if cfg.network == "vision":
            policy, critic = self._vision_nets()
        else:
            policy, critic = make_policy_critic(
                self.action_size, self.obs_size,
                policy_layers=tuple(cfg.policy_layers),
                critic_layers=tuple(cfg.critic_layers),
                vmin=cfg.vmin, vmax=cfg.vmax, num_atoms=cfg.num_atoms)
        self.policy = policy.to(self.device, self.dtype)
        self.critic = critic.to(self.device, self.dtype)
        self.learner = DMPOLearner(self.policy, self.critic,
                                   self.action_size, self.obs_size, cfg.dmpo)
        cfg.rollout.unroll_length = cfg.unroll_length
        cfg.rollout.n_step = cfg.dmpo.n_step
        cfg.rollout.discount = cfg.dmpo.discount
        self.rollout_fn = make_rollout_fn(
            env, cfg.rollout, obs_keys=self.obs_keys,
            action_delay=cfg.action_delay)
        # with the cross-chunk tail every control step starts one n-step
        # window: inserted = num_envs * unroll_length, and every inserted
        # transition is sampled ~samples_per_insert times
        inserted = cfg.num_envs * cfg.unroll_length
        self.updates_per_iter = max(
            1, int(inserted * cfg.samples_per_insert // cfg.dmpo.batch_size))
        self._stat_keys = None  # the learner's stat names, once known

    def _vision_nets(self):
        """The fly's stereo eyes through VisNetFly in the policy and the
        critic (reference vis_net.py:30-109)."""
        cfg = self.cfg
        eye_slices = tuple(self.obs_slices[k] for k in EYE_KEYS
                           if k in self.obs_slices)
        if len(eye_slices) != 2:
            if "egocentric_camera" in self.obs_slices:
                raise NotImplementedError(
                    "the one-camera VisNetRodent is not ported yet "
                    "(ROADMAP A7)")
            raise ValueError(
                f"vision network needs {EYE_KEYS} observations; the env "
                f"has {sorted(self.obs_slices)}")
        policy = VisionPolicy(self.obs_size, self.action_size, eye_slices,
                              layer_sizes=tuple(cfg.policy_layers))
        critic = VisionCritic(self.obs_size, self.action_size, eye_slices,
                              layer_sizes=tuple(cfg.critic_layers),
                              vmin=cfg.vmin, vmax=cfg.vmax,
                              num_atoms=cfg.num_atoms)
        return policy, critic

    def init(self, seed: int = 0) -> LoopState:
        g = torch.Generator().manual_seed(seed)
        train = self.learner.init(g)
        loop_gen = torch.Generator(self.device).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=g)))
        env_states = self.env.reset(self.cfg.num_envs, loop_gen)
        replay = ReplayBuffer(self.cfg.replay_capacity,
                              self._zero_transition(1), device=self.device)
        tail = init_rollout_tail(self.cfg.rollout, self.cfg.num_envs,
                                 self.obs_size, self.action_size,
                                 dtype=self.dtype, device=self.device)
        return LoopState(train=train, env_states=env_states, replay=replay,
                         generator=loop_gen, actor_steps=0,
                         rollout_tail=tail)

    def _zero_transition(self, n: int) -> Transition:
        z = lambda *s: torch.zeros(s, dtype=self.dtype, device=self.device)
        return Transition(obs=z(n, self.obs_size), action=z(n,
                                                             self.action_size),
                          reward=z(n), discount=z(n),
                          next_obs=z(n, self.obs_size))

    def load_teacher(self, teacher_state_dict: dict, epsilon: float) -> None:
        """Enable kickstarting: distill from a frozen teacher policy
        (reference learning_dmpo.py:361-373)."""
        teacher = copy.deepcopy(self.policy)
        teacher.load_state_dict(teacher_state_dict)
        teacher = teacher.requires_grad_(False)
        self.learner.cfg = dataclasses.replace(
            self.learner.cfg, kickstart_epsilon=epsilon,
            teacher_apply=teacher)
        self._stat_keys = None  # the kickstart term adds a stat

    def stat_keys(self, train: TrainState) -> list:
        """The names of the stats ``learner.update`` returns, worked out
        once from the losses of one zero transition (no step, no draw from
        any generator)."""
        if self._stat_keys is None:
            eps = torch.zeros((self.cfg.dmpo.num_samples, 1,
                               self.action_size), dtype=self.dtype,
                              device=self.device)
            with torch.no_grad():
                _, _, stats = self.learner.losses(
                    train, self._zero_transition(1), eps)
            self._stat_keys = list(stats) + ["critic_loss",
                                             "policy_loss_total"]
        return self._stat_keys

    def train_iteration(self, loop: LoopState):
        """rollout -> insert -> updates, in place on ``loop``; returns
        (loop, metrics). Below min_replay_size the updates are skipped and
        the learner stats are zeros with the same keys."""
        cfg = self.cfg
        env_states, tail, transitions, actor_metrics = self.rollout_fn(
            loop.train.policy, loop.env_states, loop.rollout_tail,
            loop.generator)
        loop.env_states, loop.rollout_tail = env_states, tail
        loop.replay.insert(transitions)

        if loop.replay.size >= cfg.min_replay_size:
            stats = [self.learner.update(
                loop.train, loop.replay.sample(loop.generator,
                                               cfg.dmpo.batch_size))
                for _ in range(self.updates_per_iter)]
            learn = {k: torch.stack([s[k] for s in stats]).mean()
                     for k in stats[0]}
        else:
            learn = {k: torch.zeros((), dtype=self.dtype, device=self.device)
                     for k in self.stat_keys(loop.train)}

        loop.actor_steps += cfg.num_envs * cfg.unroll_length
        metrics = {**actor_metrics, **learn,
                   "replay_size": loop.replay.size,
                   "actor_steps": loop.actor_steps,
                   "learner_steps": loop.train.steps}
        return loop, metrics
