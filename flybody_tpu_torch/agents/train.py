"""Actor-learner training on one device: batched rollout -> replay insert
-> K learner updates, repeated.

Rate limiting (samples_per_insert) is a deterministic number of updates per
rollout chunk. Everything lives on the env's device: the networks, the
replay ring, the generators. Over W data-parallel ranks
(``parallel.distributed``) the TrainerConfig's sizes stay global: each
rank steps num_envs / W envs into its own ring of replay_capacity / W,
gated at min_replay_size / W, and samples batch_size / W items per update;
the updates per iteration come from the global counts, the learner
all-reduces its gradients, and the metrics are those of the global batch
(``parallel.mesh.reduce_metrics``). Network modes (reference
train_dmpo_ray.py + intention_network_factory.py + vis_net.py):

* "plain": MLP policy + distributional critic
* "intention": encoder-decoder policy over task-first observations, the
  latent sampled on the actor path, an optional latent KL term, and a
  decoder that can be restored from a donor and frozen (transfer)
* "vision": the fly's two eyes through VisNetFly, or the rodent's one
  egocentric camera through VisNetRodent, in both networks

Kickstarting distills from a frozen teacher policy by KL (reference
learning_dmpo.py:361-373).
"""

from __future__ import annotations

import copy
import dataclasses
import warnings
from typing import Any, Sequence

import torch

from flybody_tpu_torch.agents.actors import (RolloutConfig, init_rollout_tail,
                                             make_rollout_fn)
from flybody_tpu_torch.agents.dmpo import (DMPOConfig, DMPOLearner,
                                           TrainState, Transition)
from flybody_tpu_torch.agents.intention_networks import (
    IntentionPolicy, decoder_param_filter, freeze_decoder)
from flybody_tpu_torch.agents.networks import (DistributionalCritic,
                                               VisionCritic, VisionPolicy,
                                               make_policy_critic, obs_layout)
from flybody_tpu_torch.agents.replay import ReplayBuffer
from flybody_tpu_torch.parallel import distributed as D
from flybody_tpu_torch.parallel.mesh import reduce_metrics

# default task-observation keys that an intention policy's encoder reads
# (reference train_dmpo_ray.py separate_observation task prefixes)
DEFAULT_TASK_KEYS = (
    "ref_displacement", "ref_root_quat", "ref_rel_joints",
    "ref_rel_bodies_pos_local", "ref_rel_root_quat",
    "ref_ego_bodies_quats", "ref_appendages_pos", "task_input",
    "task_logic", "origin", "clip_id",
)

EYE_KEYS = ("left_eye", "right_eye")
NETWORKS = ("plain", "intention", "vision")


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
    # network mode: "plain" | "intention" | "vision"
    network: str = "plain"
    task_obs_keys: Sequence[str] = DEFAULT_TASK_KEYS
    intention_size: int = 60
    high_level_intention_size: int | None = None
    # network shapes (reference network_factory.py:89-113 defaults)
    policy_layers: Sequence[int] = (256, 256, 256)
    critic_layers: Sequence[int] = (512, 512, 256)
    encoder_layers: Sequence[int] = (512, 512)
    decoder_layers: Sequence[int] = (512, 512, 512)
    vmin: float = -150.0
    vmax: float = 150.0
    num_atoms: int = 51
    # transfer: freeze the decoder (restore it with restore_decoder)
    freeze_decoder: bool = False
    action_delay: int = 0


def check_network(cfg: TrainerConfig) -> None:
    if cfg.network not in NETWORKS:
        raise ValueError(f"network={cfg.network!r}: expected one of "
                         f"{NETWORKS}")
    if cfg.freeze_decoder and cfg.network != "intention":
        raise ValueError("freeze_decoder needs network='intention'")


class TrainerBase:
    """What the single- and the multi-task trainer share: the networks and
    their learner, the learner's stat names, kickstarting and decoder
    transfer. A subclass sets ``cfg``, ``device``, ``dtype``, ``obs_size``,
    ``action_size`` and ``task_obs_size``, then calls ``_make_learner``."""

    def _make_learner(self, nets=None) -> None:
        """``nets`` (policy, critic), else cfg.network's plain or intention
        pair (the decoder frozen with cfg.freeze_decoder), on the trainer's
        device and dtype; their DMPOLearner; the rollout config's n-step
        settings."""
        cfg = self.cfg
        if nets is None and cfg.network == "intention":
            policy = IntentionPolicy(
                self.obs_size, self.action_size, self.task_obs_size,
                intention_size=cfg.intention_size,
                encoder_layers=tuple(cfg.encoder_layers),
                decoder_layers=tuple(cfg.decoder_layers),
                high_level_intention_size=cfg.high_level_intention_size)
            if cfg.freeze_decoder:
                freeze_decoder(policy)
            nets = policy, DistributionalCritic(
                self.obs_size, self.action_size,
                layer_sizes=tuple(cfg.critic_layers), vmin=cfg.vmin,
                vmax=cfg.vmax, num_atoms=cfg.num_atoms)
        elif nets is None:
            nets = make_policy_critic(
                self.action_size, self.obs_size,
                policy_layers=tuple(cfg.policy_layers),
                critic_layers=tuple(cfg.critic_layers),
                vmin=cfg.vmin, vmax=cfg.vmax, num_atoms=cfg.num_atoms)
        self.policy = nets[0].to(self.device, self.dtype)
        self.critic = nets[1].to(self.device, self.dtype)
        self.learner = DMPOLearner(self.policy, self.critic,
                                   self.action_size, self.obs_size, cfg.dmpo)
        cfg.rollout.unroll_length = cfg.unroll_length
        cfg.rollout.n_step = cfg.dmpo.n_step
        cfg.rollout.discount = cfg.dmpo.discount
        self._stat_keys = None  # the learner's stat names, once known

    def _rank_generators(self, train: TrainState,
                         seed: int) -> torch.Generator:
        """The rollout and sampling generator from ``seed``, and the
        learner's own generator (target-action normals) reseeded, each
        from (its seed, this rank): on rank 0 they draw as one process
        does, and no two ranks draw the same noise."""
        self.rank_learner_generator(train)
        return torch.Generator(self.device).manual_seed(D.rank_seed(seed))

    @staticmethod
    def rank_learner_generator(train: TrainState) -> None:
        """On a rank > 0, reseed the learner's generator from (its seed,
        the rank): after init, and after every rank restored rank 0's
        checkpoint."""
        if D.rank():
            train.generator.manual_seed(
                D.rank_seed(train.generator.initial_seed()))

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

    def restore_decoder(self, train: TrainState, donor: dict) -> TrainState:
        """Transfer mode: copy the decoder entries of the donor policy's
        state_dict into ``train``'s online and target policy, in place
        (reference learning_dmpo.py:236-243); with cfg.freeze_decoder they
        then stay as restored. Raises, touching nothing, when the donor has
        no decoder entry that the policy has, or one of another shape (a
        decoder reads the intention and the egocentric observations, so a
        donor from a task with other egocentric observations does not
        fit; the JAX package fails at its first forward pass then)."""
        dec = decoder_param_filter(donor)[0]
        nets = [net.state_dict() for net in (train.policy,
                                             train.target_policy)]
        for own in nets:
            hits = [k for k in dec if k in own]
            if not hits:
                raise ValueError("the donor has no decoder parameter of "
                                 "this policy")
            bad = [f"{k} {tuple(dec[k].shape)} (this policy's "
                   f"{tuple(own[k].shape)})" for k in hits
                   if dec[k].shape != own[k].shape]
            if bad:
                raise ValueError(f"the donor's decoder does not fit this "
                                 f"policy: {', '.join(bad)}")
        with torch.no_grad():
            for own in nets:
                for k in dec:
                    if k in own:
                        own[k].copy_(dec[k])
        return train

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


class DMPOTrainer(TrainerBase):
    """The training loop of a FlyEnv, on the env's device (the env
    factories give "cuda" unless the caller names another)."""

    def __init__(self, env, cfg: TrainerConfig = TrainerConfig()):
        check_network(cfg)
        self.env = env
        self.cfg = cfg
        self.device = env.device
        self.dtype = env.dtype
        task_keys = set(cfg.task_obs_keys) if cfg.network == "intention" \
            else set()
        self.obs_keys, self.obs_slices = obs_layout(env.reset(1).obs,
                                                    tuple(task_keys))
        self.obs_size = sum(self.obs_slices[k][1] for k in self.obs_keys)
        self.action_size = env.action_size
        self.task_obs_size = sum(self.obs_slices[k][1] for k in self.obs_keys
                                 if k in task_keys)
        if cfg.network == "intention" and self.task_obs_size == 0:
            # no task observation in this env: the encoder reads the whole
            # observation (a pure bottleneck policy)
            warnings.warn("intention network: no task_obs_keys present in "
                          "this env's observations; encoder sees all obs")
            self.task_obs_size = self.obs_size
        self._make_learner(self._vision_nets() if cfg.network == "vision"
                           else None)
        self.rollout_fn = make_rollout_fn(
            env, cfg.rollout, obs_keys=self.obs_keys,
            action_delay=cfg.action_delay)
        # this rank's share of the global sizes
        self.num_envs = D.process_env_slice(cfg.num_envs)[0]
        self.replay_capacity = D.share(cfg.replay_capacity,
                                       "replay_capacity")
        self.min_replay_size = D.share(cfg.min_replay_size,
                                       "min_replay_size")
        self.batch_size = D.share(cfg.dmpo.batch_size, "batch_size")
        # with the cross-chunk tail every control step starts one n-step
        # window: inserted = num_envs * unroll_length, and every inserted
        # transition is sampled ~samples_per_insert times; from the global
        # counts, so every rank makes as many updates (and collectives)
        inserted = cfg.num_envs * cfg.unroll_length
        self.updates_per_iter = max(
            1, int(inserted * cfg.samples_per_insert // cfg.dmpo.batch_size))

    def _vision_nets(self):
        """The fly's stereo eyes through VisNetFly, or the rodent's one
        egocentric camera through VisNetRodent, in the policy and the
        critic (reference vis_net.py:30-109 / 112-202)."""
        cfg = self.cfg
        eye_slices = tuple(self.obs_slices[k] for k in EYE_KEYS
                           if k in self.obs_slices)
        if len(eye_slices) != 2:
            if "egocentric_camera" not in self.obs_slices:
                raise ValueError(
                    f"vision network needs {EYE_KEYS} or an "
                    f"egocentric_camera observation; env has "
                    f"{sorted(self.obs_slices)}")
            eye_slices = (self.obs_slices["egocentric_camera"],)
        policy = VisionPolicy(self.obs_size, self.action_size, eye_slices,
                              layer_sizes=tuple(cfg.policy_layers))
        critic = VisionCritic(self.obs_size, self.action_size, eye_slices,
                              layer_sizes=tuple(cfg.critic_layers),
                              vmin=cfg.vmin, vmax=cfg.vmax,
                              num_atoms=cfg.num_atoms)
        return policy, critic

    def init(self, seed: int = 0) -> LoopState:
        """This rank's loop state: the train state from ``seed`` (the same
        on every rank; ``distributed.make_global_loop_state`` also
        broadcasts it), this rank's envs, ring and tail."""
        g = torch.Generator().manual_seed(seed)
        train = self.learner.init(g)
        loop_gen = self._rank_generators(
            train, int(torch.randint(2 ** 62, (1,), generator=g)))
        env_states = self.env.reset(self.num_envs, loop_gen)
        replay = ReplayBuffer(self.replay_capacity,
                              self._zero_transition(1), device=self.device)
        tail = init_rollout_tail(self.cfg.rollout, self.num_envs,
                                 self.obs_size, self.action_size,
                                 dtype=self.dtype, device=self.device)
        return LoopState(train=train, env_states=env_states, replay=replay,
                         generator=loop_gen, actor_steps=0,
                         rollout_tail=tail)

    def train_iteration(self, loop: LoopState):
        """rollout -> insert -> updates, in place on ``loop``; returns
        (loop, metrics). Below min_replay_size the updates are skipped and
        the learner stats are zeros with the same keys. Over W ranks the
        counts (actor steps, replay size) and the metrics are global."""
        cfg = self.cfg
        env_states, tail, transitions, actor_metrics = self.rollout_fn(
            loop.train.policy, loop.env_states, loop.rollout_tail,
            loop.generator)
        loop.env_states, loop.rollout_tail = env_states, tail
        # every rank inserts as many items, so the gate below opens on
        # every rank in the same iteration
        assert transitions.reward.shape[0] == \
            self.num_envs * cfg.unroll_length
        loop.replay.insert(transitions)

        if loop.replay.size >= self.min_replay_size:
            stats = [self.learner.update(
                loop.train, loop.replay.sample(loop.generator,
                                               self.batch_size))
                for _ in range(self.updates_per_iter)]
            learn = {k: torch.stack([s[k] for s in stats]).mean()
                     for k in stats[0]}
        else:
            learn = {k: torch.zeros((), dtype=self.dtype, device=self.device)
                     for k in self.stat_keys(loop.train)}

        loop.actor_steps += cfg.num_envs * cfg.unroll_length
        metrics = {**reduce_metrics({**actor_metrics, **learn}),
                   "replay_size": loop.replay.size * D.world_size(),
                   "actor_steps": loop.actor_steps,
                   "learner_steps": loop.train.steps}
        return loop, metrics
