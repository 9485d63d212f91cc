"""Distributional MPO learner (PyTorch).

* distributional critic: categorical projection of r + gamma^n * z onto the
  fixed atom grid, cross-entropy against the online critic's logits; the
  target distribution averages (log-sum-exp) the target critic's logits
  over N target-policy action samples.
* policy: decoupled-KL MPO (losses_mpo.mpo_loss) on those samples.
* three Adam optimizers (policy / critic / dual), the first two after a
  global-norm clip of 40 over their own gradients; periodic target-network
  copies (policy every 101 updates, critic every 107).
* an intention policy (``with_intention``) adds KL(intention || N(0, 1))
  when ``intention_kl_weight`` > 0; a frozen decoder
  (``intention_networks.freeze_decoder``) gets no gradients.

The networks and optimizers live in a ``TrainState``; ``update`` changes it
in place. Target-network passes run under ``torch.no_grad()``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Callable

import torch

from benchmark.reference.agents import losses_mpo
from benchmark.reference.agents.distributions import NormalDiag
from benchmark.reference.agents.losses_mpo import DualParams, MPOConfig


@dataclasses.dataclass
class Transition:
    """n-step transition batch."""
    obs: torch.Tensor        # (B, obs_size) flat
    action: torch.Tensor     # (B, A)
    reward: torch.Tensor     # (B,) n-step discounted sum
    discount: torch.Tensor   # (B,) gamma^n * prod(discounts)
    next_obs: torch.Tensor   # (B, obs_size)


@dataclasses.dataclass
class TrainState:
    """Online and target networks, duals, their optimizers, the update
    count (a host int) and the generator of the target-action normals.
    ``target_*_copies`` count the target copies made so far."""
    policy: torch.nn.Module
    critic: torch.nn.Module
    target_policy: torch.nn.Module
    target_critic: torch.nn.Module
    dual_params: DualParams
    policy_opt: torch.optim.Optimizer
    critic_opt: torch.optim.Optimizer
    dual_opt: torch.optim.Optimizer
    generator: torch.Generator
    steps: int = 0
    target_policy_copies: int = 0
    target_critic_copies: int = 0

    _MODULES = ("policy", "critic", "target_policy", "target_critic",
                "dual_params", "policy_opt", "critic_opt", "dual_opt")
    _COUNTS = ("steps", "target_policy_copies", "target_critic_copies")

    def state_dict(self) -> dict:
        out = {k: getattr(self, k).state_dict() for k in self._MODULES}
        out.update({k: getattr(self, k) for k in self._COUNTS})
        out["generator"] = self.generator.get_state()
        return out

    def load_state_dict(self, state: dict) -> None:
        for k in self._MODULES:
            getattr(self, k).load_state_dict(state[k])
        for k in self._COUNTS:
            setattr(self, k, int(state[k]))
        self.generator.set_state(state["generator"])


@dataclasses.dataclass(frozen=True)
class DMPOConfig:
    """Learner hyperparameters (reference ray_distributed_dmpo.py:44-82)."""
    batch_size: int = 256
    n_step: int = 5
    discount: float = 0.99
    num_samples: int = 20
    policy_lr: float = 1e-4
    critic_lr: float = 1e-4
    dual_lr: float = 1e-3
    clip_global_norm: float = 40.0
    target_policy_update_period: int = 101
    target_critic_update_period: int = 107
    mpo: MPOConfig = MPOConfig()
    # optional kickstarting distillation from a frozen teacher policy
    # (reference learning_dmpo.py:361-373): loss += eps * KL(teacher||pi)
    kickstart_epsilon: float = 0.0
    teacher_apply: Callable | None = None  # (obs) -> NormalDiag
    # optional KL-to-N(0, 1) regularizers (reference learning_dmpo.py:
    # 376-385: KL_weights = [intention, action])
    kl_to_prior_weight: float = 0.0        # action dist KL (KL_weights[1])
    intention_kl_weight: float = 0.0       # intention latent KL ([0])


def categorical_l2_project(z_p, probs, z_q):
    """Project (z_p, probs) onto the uniform support z_q (C51 projection).

    z_p: (..., n) target atom positions; probs: (..., n); z_q: (m,).
    Returns (..., m) projected probabilities: each atom's mass splits
    between its two neighbours on z_q by linear interpolation.
    """
    vmin, vmax = z_q[0], z_q[-1]
    m = z_q.shape[0]
    dz = (vmax - vmin) / (m - 1)
    b = torch.clamp((torch.clamp(z_p, vmin, vmax) - vmin) / dz, 0.0, m - 1.0)
    lo = torch.floor(b)
    frac = b - lo
    lo_idx = lo.long()
    hi_idx = torch.clamp_max(lo_idx + 1, m - 1)
    out = torch.zeros(z_p.shape[:-1] + (m,), dtype=probs.dtype,
                      device=probs.device)
    out.scatter_add_(-1, lo_idx, probs * (1.0 - frac))
    out.scatter_add_(-1, hi_idx, probs * frac)
    return out


@torch.no_grad()
def clip_by_global_norm_(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on ``params``' gradients, in place: when
    the global norm reaches max_norm, g <- g / norm * max_norm (torch's
    clip_grad_norm_ adds 1e-6 to the norm, optax does not). No host
    sync."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@torch.no_grad()
def _copy_params(target: torch.nn.Module, online: torch.nn.Module) -> None:
    for t, o in zip(target.parameters(), online.parameters()):
        t.copy_(o)


class DMPOLearner:
    """Network definitions + config; all state lives in a TrainState.

    ``policy`` and ``critic`` are modules whose architecture (and device
    and dtype) ``init`` copies; their own weights are not used."""

    def __init__(self, policy, critic, action_size: int, obs_size: int,
                 cfg: DMPOConfig = DMPOConfig()):
        self.policy = policy
        self.critic = critic
        self.cfg = cfg
        self.action_size = action_size
        self.obs_size = obs_size
        p = next(policy.parameters())
        self.device, self.dtype = p.device, p.dtype

    def init(self, generator: torch.Generator | None = None) -> TrainState:
        """Fresh networks drawn from ``generator`` (a CPU generator; see
        networks.py), targets equal to them, fresh optimizers, and the
        learner's own generator on the device, seeded from ``generator``."""
        cfg = self.cfg
        policy = copy.deepcopy(self.policy)
        critic = copy.deepcopy(self.critic)
        policy.reset_parameters(generator)
        critic.reset_parameters(generator)
        seed = int(torch.randint(2 ** 62, (1,), generator=generator))
        dual_params = losses_mpo.init_dual_params(
            self.action_size, dtype=self.dtype, device=self.device)
        return TrainState(
            policy=policy, critic=critic,
            target_policy=copy.deepcopy(policy).requires_grad_(False),
            target_critic=copy.deepcopy(critic).requires_grad_(False),
            dual_params=dual_params,
            policy_opt=torch.optim.Adam(policy.parameters(),
                                        lr=cfg.policy_lr),
            critic_opt=torch.optim.Adam(critic.parameters(),
                                        lr=cfg.critic_lr),
            dual_opt=torch.optim.Adam(dual_params.parameters(),
                                      lr=cfg.dual_lr),
            generator=torch.Generator(self.device).manual_seed(seed))

    # ------------------------------------------------------------------
    def _policy_loss(self, state: TrainState, batch: Transition,
                     target_dist: NormalDiag, a_t, q_values):
        cfg = self.cfg
        intention = None
        if hasattr(state.policy, "with_intention"):
            online_dist, intention = state.policy.with_intention(
                batch.next_obs)
        else:
            online_dist = state.policy(batch.next_obs)
        loss, stats = losses_mpo.mpo_loss(
            cfg.mpo, state.dual_params, online_dist, target_dist, a_t,
            q_values)
        if cfg.kickstart_epsilon > 0 and cfg.teacher_apply is not None:
            with torch.no_grad():
                teacher = cfg.teacher_apply(batch.next_obs)
            kl_ks = torch.mean(torch.sum(losses_mpo.kl_normal_diag_per_dim(
                teacher, online_dist), dim=-1))
            loss = loss + cfg.kickstart_epsilon * kl_ks
            stats["kickstart_kl"] = kl_ks
        if cfg.kl_to_prior_weight > 0:
            prior = NormalDiag(torch.zeros_like(online_dist.mean),
                               torch.ones_like(online_dist.stddev))
            kl_prior = torch.mean(torch.sum(
                losses_mpo.kl_normal_diag_per_dim(online_dist, prior),
                dim=-1))
            loss = loss + cfg.kl_to_prior_weight * kl_prior
            stats["kl_to_prior"] = kl_prior
        if cfg.intention_kl_weight > 0 and intention is not None:
            # KL(intention || N(0, 1)) on the latent (reference
            # learning_dmpo.py:377-385, the KL_intention term)
            zprior = NormalDiag(torch.zeros_like(intention.mean),
                                torch.ones_like(intention.stddev))
            kl_int = torch.mean(torch.sum(
                losses_mpo.kl_normal_diag_per_dim(intention, zprior),
                dim=-1))
            loss = loss + cfg.intention_kl_weight * kl_int
            stats["intention_kl"] = kl_int
        return loss, stats

    def losses(self, state: TrainState, batch: Transition, eps=None):
        """(critic_loss, policy_loss, stats) on ``batch``. ``eps`` are the
        standard normals (N, B, A) of the N target-policy actions; drawn
        from state.generator when not given."""
        cfg = self.cfg
        n = cfg.num_samples
        with torch.no_grad():
            target_dist = state.target_policy(batch.next_obs)
            if eps is None:
                # frozen copy: drawn in float32 and cast, so that a
                # float64 reference reads a float32 run's draws
                eps = torch.randn((n,) + tuple(target_dist.mean.shape),
                                  generator=state.generator,
                                  dtype=torch.float32,
                                  device=target_dist.mean.device
                                  ).to(target_dist.mean.dtype)
            a_t = target_dist.transform(eps)                   # (N, B, A)
            tiled = batch.next_obs.expand((n,) + batch.next_obs.shape)
            zt = state.target_critic(tiled.reshape(-1, self.obs_size),
                                     a_t.reshape(-1, self.action_size))
            logits = zt.logits.reshape(n, -1, zt.logits.shape[-1])
            # average the N distributions (log-sum-exp)
            target_logits = torch.logsumexp(logits, dim=0) - math.log(n)
            values = zt.values
            z_p = batch.reward[:, None] + batch.discount[:, None] * values
            target_probs = categorical_l2_project(
                z_p, torch.softmax(target_logits, dim=-1), values)
            # q values for MPO: the mean of the target critic's distribution
            q_values = zt.mean().reshape(n, -1)
        online = state.critic(batch.obs, batch.action)
        logq = torch.log_softmax(online.logits, dim=-1)
        critic_loss = -torch.mean(torch.sum(target_probs * logq, dim=-1))
        policy_loss, stats = self._policy_loss(state, batch, target_dist,
                                               a_t, q_values)
        return critic_loss, policy_loss, stats

    def update(self, state: TrainState, batch: Transition, eps=None) -> dict:
        """One step over the three parameter groups, in place on
        ``state``; returns the stats as 0-d device tensors."""
        cfg = self.cfg
        critic_loss, policy_loss, stats = self.losses(state, batch, eps)
        opts = (state.policy_opt, state.critic_opt, state.dual_opt)
        for opt in opts:
            opt.zero_grad(set_to_none=True)
        # the two losses share no parameter: one backward gives both
        (critic_loss + policy_loss).backward()
        # a frozen decoder has no gradients, so it adds nothing to the norm
        # (as its zeroed gradients add nothing in the JAX package's chain)
        clip_by_global_norm_(state.policy.parameters(), cfg.clip_global_norm)
        clip_by_global_norm_(state.critic.parameters(), cfg.clip_global_norm)
        for opt in opts:
            opt.step()
        losses_mpo.clip_dual_params_(state.dual_params)

        state.steps += 1
        if state.steps % cfg.target_policy_update_period == 0:
            _copy_params(state.target_policy, state.policy)
            state.target_policy_copies += 1
        if state.steps % cfg.target_critic_update_period == 0:
            _copy_params(state.target_critic, state.critic)
            state.target_critic_copies += 1

        stats = {k: v.detach() for k, v in stats.items()}
        stats["critic_loss"] = critic_loss.detach()
        stats["policy_loss_total"] = policy_loss.detach()
        return stats
