"""Decoupled-KL MPO loss with MO-MPO action penalization (PyTorch).

The MPO loss semantics of the reference (Abdolmaleki et al. 2018, 2020):

* E-step: softmax importance weights from tempered Q-values, temperature
  adapted by its dual loss.
* MO-MPO penalty branch: out-of-bound action cost with its own temperature.
* M-step: decomposed fixed-mean / fixed-stddev cross-entropy losses.
* Per-dimension KL constraints with alpha dual variables.

The dual variables are leaf tensors in ``DualParams``, updated by their own
optimizer. Gradients stop (``detach``) where the reference stops them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from benchmark.reference.agents.distributions import (NormalDiag,
                                                    kl_normal_diag_per_dim)
from benchmark.reference.agents.networks import softplus

_MPO_FLOAT_EPSILON = 1e-8
_MIN_LOG_DUAL = -18.0


@dataclasses.dataclass
class DualParams:
    log_temperature: torch.Tensor          # (1,)
    log_alpha_mean: torch.Tensor           # (D,)
    log_alpha_stddev: torch.Tensor         # (D,)
    log_penalty_temperature: torch.Tensor  # (1,)

    def parameters(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def state_dict(self) -> dict:
        return {f.name: getattr(self, f.name).detach().clone()
                for f in dataclasses.fields(self)}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for f in dataclasses.fields(self):
            getattr(self, f.name).copy_(state[f.name])


def init_dual_params(action_dim: int, init_log_temperature=10.0,
                     init_log_alpha_mean=10.0, init_log_alpha_stddev=1000.0,
                     dtype=torch.float32, device=None) -> DualParams:
    """Leaf tensors that require grad, on ``device``."""
    full = lambda n, v: torch.full((n,), v, dtype=dtype, device=device,
                                   requires_grad=True)
    return DualParams(
        log_temperature=full(1, init_log_temperature),
        log_alpha_mean=full(action_dim, init_log_alpha_mean),
        log_alpha_stddev=full(action_dim, init_log_alpha_stddev),
        log_penalty_temperature=full(1, init_log_temperature))


def clip_dual_params(d: DualParams) -> DualParams:
    """Projection keeping duals positive (assign-max in the reference);
    differentiable, for use inside the loss."""
    return DualParams(*(x.clamp_min(_MIN_LOG_DUAL) for x in d.parameters()))


@torch.no_grad()
def clip_dual_params_(d: DualParams) -> None:
    """The same projection in place, after an optimizer step."""
    for x in d.parameters():
        x.clamp_min_(_MIN_LOG_DUAL)


def _weights_and_temperature_loss(q_values, epsilon, temperature):
    """Normalized importance weights + temperature dual loss."""
    tempered = q_values.detach() / temperature
    weights = torch.softmax(tempered, dim=0).detach()
    q_logsumexp = torch.logsumexp(tempered, dim=0)
    log_n = math.log(q_values.shape[0])
    loss_temp = temperature * (epsilon + torch.mean(q_logsumexp) - log_n)
    return weights, loss_temp.squeeze()


def _nonparametric_kl(weights):
    n = weights.shape[0]
    return torch.sum(weights * torch.log(n * weights + 1e-8), dim=0)


def _cross_entropy_loss(actions, weights, dist: NormalDiag):
    log_prob = dist.log_prob(actions)                 # (N, B)
    return torch.mean(-torch.sum(log_prob * weights, dim=0))


def _kl_penalty_and_dual_loss(kl, alpha, epsilon):
    mean_kl = torch.mean(kl, dim=0)                   # (D,)
    loss_kl = torch.sum(alpha.detach() * mean_kl)
    loss_alpha = torch.sum(alpha * (epsilon - mean_kl.detach()))
    return loss_kl, loss_alpha


def penalization_cost_real_actions(action_spec_min, action_spec_max):
    """Map canonical [-1,1] actions to real units before the norm penalty
    (reference PenalizationCostRealActions)."""
    lo = torch.as_tensor(action_spec_min)
    scale = torch.as_tensor(action_spec_max) - lo

    def cost(actions):
        real = (0.5 * (actions + 1.0)) * scale.to(actions) + lo.to(actions)
        return -torch.linalg.vector_norm(real, dim=-1)
    return cost


@dataclasses.dataclass(frozen=True)
class MPOConfig:
    epsilon: float = 0.1
    epsilon_mean: float = 0.0025
    epsilon_stddev: float = 1e-7
    epsilon_penalty: float = 0.1
    per_dim_constraining: bool = True
    action_penalization: bool = True
    penalization_cost: Callable | None = None


def mpo_loss(cfg: MPOConfig, duals: DualParams,
             online_dist: NormalDiag, target_dist: NormalDiag,
             actions: torch.Tensor,   # (N, B, D)
             q_values: torch.Tensor,  # (N, B)
             ):
    """Returns (loss, stats). Gradients flow to the online policy (through
    online_dist) and to the dual params."""
    dtype = q_values.dtype
    duals = clip_dual_params(duals)
    temperature = softplus(duals.log_temperature.to(dtype)) \
        + _MPO_FLOAT_EPSILON
    alpha_mean = softplus(duals.log_alpha_mean.to(dtype)) \
        + _MPO_FLOAT_EPSILON
    alpha_stddev = softplus(duals.log_alpha_stddev.to(dtype)) \
        + _MPO_FLOAT_EPSILON

    weights, loss_temperature = _weights_and_temperature_loss(
        q_values, cfg.epsilon, temperature)
    kl_nonparametric = _nonparametric_kl(weights)

    stats = {}
    if cfg.action_penalization:
        penalty_temperature = softplus(
            duals.log_penalty_temperature.to(dtype)) + _MPO_FLOAT_EPSILON
        if cfg.penalization_cost is None:
            cost = -torch.linalg.vector_norm(actions, dim=-1)
        else:
            cost = cfg.penalization_cost(actions)
        p_weights, p_loss_temp = _weights_and_temperature_loss(
            cost, cfg.epsilon_penalty, penalty_temperature)
        stats["penalty_kl_q_rel"] = (torch.mean(_nonparametric_kl(p_weights))
                                     / cfg.epsilon_penalty)
        weights = weights + p_weights
        loss_temperature = loss_temperature + p_loss_temp

    online_mean, online_scale = online_dist.mean, online_dist.stddev
    target_mean, target_scale = target_dist.mean, target_dist.stddev

    fixed_stddev = NormalDiag(mean=online_mean, stddev=target_scale)
    fixed_mean = NormalDiag(mean=target_mean, stddev=online_scale)

    loss_policy_mean = _cross_entropy_loss(actions, weights, fixed_stddev)
    loss_policy_stddev = _cross_entropy_loss(actions, weights, fixed_mean)

    kl_mean = kl_normal_diag_per_dim(target_dist, fixed_stddev)   # (B, D)
    kl_stddev = kl_normal_diag_per_dim(target_dist, fixed_mean)   # (B, D)
    if not cfg.per_dim_constraining:
        kl_mean = torch.sum(kl_mean, dim=-1, keepdim=True)
        kl_stddev = torch.sum(kl_stddev, dim=-1, keepdim=True)

    loss_kl_mean, loss_alpha_mean = _kl_penalty_and_dual_loss(
        kl_mean, alpha_mean, cfg.epsilon_mean)
    loss_kl_stddev, loss_alpha_stddev = _kl_penalty_and_dual_loss(
        kl_stddev, alpha_stddev, cfg.epsilon_stddev)

    loss_policy = loss_policy_mean + loss_policy_stddev
    loss_kl_penalty = loss_kl_mean + loss_kl_stddev
    loss_dual = loss_alpha_mean + loss_alpha_stddev + loss_temperature
    loss = loss_policy + loss_kl_penalty + loss_dual

    smin = torch.amin(online_scale, dim=-1)
    smax = torch.amax(online_scale, dim=-1)
    stats.update({
        "dual_alpha_mean": torch.mean(alpha_mean),
        "dual_alpha_stddev": torch.mean(alpha_stddev),
        "dual_temperature": torch.mean(temperature),
        "loss_policy": loss_policy,
        "loss_mpo_total": loss,
        "loss_alpha": loss_alpha_mean + loss_alpha_stddev,
        "loss_temperature": loss_temperature,
        "kl_q_rel": torch.mean(kl_nonparametric) / cfg.epsilon,
        "kl_mean_rel": torch.mean(kl_mean) / cfg.epsilon_mean,
        "kl_stddev_rel": torch.mean(kl_stddev) / max(cfg.epsilon_stddev,
                                                     1e-12),
        "q_min": torch.mean(torch.amin(q_values, dim=0)),
        "q_max": torch.mean(torch.amax(q_values, dim=0)),
        "pi_stddev_min": torch.mean(smin),
        "pi_stddev_max": torch.mean(smax),
        "pi_stddev_cond": torch.mean(smax / smin),
    })
    return loss, stats
