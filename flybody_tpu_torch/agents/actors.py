"""Batched actor: policy rollout + n-step transition assembly.

One rollout chunk steps a batch of lockstep envs for ``unroll_length``
control steps: policy forward, physics step, auto-reset, then n-step
reward/bootstrap assembly over the chunk. The loop over control steps is a
Python loop; its diagnostics stay device tensors (no host sync inside).

N-step semantics match acme's adder: windows truncate at episode
boundaries; termination zeroes the bootstrap via the env discount, while
time-limit truncation bootstraps from the boundary observation.
"""

from __future__ import annotations

import dataclasses

import torch

from flybody_tpu_torch.agents.dmpo import Transition
from flybody_tpu_torch.agents.networks import batch_concat
from flybody_tpu_torch.utils import telemetry as tm

_TRANSITION_KEYS = ("obs", "action", "reward", "discount", "done",
                    "obs_after", "episode_return")


def canonical_to_real(action, lo, hi):
    """Map canonical [-1, 1] actions to env bounds (acme
    CanonicalSpecWrapper with clip=True)."""
    a = torch.clamp(action, -1.0, 1.0)
    return lo + (a + 1.0) * 0.5 * (hi - lo)


@dataclasses.dataclass
class RolloutConfig:
    unroll_length: int = 40     # control steps per rollout chunk
    n_step: int = 5
    discount: float = 0.99


def init_rollout_tail(cfg: RolloutConfig, n_env: int, obs_size: int,
                      action_size: int, dtype=torch.float32, device=None):
    """Inert (n-1)-step tail seeding the first chunk: done=True at every
    slot, so no window can extend past a tail step. (The few zero-obs
    transitions that start in the seed tail carry reward 0 / discount 0:
    one-time, inert for learning.)"""
    n = cfg.n_step - 1
    z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    return dict(obs=z(n, n_env, obs_size), action=z(n, n_env, action_size),
                reward=z(n, n_env), discount=z(n, n_env),
                done=torch.ones((n, n_env), dtype=torch.bool, device=device),
                obs_after=z(n, n_env, obs_size),
                episode_return=z(n, n_env))


def flat_obs(obs: dict, obs_keys=None, obs_pad: int = 0) -> torch.Tensor:
    """A batch of observation dicts as (B, n + obs_pad) rows in
    ``obs_keys`` order (sorted by default), zero-padded by ``obs_pad``
    (multi-task training pads each task up to the union size: the
    positional analog of the reference's SameObs normalization,
    rodent_tasks_modified.py:31-39)."""
    x = batch_concat(obs, keys=obs_keys, num_batch_dims=1)
    if obs_pad:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (obs_pad,))], dim=-1)
    return x


def actor_dist(policy, obs_flat: torch.Tensor, generator):
    """The policy's action distribution on the actor path: an intention
    policy decodes a latent drawn from ``generator`` (its mean when
    ``generator`` is None)."""
    if hasattr(policy, "with_intention"):
        return policy.with_intention(obs_flat, generator)[0]
    return policy(obs_flat)


def make_rollout_fn(env, cfg: RolloutConfig, stochastic: bool = True,
                    action_delay: int = 0, obs_keys=None, obs_pad: int = 0):
    """Returns rollout(policy, env_states, tail, generator) ->
    (new_env_states, new_tail, Transition batch (flattened windows),
    metrics).

    ``policy(obs_flat)`` returns a NormalDiag; actions are its samples
    (drawn from ``generator``) or, with stochastic=False, its mode. An
    intention policy's latent is drawn from ``generator`` first, either
    way (``actor_dist``; with no generator its mean is decoded).
    ``tail`` is the previous chunk's trailing n-1 steps, prepended so every
    control step starts exactly one n-step window (without it the last n-1
    steps of a chunk would never start a transition). ``action_delay``
    emulates the reference's DelayedFeedForwardActor queue. ``obs_keys``
    fixes the flattening order; ``obs_pad`` zeros pad each flat
    observation (``flat_obs``).
    """
    lo, hi = env.action_spec()
    lo = torch.as_tensor(lo, dtype=env.dtype, device=env.device)
    hi = torch.as_tensor(hi, dtype=env.dtype, device=env.device)

    @torch.no_grad()
    @tm.spanned("actor.rollout")
    def rollout(policy, env_states, tail, generator):
        n_env = env_states.done.shape[0]
        delay_buf = torch.zeros((max(action_delay, 1), n_env, lo.shape[0]),
                                dtype=env.dtype, device=env.device)
        steps = {k: [] for k in _TRANSITION_KEYS}
        for _ in range(cfg.unroll_length):
            obs_flat = flat_obs(env_states.obs, obs_keys, obs_pad)
            with tm.span("actor.policy"):
                dist = actor_dist(policy, obs_flat, generator)
                canonical = (dist.sample(generator) if stochastic
                             else dist.mode())
            if action_delay > 0:
                # fixed action-delay queue (reference DelayedFeedForward
                # Actor, agents/actors.py:79-86)
                delayed = delay_buf[0]
                delay_buf = torch.cat([delay_buf[1:], canonical[None]])
                canonical = delayed
            stepped = env.step(env_states, canonical_to_real(canonical, lo,
                                                             hi))
            obs_after = flat_obs(stepped.obs, obs_keys, obs_pad)
            env_states = env.apply_autoreset(stepped)
            for k, v in (("obs", obs_flat), ("action", canonical),
                         ("reward", stepped.reward),
                         ("discount", stepped.discount),
                         ("done", stepped.done),
                         ("obs_after", obs_after),
                         ("episode_return",
                          stepped.metrics["episode_return"])):
                steps[k].append(v)
        traj = {k: torch.stack(v) for k, v in steps.items()}
        if cfg.n_step > 1 and tail is not None:
            full = {k: torch.cat([tail[k], traj[k]]) for k in traj}
            new_tail = {k: v[-(cfg.n_step - 1):] for k, v in traj.items()}
        else:
            full, new_tail = traj, tail
        transitions = nstep_from_trajectory(full, cfg)
        n_done = torch.sum(traj["done"])
        metrics = {
            "mean_reward": torch.mean(traj["reward"]),
            "obs_absmax": torch.amax(torch.abs(traj["obs"])),
            "episodes_done": n_done,
            "mean_episode_return": (
                torch.sum(torch.where(traj["done"], traj["episode_return"],
                                      0.0))
                / torch.clamp_min(n_done, 1)),
        }
        return env_states, new_tail, transitions, metrics

    return rollout


@tm.spanned("actor.nstep")
def nstep_from_trajectory(traj: dict, cfg: RolloutConfig) -> Transition:
    """Assemble overlapping n-step transitions from a (T, B, ...) rollout.

    Windows truncate at the first done inside the window; the bootstrap
    obs is the post-step observation at the truncation point.
    """
    n = cfg.n_step
    gamma = cfg.discount
    T = traj["reward"].shape[0]
    n_windows = T - n + 1
    sl = lambda x, k: x[k:k + n_windows]

    acc_r = sl(traj["reward"], 0)
    acc_d = gamma * sl(traj["discount"], 0)
    nxt = sl(traj["obs_after"], 0)
    ended = sl(traj["done"], 0)
    for k in range(1, n):
        take = torch.logical_not(ended)
        acc_r = acc_r + torch.where(take, acc_d * sl(traj["reward"], k), 0.0)
        nxt = torch.where(take[..., None], sl(traj["obs_after"], k), nxt)
        acc_d = torch.where(take, acc_d * gamma * sl(traj["discount"], k),
                            acc_d)
        ended = torch.logical_or(ended, sl(traj["done"], k))

    flat = lambda x: x.reshape((-1,) + tuple(x.shape[2:]))
    return Transition(
        obs=flat(sl(traj["obs"], 0)),
        action=flat(sl(traj["action"], 0)),
        reward=flat(acc_r), discount=flat(acc_d), next_obs=flat(nxt))
