"""Evaluator: deterministic mean-policy rollouts and aggregate statistics.

The reference evaluator (reference vnl_ray/agents/ray_distributed_dmpo.py:
342-478: an EnvironmentLoop with the policy's mean, avg / var / max / min
over eval_average_over episodes, and periodic mp4 snapshots). Here the
eval episodes run in lockstep as one batch of envs on the env's device;
videos render on the host through the C++ rasterizer
(``utils.rendering``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from flybody_tpu_torch.agents.actors import canonical_to_real
from flybody_tpu_torch.agents.networks import batch_concat


class Evaluator:
    """``Evaluator(env, eval_average_over, obs_keys)(policy, generator)``
    resets ``eval_average_over`` episodes from ``generator`` and runs them
    (``run``). ``obs_keys`` fixes the flattening order (a trainer's
    ``obs_keys``: the task-first order of an intention policy); by default
    sorted."""

    def __init__(self, env, eval_average_over: int = 8, obs_keys=None):
        self.env = env
        self.n = eval_average_over
        self.obs_keys = obs_keys
        lo, hi = env.action_spec()
        self.lo = torch.as_tensor(lo, dtype=env.dtype, device=env.device)
        self.hi = torch.as_tensor(hi, dtype=env.dtype, device=env.device)

    def __call__(self, policy, generator=None) -> dict:
        return self.run(policy, self.env.reset(self.n, generator))

    @torch.no_grad()
    def run(self, policy, states) -> dict:
        """``env.episode_steps`` control steps of ``states`` with the
        policy's mode (``env.step``, no auto-reset); each episode's return
        and length count until its first done. -> the five stats as 0-d
        device tensors."""
        env = self.env
        n = states.done.shape[0]
        ret = torch.zeros(n, dtype=env.dtype, device=env.device)
        length = torch.zeros(n, dtype=torch.int32, device=env.device)
        alive = torch.ones(n, dtype=torch.bool, device=env.device)
        for _ in range(env.episode_steps):
            obs = batch_concat(states.obs, keys=self.obs_keys,
                               num_batch_dims=1)
            action = canonical_to_real(policy(obs).mode(), self.lo, self.hi)
            states = env.step(states, action)
            ret = ret + torch.where(alive, states.reward, 0.0)
            length = length + alive.int()
            alive = alive & ~states.done
        return {
            "eval_episode_return_mean": ret.mean(),
            "eval_episode_return_var": ret.var(unbiased=False),
            "eval_episode_return_max": ret.max(),
            "eval_episode_return_min": ret.min(),
            "eval_episode_length_mean": length.float().mean(),
        }


# the JAX package's name for the evaluator's constructor
make_evaluator = Evaluator


def render_eval_video(env, policy, generator=None, n_steps: int = 200,
                      width: int = 320, height: int = 240, *, obs_keys):
    """Frames of one deterministic-policy rollout of one env, rendered on
    the host. ``obs_keys`` is the policy's flattening order (a trainer's
    ``obs_keys``); it has no default, because a sorted order silently
    breaks an intention policy's task-first one. -> list of (H, W, 3)
    uint8."""
    from flybody_tpu_torch.utils.rendering import rollout_and_render

    lo, hi = (torch.as_tensor(x, dtype=env.dtype, device=env.device)
              for x in env.action_spec())

    def policy_fn(obs):
        flat = batch_concat(obs, keys=obs_keys, num_batch_dims=1)
        return canonical_to_real(policy(flat).mode(), lo, hi)

    return rollout_and_render(env, policy_fn, generator, n_steps=n_steps,
                              width=width, height=height)


def save_video(frames, path: str, fps: int = 30) -> str:
    """Write frames as a video with imageio where it is installed and has
    a writer for ``path``'s format, else as ``path + ".npz"`` (frames
    (T, H, W, 3) uint8), as the JAX package does. Returns the path
    written."""
    try:
        import imageio
        imageio.mimsave(path, frames, fps=fps)
        return path
    except (ImportError, ValueError, OSError, RuntimeError):
        if os.path.exists(path):     # what a failed writer left
            os.remove(path)
        out = path + ".npz"
        np.savez_compressed(out, frames=np.stack(frames))
        return out
