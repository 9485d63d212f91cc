"""The reference-pose tracking rewards, batched over envs.

The JAX package's ``tasks/tracking_rewards.py`` (reference
vnl_ray/tasks/rewards.py:181-319 and tracking_rewards.py:86-179):

* ``termination_reward``: 1 - err / threshold;
* ``multi_term_pose_reward``: exponentiated squared feature differences
  over appendages, body quaternions, centre of mass and joint velocities,
  in the rodent tuning (exponents -400, -2, -100, -0.1, unit weights) or
  the fly / dm_control tuning (-40, -2, -10, -1 with weights 0.15, 0.65,
  1, 0.1);
* ``comic``: 0.5 termination / 5 + 0.5 multi-term (Hasenclever et al.,
  CoMic, ICML 2020).

Every feature is batch-leading, (B, ...); each function returns
``(reward (B,), channels)``, the channels an OrderedDict of each term's
contribution (B,).
"""

from __future__ import annotations

import collections

import torch


def bounded_quat_dist(source: torch.Tensor,
                      target: torch.Tensor) -> torch.Tensor:
    """Quaternion distance bounded to pi / 2, (..., 1) (reference
    rewards.py:136-158)."""
    source = source / torch.linalg.vector_norm(source, dim=-1, keepdim=True)
    target = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
    dist = 2.0 * torch.sum(source * target, dim=-1) ** 2 - 1.0
    dist = torch.clamp(dist, max=1.0)
    return 0.5 * torch.arccos(dist)[..., None]


def _per_env_sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def compute_squared_differences(walker_features: dict,
                                reference_features: dict,
                                exclude_keys=()) -> dict:
    """Each feature's squared difference summed per env, (B,); the
    quaternion keys by ``bounded_quat_dist``."""
    out = {}
    for k, w in walker_features.items():
        if k in exclude_keys:
            continue
        r = reference_features[k]
        d = bounded_quat_dist(w, r) if "quaternion" in k else w - r
        out[k] = _per_env_sum(d ** 2)
    return out


def termination_reward_fn(termination_error, termination_error_threshold,
                          scale: float = 1.0, **unused):
    r = 1.0 - termination_error / termination_error_threshold / scale
    return r, collections.OrderedDict(termination=r)


def multi_term_pose_reward_fn(walker_features, reference_features,
                              tuning: str = "rodent", **unused):
    d = compute_squared_differences(walker_features, reference_features)
    if tuning == "rodent":
        terms = collections.OrderedDict(
            appendages=torch.exp(-400.0 * d["appendages"]),
            body_quaternions=torch.exp(-2.0 * d["body_quaternions"]),
            center_of_mass=torch.exp(-100.0 * d["center_of_mass"]),
            joints_velocity=torch.exp(-0.1 * d["joints_velocity"]),
        )
    else:  # the fly / dm_control tuning (reference rewards.py:221-226)
        terms = collections.OrderedDict(
            appendages=0.15 * torch.exp(-40.0 * d["appendages"]),
            body_quaternions=0.65 * torch.exp(-2.0 * d["body_quaternions"]),
            center_of_mass=1.0 * torch.exp(-10.0 * d["center_of_mass"]),
            joints_velocity=0.1 * torch.exp(-d["joints_velocity"]),
        )
    return sum(terms.values()), terms


def comic_reward_fn(termination_error, termination_error_threshold,
                    walker_features, reference_features,
                    tuning: str = "rodent", **unused):
    term_r, term_ch = termination_reward_fn(
        termination_error, termination_error_threshold)
    mt_r, mt_ch = multi_term_pose_reward_fn(
        walker_features, reference_features, tuning=tuning)
    channels = collections.OrderedDict(
        (k, 0.5 * v / 5.0) for k, v in term_ch.items())
    channels.update((k, 0.5 * v) for k, v in mt_ch.items())
    return 0.5 * term_r / 5.0 + 0.5 * mt_r, channels


_REWARD_FN = {
    "termination_reward": termination_reward_fn,
    "multi_term_pose_reward": multi_term_pose_reward_fn,
    "comic": comic_reward_fn,
}

_REWARD_CHANNELS = {
    "termination_reward": ("termination",),
    "multi_term_pose_reward": (
        "appendages", "body_quaternions", "center_of_mass",
        "joints_velocity"),
    "comic": (
        "appendages", "body_quaternions", "center_of_mass", "termination",
        "joints_velocity"),
}


def get_reward(reward_key: str):
    if reward_key not in _REWARD_FN:
        raise ValueError(f"unknown reward {reward_key!r}")
    return _REWARD_FN[reward_key]


def get_reward_channels(reward_key: str):
    if reward_key not in _REWARD_CHANNELS:
        raise ValueError(f"unknown reward {reward_key!r}")
    return _REWARD_CHANNELS[reward_key]
