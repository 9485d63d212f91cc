"""Hierarchical intention (encoder-decoder) policy networks.

The flat observation is split into a task prefix and an egocentric suffix
(task keys first, each group alphabetical: ``networks.obs_layout`` with
task keys). A stochastic encoder maps the task features to a latent
"intention", optionally through a two-level stack (MLP -> high-level head
-> sample -> MLP -> head); a decoder maps [intention, egocentric obs] to
the action distribution, a Gaussian of fixed scale. For skill reuse and
transfer the decoder is restored from a donor and frozen while new
encoders train (reference learning_dmpo.py:236-243).

Sampling: ``with_intention(obs, generator)`` draws the latent (both
latents of the two-level encoder, high level first) from ``generator``,
the actor path; without a generator the mean is decoded, the learner path
and the target policy.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from flybody_tpu_torch.agents.distributions import NormalDiag
from flybody_tpu_torch.agents.networks import (LayerNormMLP, NormalDiagHead,
                                               _dense_init, _linear,
                                               batch_concat)


def separate_observation(obs: dict, task_keys: Sequence[str]):
    """[task obs || egocentric obs] of a batched obs dict, task keys first,
    each group alphabetical -> (flat (B, n), task_size)."""
    task = sorted(k for k in obs if k in set(task_keys))
    ego = sorted(k for k in obs if k not in set(task_keys))
    flat = batch_concat(obs, keys=task + ego, num_batch_dims=1)
    task_size = sum(obs[k][0].numel() for k in task)
    return flat, task_size


class Encoder(nn.Module):
    """Stochastic intention encoder, one or two levels. The heads keep a
    stddev floor of 1e-4 (not NormalDiagHead's 1e-6)."""

    def __init__(self, in_size: int, intention_size: int = 60,
                 layer_sizes: Sequence[int] = (512, 512),
                 high_level_intention_size: int | None = None,
                 min_scale: float = 1e-4, generator=None):
        super().__init__()
        self.two_level = high_level_intention_size is not None
        if self.two_level:
            self.high_mlp = LayerNormMLP(in_size, layer_sizes,
                                         activate_final=True,
                                         generator=generator)
            self.high_head = NormalDiagHead(
                layer_sizes[-1], high_level_intention_size,
                min_scale=min_scale, generator=generator)
            in_size = high_level_intention_size
        self.mlp = LayerNormMLP(in_size, layer_sizes, activate_final=True,
                                generator=generator)
        self.head = NormalDiagHead(layer_sizes[-1], intention_size,
                                   min_scale=min_scale, generator=generator)

    def reset_parameters(self, generator=None) -> None:
        for m in ((self.high_mlp, self.high_head) if self.two_level
                  else ()) + (self.mlp, self.head):
            m.reset_parameters(generator)

    def forward(self, task_obs: torch.Tensor, draw=None) -> NormalDiag:
        """The intention distribution. ``draw(dist)`` samples the
        high-level latent that the mid level reads; without it the
        high-level mean is read."""
        x = task_obs
        if self.two_level:
            hl = self.high_head(self.high_mlp(x))
            x = hl.mean if draw is None else draw(hl)
        return self.head(self.mlp(x))


class Decoder(nn.Module):
    """LayerNormMLP trunk and a mean head whose kernel starts at variance
    scale 1e-4; the stddev is the constant ``action_stddev``."""

    def __init__(self, in_size: int, action_size: int,
                 layer_sizes: Sequence[int] = (512, 512, 512),
                 action_stddev: float = 0.1, generator=None):
        super().__init__()
        self.mlp = LayerNormMLP(in_size, layer_sizes, activate_final=True,
                                generator=generator)
        self.mean = _linear(layer_sizes[-1], action_size)
        self.action_stddev = action_stddev
        _dense_init(self.mean, 1e-4, generator)

    def reset_parameters(self, generator=None) -> None:
        self.mlp.reset_parameters(generator)
        _dense_init(self.mean, 1e-4, generator)

    def forward(self, z_and_ego: torch.Tensor) -> NormalDiag:
        mean = self.mean(self.mlp(z_and_ego))
        return NormalDiag(mean=mean,
                          stddev=torch.full_like(mean, self.action_stddev))


class IntentionPolicy(nn.Module):
    """Encoder-decoder policy over a flat [task || ego] observation.

    ``forward(obs)`` is the action distribution decoded from the mean
    intention (with the decoder's fixed scale), the distribution MPO's
    losses and the target policy read."""

    def __init__(self, obs_size: int, action_size: int, task_obs_size: int,
                 intention_size: int = 60,
                 encoder_layers: Sequence[int] = (512, 512),
                 decoder_layers: Sequence[int] = (512, 512, 512),
                 high_level_intention_size: int | None = None,
                 action_stddev: float = 0.1, generator=None):
        super().__init__()
        self.task_obs_size = task_obs_size
        self.encoder = Encoder(task_obs_size, intention_size,
                               encoder_layers, high_level_intention_size,
                               generator=generator)
        self.decoder = Decoder(intention_size + obs_size - task_obs_size,
                               action_size, decoder_layers, action_stddev,
                               generator=generator)

    def reset_parameters(self, generator=None) -> None:
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> NormalDiag:
        return self.with_intention(obs)[0]

    def with_intention(self, obs: torch.Tensor, generator=None, eps=None):
        """-> (action dist, intention dist). With ``generator`` the latents
        are sampled from it, the high-level one first; ``eps`` gives their
        standard normals instead (a sequence in the same order). Without
        either the mean intention is decoded."""
        draw = None
        if generator is not None or eps is not None:
            normals = iter(eps) if eps is not None else None

            def draw(dist: NormalDiag) -> torch.Tensor:
                if normals is None:
                    return dist.sample(generator)
                return dist.transform(next(normals))

        intention = self.encoder(obs[..., :self.task_obs_size], draw)
        z = intention.mean if draw is None else draw(intention)
        ego = obs[..., self.task_obs_size:]
        return self.decoder(torch.cat([z, ego], dim=-1)), intention


def decoder_param_filter(state_dict: dict):
    """Split a policy's state_dict into (decoder, rest) for decoder-only
    restore and freeze (reference transfer mode,
    train_config_bowl_transfer.yaml)."""
    dec = {k: v for k, v in state_dict.items() if "decoder" in k}
    return dec, {k: v for k, v in state_dict.items() if k not in dec}


def freeze_decoder(policy: IntentionPolicy) -> IntentionPolicy:
    """Freeze the decoder for transfer: its parameters stop requiring
    gradients, so they get none. The JAX package instead zeroes their
    gradients ahead of clip_by_global_norm -> adam (freeze_decoder_tx);
    the result is the same: zeros add nothing to the global norm that the
    encoder's gradients are clipped by, and Adam's update of a parameter
    whose gradients are all zero is zero, as is torch.optim.Adam's of one
    with no gradient, which it skips."""
    policy.decoder.requires_grad_(False)
    return policy
