"""DMPO networks: the MLP policy and the distributional critic, and their
vision variants.

* policy: flat obs -> LayerNormMLP(256, 256, 256) -> NormalDiagHead
  (init_scale 0.7, min_scale 1e-6)
* critic: clip the action to [-1, 1], concat with the obs ->
  LayerNormMLP(512, 512, 256) -> Linear logits over 51 atoms in
  [-150, 150]
* vision: the flat obs's two eye images go through VisNetFly (four 3x3
  stride-2 convs, flax's "SAME" padding, and a Linear to 8 features), or
  the rodent's one egocentric camera through VisNetRodent (four 3x3
  "VALID" convs at strides 1, 1, 2, 2, and a Linear to 8 features), whose
  features replace the pixels before the policy's or the critic's MLP
  (reference vnl_ray/agents/vis_net.py:30-202)

Observation dicts flatten in sorted key order (``obs_layout``). The
parameters start as flax's would: ``lecun_normal`` kernels (a normal
truncated at two standard deviations), zero biases, LayerNorm scale 1 and
bias 0, and the policy head's kernels at variance scale 1e-4. Draws come
from a CPU generator in float64 and are cast into the parameters, so one
seed gives the same network on every device and in every dtype.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.agents.distributions import DiscreteValued, NormalDiag

# stddev of a standard normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978
_PHI = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(x)) with no threshold, as jax.nn.softplus computes it
    (torch's softplus returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _truncated_normal(shape, stddev: float,
                      generator: torch.Generator | None) -> torch.Tensor:
    """float64 normal truncated to [-2, 2] standard deviations, times
    ``stddev``, by the inverse CDF of uniforms from ``generator``."""
    lo, hi = _PHI(-2.0), _PHI(2.0)
    u = torch.rand(shape, generator=generator, dtype=torch.float64)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + (hi - lo) * u) - 1.0)
    return x.clamp(-2.0, 2.0) * stddev


@torch.no_grad()
def _dense_init(layer: nn.Linear, scale: float, generator) -> None:
    """flax variance_scaling(scale, "fan_in", "truncated_normal") kernel,
    zero bias."""
    fan_in = layer.weight.shape[1]
    std = math.sqrt(scale / fan_in) / _TRUNC_STD
    layer.weight.copy_(_truncated_normal(layer.weight.shape, std, generator))
    layer.bias.zero_()


@torch.no_grad()
def _conv_init(conv: nn.Conv2d, generator) -> None:
    """flax Conv's default init: lecun_normal over fan_in = kh kw in."""
    fan_in = conv.weight[0].numel()
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    conv.weight.copy_(_truncated_normal(conv.weight.shape, std, generator))
    conv.bias.zero_()


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.utils.skip_init(nn.Linear, n_in, n_out)


def batch_concat(obs: dict, keys: Sequence[str] | None = None,
                 num_batch_dims: int = 0) -> torch.Tensor:
    """Flatten each observation beyond the leading ``num_batch_dims`` axes
    and concatenate, sorted by key. num_batch_dims=-1 concatenates along
    the last axis without flattening (all items the same rank)."""
    keys = sorted(obs.keys()) if keys is None else keys
    parts = []
    for k in keys:
        x = obs[k]
        if num_batch_dims < 0:
            parts.append(x if x.ndim else x[None])
            continue
        if x.ndim <= num_batch_dims:
            x = x[..., None]
        parts.append(x.reshape(tuple(x.shape[:num_batch_dims]) + (-1,)))
    return torch.cat(parts, dim=-1)


def obs_layout(example_obs: dict, task_keys: Sequence[str] = ()):
    """Flat-vector layout of a batched observation dict: (keys, slices),
    keys in concatenation order (task keys first, sorted, then the rest,
    sorted) and slices mapping key -> (start, size, shape), shapes without
    the leading batch axis."""
    present_task = sorted(k for k in example_obs if k in set(task_keys))
    rest = sorted(k for k in example_obs if k not in set(task_keys))
    keys = present_task + rest
    slices = {}
    start = 0
    for k in keys:
        shape = tuple(example_obs[k].shape[1:]) or (1,)
        size = int(np.prod(shape))
        slices[k] = (start, size, shape)
        start += size
    return keys, slices


class LayerNormMLP(nn.Module):
    """Linear -> LayerNorm -> tanh -> [Linear -> elu]* (acme's
    LayerNormMLP; the last elu only with activate_final)."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 activate_final: bool = False, generator=None):
        super().__init__()
        sizes = (in_size,) + tuple(layer_sizes)
        self.linears = nn.ModuleList(
            _linear(a, b) for a, b in zip(sizes[:-1], sizes[1:]))
        self.norm = nn.LayerNorm(layer_sizes[0], eps=1e-6)  # flax's eps
        self.activate_final = activate_final
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        for layer in self.linears:
            _dense_init(layer, 1.0, generator)
        self.norm.reset_parameters()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.tanh(self.norm(self.linears[0](x)))
        last = len(self.linears) - 2
        for i, layer in enumerate(self.linears[1:]):
            x = layer(x)
            if i != last or self.activate_final:
                x = F.elu(x)
        return x


class NormalDiagHead(nn.Module):
    """MultivariateNormalDiagHead (acme): affine mean + softplus stddev."""

    def __init__(self, in_size: int, num_dimensions: int,
                 init_scale: float = 0.7, min_scale: float = 1e-6,
                 generator=None):
        super().__init__()
        self.mean = _linear(in_size, num_dimensions)
        self.scale = _linear(in_size, num_dimensions)
        self.init_scale = init_scale
        self.min_scale = min_scale
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        _dense_init(self.mean, 1e-4, generator)
        _dense_init(self.scale, 1e-4, generator)

    def forward(self, x: torch.Tensor) -> NormalDiag:
        scale = softplus(self.scale(x))
        scale = scale * self.init_scale / math.log(2.0)  # softplus(0)
        return NormalDiag(mean=self.mean(x), stddev=scale + self.min_scale)


class PolicyNetwork(nn.Module):
    """Feed-forward stochastic policy: flat obs -> NormalDiag."""

    def __init__(self, obs_size: int, action_size: int,
                 layer_sizes: Sequence[int] = (256, 256, 256),
                 init_scale: float = 0.7, generator=None):
        super().__init__()
        self.mlp = LayerNormMLP(obs_size, layer_sizes, activate_final=True,
                                generator=generator)
        self.head = NormalDiagHead(layer_sizes[-1], action_size,
                                   init_scale=init_scale, generator=generator)

    def reset_parameters(self, generator=None) -> None:
        self.mlp.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, obs) -> NormalDiag:
        x = obs if isinstance(obs, torch.Tensor) else batch_concat(
            obs, num_batch_dims=-1)
        return self.head(self.mlp(x))


class DistributionalCritic(nn.Module):
    """Critic multiplexer + distributional head (51 atoms in
    [-150, 150])."""

    def __init__(self, obs_size: int, action_size: int,
                 layer_sizes: Sequence[int] = (512, 512, 256),
                 vmin: float = -150.0, vmax: float = 150.0,
                 num_atoms: int = 51, action_clip: tuple | None = (-1.0, 1.0),
                 generator=None):
        super().__init__()
        self.mlp = LayerNormMLP(obs_size + action_size, layer_sizes,
                                activate_final=True, generator=generator)
        self.logits = _linear(layer_sizes[-1], num_atoms)
        self.action_clip = action_clip
        self.vmin, self.vmax, self.num_atoms = vmin, vmax, num_atoms
        _dense_init(self.logits, 1.0, generator)

    def reset_parameters(self, generator=None) -> None:
        self.mlp.reset_parameters(generator)
        _dense_init(self.logits, 1.0, generator)

    def forward(self, obs, action: torch.Tensor) -> DiscreteValued:
        x = obs if isinstance(obs, torch.Tensor) else batch_concat(
            obs, num_batch_dims=-1)
        if self.action_clip is not None:
            action = torch.clamp(action, self.action_clip[0],
                                 self.action_clip[1])
        logits = self.logits(self.mlp(torch.cat([x, action], dim=-1)))
        values = torch.linspace(self.vmin, self.vmax, self.num_atoms,
                                dtype=logits.dtype, device=logits.device)
        return DiscreteValued(logits=logits, values=values)


def _same_pad(size: int, k: int, stride: int) -> tuple:
    """flax/lax "SAME" padding (before, after) of one spatial axis: the
    larger half after (32 -> 16 at stride 2 pads (0, 1))."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


class VisNetFly(nn.Module):
    """Eye-camera conv net (reference vnl_ray/agents/vis_net.py:30-109):
    the left and right eyes stacked as 2 channels, normalized, four 3x3
    stride-2 convs with relu, flattened in flax's (H, W, C) order, then a
    Linear to ``out_features``."""

    CONVS = ((8, 2), (16, 2), (32, 2), (64, 2))

    def __init__(self, eye_shape=(32, 32), out_features: int = 8,
                 norm_mean: float = 77.0, norm_std: float = 56.0,
                 generator=None):
        super().__init__()
        self.norm_mean, self.norm_std = norm_mean, norm_std
        self.eye_shape = tuple(eye_shape)
        convs, pads = [], []
        h, w = self.eye_shape
        c_in = 2
        for c_out, stride in self.CONVS:
            convs.append(nn.utils.skip_init(nn.Conv2d, c_in, c_out, 3,
                                            stride=stride))
            # F.pad's order: (left, right, top, bottom)
            pads.append(_same_pad(w, 3, stride) + _same_pad(h, 3, stride))
            h, w = -(-h // stride), -(-w // stride)
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.pads = tuple(pads)
        self.dense = _linear(c_in * h * w, out_features)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        for conv in self.convs:
            _conv_init(conv, generator)
        _dense_init(self.dense, 1.0, generator)

    def forward(self, left_eye: torch.Tensor,
                right_eye: torch.Tensor) -> torch.Tensor:
        lead = left_eye.shape[:-2]
        x = torch.stack([left_eye, right_eye], dim=-3).reshape(
            (-1, 2) + self.eye_shape)
        x = (x - self.norm_mean) / self.norm_std
        for conv, pad in zip(self.convs, self.pads):
            x = F.relu(conv(F.pad(x, pad)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense(x).reshape(tuple(lead) + (-1,))


class VisNetRodent(nn.Module):
    """Egocentric-camera conv net (reference vnl_ray/agents/vis_net.py:
    112-202): a grayscale camera (an RGB one averaged over its channels
    first), normalized, four 3x3 "VALID" convs with relu, features /
    stride (2, 1) (4, 1) (8, 2) (16, 2), flattened in flax's (H, W, C)
    order, then a Linear to ``out_features``."""

    CONVS = ((2, 1), (4, 1), (8, 2), (16, 2))

    def __init__(self, camera_shape=(32, 32), out_features: int = 8,
                 norm_mean: float = 77.0, norm_std: float = 56.0,
                 generator=None):
        super().__init__()
        self.norm_mean, self.norm_std = norm_mean, norm_std
        self.camera_shape = tuple(camera_shape)
        self.rgb = len(self.camera_shape) == 3 and self.camera_shape[-1] == 3
        h, w = self.camera_shape[:2]
        convs, c_in = [], 1
        for c_out, stride in self.CONVS:
            convs.append(nn.utils.skip_init(nn.Conv2d, c_in, c_out, 3,
                                            stride=stride))
            h, w = (h - 3) // stride + 1, (w - 3) // stride + 1
            c_in = c_out
        self.convs = nn.ModuleList(convs)
        self.dense = _linear(c_in * h * w, out_features)
        self.reset_parameters(generator)

    def reset_parameters(self, generator=None) -> None:
        for conv in self.convs:
            _conv_init(conv, generator)
        _dense_init(self.dense, 1.0, generator)

    def forward(self, camera: torch.Tensor) -> torch.Tensor:
        if self.rgb:
            camera = camera.mean(dim=-1)
        lead = camera.shape[:-2]
        x = camera.reshape((-1, 1) + tuple(camera.shape[-2:]))
        x = (x - self.norm_mean) / self.norm_std
        for conv in self.convs:
            x = F.relu(conv(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.dense(x).reshape(tuple(lead) + (-1,))


def _drop_slices(x: torch.Tensor, spans) -> torch.Tensor:
    """Remove the [start, start + size) spans from the last axis."""
    parts, pos = [], 0
    for s, n in sorted(spans):
        if s > pos:
            parts.append(x[..., pos:s])
        pos = s + n
    if pos < x.shape[-1]:
        parts.append(x[..., pos:])
    return torch.cat(parts, dim=-1)


def _vis_features(vis: nn.Module, eye_slices, obs: torch.Tensor):
    """The image slices of the flat ``obs`` through ``vis`` (two eyes
    through VisNetFly, one camera through VisNetRodent) -> (features, the
    obs without the image slices)."""
    views = [obs[..., s:s + sz].reshape(tuple(obs.shape[:-1]) + tuple(shape))
             for s, sz, shape in eye_slices]
    return vis(*views), _drop_slices(obs, [(s, sz)
                                           for s, sz, _ in eye_slices])


def _check_eyes(eye_slices) -> tuple:
    eye_slices = tuple((int(s), int(sz), tuple(shape))
                       for s, sz, shape in eye_slices)
    if len(eye_slices) not in (1, 2):
        raise ValueError("the vision front-end reads two eyes (VisNetFly) "
                         f"or one camera (VisNetRodent), got "
                         f"{len(eye_slices)} image slices")
    return eye_slices


def _vis_net(eye_slices, vis_features: int, generator) -> nn.Module:
    """VisNetFly for the fly's two eyes, VisNetRodent for one camera."""
    net = VisNetFly if len(eye_slices) == 2 else VisNetRodent
    return net(eye_slices[0][2], vis_features, generator=generator)


class VisionPolicy(nn.Module):
    """Policy with the image front-end: VisNetFly's (two eyes) or
    VisNetRodent's (one camera) features replace the flat observation's
    pixels before the MLP policy."""

    def __init__(self, obs_size: int, action_size: int, eye_slices,
                 layer_sizes: Sequence[int] = (256, 256, 256),
                 vis_features: int = 8, init_scale: float = 0.7,
                 generator=None):
        super().__init__()
        self.eye_slices = _check_eyes(eye_slices)
        rest = obs_size - sum(sz for _, sz, _ in self.eye_slices)
        self.vis = _vis_net(self.eye_slices, vis_features, generator)
        self.mlp = LayerNormMLP(vis_features + rest, layer_sizes,
                                activate_final=True, generator=generator)
        self.head = NormalDiagHead(layer_sizes[-1], action_size,
                                   init_scale=init_scale, generator=generator)

    def reset_parameters(self, generator=None) -> None:
        self.vis.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        self.head.reset_parameters(generator)

    def forward(self, obs: torch.Tensor) -> NormalDiag:
        feat, rest = _vis_features(self.vis, self.eye_slices, obs)
        return self.head(self.mlp(torch.cat([feat, rest], dim=-1)))


class VisionCritic(nn.Module):
    """Distributional critic with the same eye front-end."""

    def __init__(self, obs_size: int, action_size: int, eye_slices,
                 layer_sizes: Sequence[int] = (512, 512, 256),
                 vis_features: int = 8, vmin: float = -150.0,
                 vmax: float = 150.0, num_atoms: int = 51, generator=None):
        super().__init__()
        self.eye_slices = _check_eyes(eye_slices)
        rest = obs_size - sum(sz for _, sz, _ in self.eye_slices)
        self.vis = _vis_net(self.eye_slices, vis_features, generator)
        self.mlp = LayerNormMLP(vis_features + rest + action_size,
                                layer_sizes, activate_final=True,
                                generator=generator)
        self.logits = _linear(layer_sizes[-1], num_atoms)
        self.vmin, self.vmax, self.num_atoms = vmin, vmax, num_atoms
        _dense_init(self.logits, 1.0, generator)

    def reset_parameters(self, generator=None) -> None:
        self.vis.reset_parameters(generator)
        self.mlp.reset_parameters(generator)
        _dense_init(self.logits, 1.0, generator)

    def forward(self, obs: torch.Tensor,
                action: torch.Tensor) -> DiscreteValued:
        feat, rest = _vis_features(self.vis, self.eye_slices, obs)
        h = torch.cat([feat, rest, torch.clamp(action, -1.0, 1.0)], dim=-1)
        logits = self.logits(self.mlp(h))
        values = torch.linspace(self.vmin, self.vmax, self.num_atoms,
                                dtype=logits.dtype, device=logits.device)
        return DiscreteValued(logits=logits, values=values)


def make_policy_critic(action_size: int, obs_size: int,
                       policy_layers=(256, 256, 256),
                       critic_layers=(512, 512, 256),
                       vmin=-150.0, vmax=150.0, num_atoms=51,
                       generator: torch.Generator | None = None):
    """Network factory (reference make_network_factory_dmpo): a freshly
    initialised (policy, critic) pair on the CPU in float32."""
    policy = PolicyNetwork(obs_size, action_size, layer_sizes=policy_layers,
                           generator=generator)
    critic = DistributionalCritic(obs_size, action_size,
                                  layer_sizes=critic_layers, vmin=vmin,
                                  vmax=vmax, num_atoms=num_atoms,
                                  generator=generator)
    return policy, critic
