"""Reward shaping primitives (the dm_control.utils.rewards tolerance
family), batched over tensors."""

from __future__ import annotations

import math

import torch

from flybody_tpu_torch.math.consts import literal

_DEFAULT_VALUE_AT_MARGIN = 0.1


def _sigmoid(x, value_at_1: float, sigmoid: str):
    zero = torch.zeros_like(x)
    if sigmoid == "gaussian":
        scale = math.sqrt(-2.0 * math.log(value_at_1))
        return torch.exp(-0.5 * (x * scale) ** 2)
    if sigmoid == "hyperbolic":
        scale = math.acosh(1.0 / value_at_1)
        return 1.0 / torch.cosh(x * scale) ** 2
    if sigmoid == "long_tail":
        scale = math.sqrt(1.0 / value_at_1 - 1.0)
        return 1.0 / ((x * scale) ** 2 + 1.0)
    if sigmoid == "reciprocal":
        scale = 1.0 / value_at_1 - 1.0
        return 1.0 / (torch.abs(x) * scale + 1.0)
    if sigmoid == "cosine":
        scale = math.acos(2.0 * value_at_1 - 1.0) / math.pi
        scaled = torch.abs(x * scale)
        return torch.where(scaled < 1,
                           (1.0 + torch.cos(math.pi * scaled)) / 2.0, zero)
    if sigmoid == "linear":
        scaled = torch.abs(x) * (1.0 - value_at_1)
        return torch.where(scaled < 1, 1.0 - scaled, zero)
    if sigmoid == "quadratic":
        scaled = torch.abs(x) * math.sqrt(1.0 - value_at_1)
        return torch.where(scaled < 1, 1.0 - scaled ** 2, zero)
    if sigmoid == "tanh_squared":
        scale = math.atanh(math.sqrt(1.0 - value_at_1))
        return 1.0 - torch.tanh(x * scale) ** 2
    raise ValueError(f"unknown sigmoid {sigmoid!r}")


def tolerance(x, bounds=(0.0, 0.0), margin=0.0, sigmoid="gaussian",
              value_at_margin=_DEFAULT_VALUE_AT_MARGIN):
    """1 inside ``bounds``, decaying through ``margin`` outside
    (margin may be a tensor; margin == 0 is a hard cutoff)."""
    lower, upper = bounds
    in_bounds = (lower <= x) & (x <= upper)
    margin = (torch.as_tensor(margin, dtype=x.dtype, device=x.device)
              if isinstance(margin, torch.Tensor)
              else literal(margin, x.dtype, x.device))
    d = (torch.where(x < lower, lower - x, x - upper)
         / torch.where(margin == 0, torch.ones_like(margin), margin))
    soft = _sigmoid(d, value_at_margin, sigmoid)
    outside = torch.where(margin == 0, torch.zeros_like(soft), soft)
    return torch.where(in_bounds, torch.ones_like(outside), outside)
