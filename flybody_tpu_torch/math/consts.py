"""Literal constants on a device, copied there from the host once.

    ex = consts.literal((1.0, 0.0, 0.0), x.dtype, x.device)

A tensor built from host values in every call (``torch.tensor``,
``new_tensor``, ``as_tensor`` of a number or a list) is copied to the
device each time, and the copy waits for the device; a CUDA graph's
capture refuses it. ``literal`` keeps one copy per (values, dtype,
device). The tensor it returns is shared: never write it in place.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def literal(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, built once;
    ``values`` a number or nested tuples of numbers."""
    return torch.tensor(values, dtype=dtype, device=device)
