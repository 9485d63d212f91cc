"""Per-env row gathers and scatter-adds over batch-minor tensors.

The JAX package moves per-env rows with one-hot contractions (a TPU idiom);
here they are plain index gathers and ``index_add_`` scatters over a
flattened (row * B + env) index.
"""

from __future__ import annotations

import torch


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-env row gather: x (n, *C, B), idx (K, B) integer ->
    (K, *C, B) with out[k, ..., b] = x[idx[k, b], ..., b]."""
    n, B = x.shape[0], x.shape[-1]
    mid = x.shape[1:-1]
    K = idx.shape[0]
    flat = x.reshape(n, -1, B).permute(0, 2, 1).reshape(n * B, -1)
    col = torch.arange(B, device=x.device)
    out = flat[(idx.long() * B + col).reshape(-1)]
    return out.reshape(K, B, -1).permute(0, 2, 1).reshape((K,) + mid + (B,))


def take_static(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a batch-free table (n, C) per env: idx (K, B) ->
    (K, C, B)."""
    return table[idx.long()].permute(0, 2, 1)


def add_rows(vals: torch.Tensor, idx: torch.Tensor, n: int):
    """Per-env scatter-add of vals (K, C, B) into (n, C, B) at row ids
    idx (K, B); repeated ids accumulate."""
    K, C, B = vals.shape
    col = torch.arange(B, device=vals.device)
    out = vals.new_zeros((n * B, C))
    out.index_add_(0, (idx.long() * B + col).reshape(-1),
                   vals.permute(0, 2, 1).reshape(K * B, C))
    return out.reshape(n, B, C).permute(0, 2, 1)


def smallest_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Row indices (k, B) of the k smallest values of x (n, B) per env,
    smallest first, ties to the lower index: the order of
    ``jax.lax.top_k(-x.T, k)``."""
    return torch.sort(x, dim=0, stable=True).indices[:k]
