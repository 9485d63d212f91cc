"""Batched dense Cholesky factorization and triangular solves, blocked, in
plain PyTorch.

The dense ADMM solver factors (A_s + rho I) once per substep for every env
(physics/solver_dense.py). Diagonal blocks (32 wide) are factored by a
column loop of rank-1 updates, panels by short substitution loops, and the
trailing update is one batched matrix product per panel.

The pivot floor is part of the function: a pivot at or below 1e-6 in
float32 (1e-14 in float64) keeps only its floored diagonal entry, so a
rank-deficient direction is regularized instead of producing inf or NaN
(``torch.linalg.cholesky`` raises or returns NaN there).

All functions take (..., n, n) / (..., n) tensors with any leading batch
dims.
"""

from __future__ import annotations

import torch


def _unblocked_cholesky(A: torch.Tensor) -> torch.Tensor:
    """Cholesky of (..., r, r) by an r-step outer-product loop (r small).

    Callers feed Jacobi-scaled (unit-diagonal) matrices, so pivots of a
    well-posed SPD input lie in (0, 1]; a pivot at or below the floor keeps
    only its floored diagonal entry."""
    r = A.shape[-1]
    L = torch.zeros_like(A)
    S = A
    floor = 1e-6 if A.dtype == torch.float32 else 1e-14
    ar = torch.arange(r, device=A.device)
    for j in range(r):
        sjj = S[..., j, j]
        ok = sjj > floor
        d = torch.sqrt(torch.clamp(sjj, min=floor))
        col = S[..., :, j] / d[..., None]
        mask = (ar >= j).to(A.dtype)
        diag_only = (ar == j).to(A.dtype)
        col = torch.where(ok[..., None], col * mask,
                          d[..., None] * diag_only)
        L[..., :, j] = col
        S = S - col[..., :, None] * col[..., None, :]
    return L


def _solve_tri_small(L: torch.Tensor, B: torch.Tensor,
                     lower: bool = True) -> torch.Tensor:
    """Solve L X = B for (..., r, r) triangular L, (..., r, m) B, by
    r-step substitution (upper when ``lower`` is False)."""
    r = L.shape[-1]
    X = torch.zeros_like(B)
    for j in (range(r) if lower else reversed(range(r))):
        acc = torch.einsum("...k,...km->...m", L[..., j, :], X)
        X[..., j, :] = (B[..., j, :] - acc) / L[..., j, j][..., None]
    return X


def _cholesky_scaled(A: torch.Tensor, block: int = 32) -> torch.Tensor:
    n = A.shape[-1]
    if n <= block:
        return _unblocked_cholesky(A)
    nb = -(-n // block)
    pad = nb * block - n
    if pad:
        # pad with the identity to keep the matrix SPD
        Ap = A.new_zeros(A.shape[:-2] + (n + pad, n + pad))
        Ap[..., :n, :n] = A
        Ap[..., n:, n:] = torch.eye(pad, dtype=A.dtype, device=A.device)
        A = Ap
    N = nb * block
    L = torch.zeros_like(A)
    S = A.clone()
    for k in range(nb):
        a, b = k * block, (k + 1) * block
        Lkk = _unblocked_cholesky(S[..., a:b, a:b])
        L[..., a:b, a:b] = Lkk
        if b < N:
            # panel: X = S[b:, a:b] Lkk^-T
            panel = _solve_tri_small(Lkk, S[..., b:, a:b].transpose(-1, -2))
            P = panel.transpose(-1, -2)               # (..., N-b, block)
            L[..., b:, a:b] = P
            S[..., b:, b:] -= torch.einsum("...ik,...jk->...ij", P, P)
    return L[..., :n, :n] if pad else L


def cho_factor(A: torch.Tensor, block: int = 32):
    """Jacobi-scaled Cholesky factorization of SPD (..., n, n).

    Returns (Ls, s) with A = S^-1 Ls Ls' S^-1, S = diag(s); factoring and
    solving in the unit-diagonal space S A S keeps float32 stable when the
    diagonal spans many decades. Use ``cho_solve((Ls, s), b)``."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    s = torch.rsqrt(torch.clamp(diag, min=1e-30))
    As = A * s[..., :, None] * s[..., None, :]
    return _cholesky_scaled(As, block=block), s


def cholesky(A: torch.Tensor, block: int = 32) -> torch.Tensor:
    """Plain lower Cholesky factor (with the pivot floor of cho_factor)."""
    Ls, s = cho_factor(A, block=block)
    return Ls / s[..., :, None]


def solve_lower(L: torch.Tensor, b: torch.Tensor,
                block: int = 32) -> torch.Tensor:
    """Solve L x = b with lower-triangular L; b is (..., n) or (..., n, m)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for k in range(-(-n // block)):
        a, e = k * block, min((k + 1) * block, n)
        rhs = b[..., a:e, :]
        if a:
            rhs = rhs - torch.einsum("...ij,...jm->...im", L[..., a:e, :a],
                                     x[..., :a, :])
        x[..., a:e, :] = _solve_tri_small(L[..., a:e, a:e], rhs)
    return x[..., 0] if vec else x


def solve_upper_t(L: torch.Tensor, b: torch.Tensor,
                  block: int = 32) -> torch.Tensor:
    """Solve L^T x = b with lower-triangular L (back substitution)."""
    vec = b.ndim == L.ndim - 1
    if vec:
        b = b[..., None]
    n = L.shape[-1]
    x = torch.zeros_like(b)
    for k in reversed(range(-(-n // block))):
        a, e = k * block, min((k + 1) * block, n)
        rhs = b[..., a:e, :]
        if e < n:
            rhs = rhs - torch.einsum("...ji,...jm->...im", L[..., e:, a:e],
                                     x[..., e:, :])
        x[..., a:e, :] = _solve_tri_small(
            L[..., a:e, a:e].transpose(-1, -2), rhs, lower=False)
    return x[..., 0] if vec else x


def cho_solve(factor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b. ``factor`` is (Ls, s) from ``cho_factor`` (scaled-
    space solve) or a plain lower factor L from ``cholesky``."""
    if isinstance(factor, tuple):
        Ls, s = factor
        vec = b.ndim == Ls.ndim - 1
        sc = s if vec else s[..., None]
        return sc * solve_upper_t(Ls, solve_lower(Ls, sc * b))
    return solve_upper_t(factor, solve_lower(factor, b))
