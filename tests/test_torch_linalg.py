"""Batched blocked Cholesky of the dense ADMM solver: the port's
``ops/linalg.py`` against ``flybody_tpu.ops.linalg`` on random SPD batches
and on a rank-deficient matrix that hits the pivot floor. Float64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flybody_tpu.ops import linalg as JLA
from flybody_tpu_torch.ops import linalg as LA

torch.set_num_threads(2)

# the same column loop and substitutions in another summation order
TOL = 1e-10


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * max(np.abs(want).max(), 1e-300), err


def _spd(rng, B, n):
    G = rng.randn(B, n, n + 4)
    A = G @ G.transpose(0, 2, 1)
    s = np.exp(rng.randn(B, n))          # diagonal spread, as in physics
    return A * s[:, :, None] * s[:, None, :]


@pytest.mark.parametrize("n", [20, 45, 64], ids=["unblocked", "padded",
                                                 "blocked"])
def test_cho_factor_solve_random_spd(n):
    rng = np.random.RandomState(n)
    A = _spd(rng, 3, n)
    b = rng.randn(3, n)
    bm = rng.randn(3, n, 5)
    Ls, s = LA.cho_factor(torch.as_tensor(A))
    jLs, js = JLA.cho_factor(jnp.asarray(A))
    _close(Ls, jLs)
    _close(s, js)
    _close(LA.cho_solve((Ls, s), torch.as_tensor(b)),
           JLA.cho_solve((jLs, js), jnp.asarray(b)))
    _close(LA.cho_solve((Ls, s), torch.as_tensor(bm)),
           JLA.cho_solve((jLs, js), jnp.asarray(bm)))
    _close(LA.cholesky(torch.as_tensor(A)), JLA.cholesky(jnp.asarray(A)))


def test_cho_factor_rank_deficient_pivot_floor():
    """A rank-4 6x6 matrix: two pivots fall under the floor and keep only
    their floored diagonal, so the solve stays finite (a plain Cholesky
    gives NaN here)."""
    rng = np.random.RandomState(7)
    G = rng.randn(6, 4)
    A = (G @ G.T)[None]
    b = rng.randn(1, 6)
    Ls, s = LA.cho_factor(torch.as_tensor(A))
    jLs, js = JLA.cho_factor(jnp.asarray(A))
    _close(Ls, jLs)
    x = LA.cho_solve((Ls, s), torch.as_tensor(b))
    _close(x, JLA.cho_solve((jLs, js), jnp.asarray(b)))
    assert torch.isfinite(x).all()
    # the floor was hit: some pivot is exactly sqrt(1e-14)
    assert np.isclose(torch.diagonal(Ls[0]).min().item(), 1e-7)
