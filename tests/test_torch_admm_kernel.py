"""The ADMM iteration kernel ``admm_iterate``: the port's plain version
against ``flybody_tpu.ops.admm_kernel.admm_iterate`` run as a Pallas
kernel in interpret mode, on random problems. Float32 inputs, the type
the JAX kernel takes and solver_dense passes it; both round W and each
rhs to bf16 and sum the products in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flybody_tpu.ops import admm_kernel as JAK
from flybody_tpu_torch.ops import admm_kernel as AK

torch.set_num_threads(2)

# Both round W and every rhs to bf16 at the same places, but take the
# float32 sums of the bf16 products in another order (~1e-7 relative), and
# now and then that moves a rhs entry across a bf16 rounding boundary (one
# bf16 step, 2^-8 relative). The JAX package's own Pallas kernel and its
# own jnp reference (admm_iterate_reference) differ by up to 4.3e-6 of
# scale on these inputs for that reason, so 1e-6 is tighter than the
# reference agrees with itself: the bound is 2e-5, ~5x that spread.
TOL = 2e-5


def _problem(seed, kl, kc, extra, B=4):
    """A scaled dense dual as solver_dense builds it: W = (A_s + rho I)^-1
    of a random SPD A_s with unit diagonal, rows = kl + 3 kc + extra."""
    rng = np.random.RandomState(seed)
    rows = kl + 3 * kc + extra
    G = rng.randn(B, rows, 2 * rows) / np.sqrt(2 * rows)
    A = G @ G.transpose(0, 2, 1)
    d = 1.0 / np.sqrt(np.einsum("bii->bi", A))
    A = A * d[:, :, None] * d[:, None, :]
    W = np.linalg.inv(A + 10.0 * np.eye(rows)).transpose(1, 2, 0)
    p = dict(W=W, b=rng.randn(rows, B), z0=rng.randn(rows, B),
             mu=rng.rand(kc, B) * 0.8 + 0.2,
             active=(rng.rand(rows, B) > 0.2).astype(np.float64))
    return {k: v.astype(np.float32) for k, v in p.items()}


@pytest.mark.parametrize("kl,kc,extra", [(5, 9, 0), (8, 6, 3)],
                         ids=["rows32", "rows29_tail3"])
def test_admm_iterate_matches_jax(kl, kc, extra):
    """rows 32, and rows 29 (not a multiple of 8: JAX pads to 32) with
    three rows past the cones, which are not projected."""
    p = _problem(seed=kl + kc, kl=kl, kc=kc, extra=extra)
    kw = dict(kl=kl, kc=kc, iterations=20, rho=10.0, alpha=1.9)
    want = np.asarray(JAK.admm_iterate(
        *(jnp.asarray(p[k]) for k in ("W", "b", "z0", "mu", "active")),
        **kw, interpret=True))
    got = AK.admm_iterate(*(torch.as_tensor(p[k]) for k in (
        "W", "b", "z0", "mu", "active")), **kw)
    assert AK.admm_iterate.launches == 0       # CPU: the plain version
    scale = np.abs(want).max()
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * scale, (err, scale)
    # the tail rows pass the projection through (times active)
    assert np.any(want[kl + 3 * kc:] < 0) or extra == 0
