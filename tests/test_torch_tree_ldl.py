"""The port's tree LDL^T ops against ``flybody_tpu.ops.tree_ldl`` on the
fly's dof tree (float64, inputs from a numpy seed)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from flybody_tpu.ops import tree_ldl as JTL
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.tasks.walk_on_ball import load_model

torch.set_num_threads(2)

B = 3
# same float64 arithmetic in another summation order (index_add per level)
TOL = 1e-12


def _close(got, want, tol=TOL):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.max(np.abs(want))), 1e-300)
    assert float(np.max(np.abs(got - want))) <= tol * scale


@pytest.fixture(scope="module")
def trees():
    parent = load_model()["dof_parentid"]
    jt, pt = JTL.build_tree_meta(parent), TL.build_tree_meta(parent)
    rng = np.random.RandomState(0)
    nv = len(parent)
    # SPD tree-sparse M: a random tree matrix made diagonally dominant
    M = np.zeros((nv, nv, B))
    for i in range(nv):
        for j in jt.anc_lists[i]:
            M[i, j] = M[j, i] = 0.3 * rng.randn(B)
    M[np.arange(nv), np.arange(nv)] = np.abs(M).sum(1) + 1.0 + rng.rand(nv, B)
    Ms = M[jt.entry_i, jt.entry_j]
    return dict(jt=jt, pt=pt, Ms=Ms, rng=rng, nv=nv)


def test_schedule_matches(trees):
    jt, pt = trees["jt"], trees["pt"]
    assert (jt.nv, jt.nM) == (pt.nv, pt.nM) == (105, 586)
    np.testing.assert_array_equal(jt.entry_i, pt.entry_i)
    np.testing.assert_array_equal(jt.entry_j, pt.entry_j)
    assert sum(len(t[0]) for t in pt.solve_up) == 481
    assert len(pt.solve_up) == 14
    for a, b in zip(jt.solve_up + jt.solve_down, pt.solve_up + pt.solve_down):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("op", ["factor", "solve", "solve_multi",
                                "solve_down", "mul_lt", "matmul"])
def test_tree_op(trees, op):
    jt, pt, Ms, rng, nv = (trees[k] for k in ("jt", "pt", "Ms", "rng", "nv"))
    jld, jdinv = JTL.factor(jt, jnp.asarray(Ms))
    ld, dinv = TL.factor(pt, torch.as_tensor(Ms))
    b = rng.randn(nv, B)
    if op == "factor":
        _close(ld, jld)
        _close(dinv, jdinv)
    elif op == "solve":
        _close(TL.solve(pt, ld, dinv, torch.as_tensor(b)),
               JTL.solve(jt, jld, jdinv, jnp.asarray(b)))
    elif op == "solve_multi":                  # (nv, R, B) right-hand sides
        bm = rng.randn(nv, 7, B)
        _close(TL.solve(pt, ld, dinv, torch.as_tensor(bm)),
               JTL.solve(jt, jld, jdinv, jnp.asarray(bm)))
    elif op == "solve_down":
        _close(TL.solve_down(pt, ld, torch.as_tensor(b)),
               JTL.solve_down(jt, jld, jnp.asarray(b)))
    elif op == "mul_lt":
        _close(TL.mul_lt(pt, ld, torch.as_tensor(b)),
               JTL.mul_lt(jt, jld, jnp.asarray(b)))
    else:
        got = TL.matmul(pt, torch.as_tensor(Ms), torch.as_tensor(b))
        _close(got, JTL.matmul(jt, jnp.asarray(Ms), jnp.asarray(b)))
        # and it is M b
        dense = TL.sparse_to_dense(pt, torch.as_tensor(Ms)).numpy()
        _close(got, np.einsum("ijB,jB->iB", dense, b), 1e-12)
