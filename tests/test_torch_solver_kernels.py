"""The fused dual solve ``solve_rows``: the port's plain version against
``flybody_tpu.ops.solver_kernels.solve_rows`` (which on the CPU runs its
jnp reference path, solver_kernels.py:572-585), on random compact-row
inputs built as tools/check_solve_rows.py builds them and on inputs
captured from a fly state. Float64 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.ops import solver_kernels as JSK
from flybody_tpu.ops import tree_ldl as JTL
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball

torch.set_num_threads(2)

# float64, same operations in another summation order: the 20 APGD
# iterations (restart decisions included) agree to ~1e-13 relative
TOL = 1e-9
ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
        "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr", "rreg",
        "active", "mu", "f0", "v0")


def _close(name, got, want):
    got = got.numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.max(np.abs(want))), 1e-12)
    err = float(np.max(np.abs(got - want)))
    assert err <= TOL * scale, f"{name}: {err:.3e} vs scale {scale:.3e}"


def _both(parent, args, kw):
    """Run the JAX solve_rows (jnp path) and the port's solve_rows (CPU ->
    plain version) on the same numpy inputs."""
    jtree = JTL.build_tree_meta(parent)
    ptree = TL.build_tree_meta(parent)
    jargs = {k: (np.asarray(v) if k == "maskd" else jnp.asarray(v))
             for k, v in args.items()}
    want = jax.jit(lambda a: JSK.solve_rows(jtree, **a, **kw,
                                            interpret=True))(jargs)
    got = SK.solve_rows(ptree, **{k: torch.as_tensor(v)
                                  for k, v in args.items()}, **kw)
    return got, want


def _check(got, want):
    for name, g, w in zip(("f", "v", "qfrc", "dqacc"), got, want):
        _close(name, g, w)


def test_random_inputs():
    p = SK.random_rows_problem(B=3, seed=0)
    ld, dinv = TL.factor(TL.build_tree_meta(p["parent"]),
                         torch.as_tensor(p["Ms"]))
    args = {k: p[k] for k in ARGS if k not in ("ld", "dinv")}
    args.update(ld=ld.numpy(), dinv=dinv.numpy())
    kw = dict(kl=32, kc=40, iterations=20, noslip_iterations=3,
              power_iters=4)
    before = SK.solve_rows.launches
    got, want = _both(p["parent"], args, kw)
    _check(got, want)
    # CPU tensors never reach the kernel
    assert SK.solve_rows.launches == before == 0


@pytest.fixture(scope="module")
def fly_rows():
    """solve_rows inputs assembled from a contact-rich fly state: two
    control steps of walk_on_ball at mid-range actions, then one
    substep's smooth dynamics."""
    env = make_walk_on_ball("cpu", dtype=torch.float64)
    state = env.reset(2)
    lo, hi = env.action_spec()
    act = torch.as_tensor((lo + hi) / 2)[None].expand(2, -1)
    for _ in range(2):
        state = env.autoreset_step(state, act)
    m = env.model
    d = F.smooth_forward(m, state.data)
    prob = SF.assemble(m, d)
    args = {k: v.numpy() for k, v in prob["args"].items() if v is not None}
    return np.asarray(m.dof_parentid), args, prob["kw"]


def test_fly_state_inputs(fly_rows):
    parent, args, kw = fly_rows
    assert args["active"].sum() > 0            # contacts and limits engaged
    assert kw["kl"] == 32 and kw["kc"] == 40   # R = 152 rows
    got, want = _both(parent, args, kw)
    _check(got, want)
    assert SK.solve_rows.launches == 0


def test_fly_state_update_substep_inputs(fly_rows):
    """Same inputs with the update-substep settings (2 power iterations
    from a warm vector)."""
    parent, args, kw = fly_rows
    args = dict(args, v0=np.abs(np.sin(np.arange(152)))[:, None]
                * np.ones((1, args["f0"].shape[1])))
    got, want = _both(parent, args, dict(kw, power_iters=2))
    _check(got, want)
