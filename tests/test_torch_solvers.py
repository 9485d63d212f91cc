"""The non-fused contact solvers of the port against the JAX package:
``make_efc`` and ``constraint.solve`` with contact_solver "apgd" and
"admm" on walk_on_ball at its shipped budgets, and "admm_kernel" on
wob-admm (walk_on_ball with the contact budgets cut to the trained gait's
measured maxima, so the dense system has 226 rows and the ADMM kernel's
path runs). One seeded state (B=2, float64) after the port's smooth
stages, handed to both packages."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import io_mj as jio
from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env
from flybody_tpu_torch.ops import admm_kernel as AK
from flybody_tpu_torch.physics import bridge
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import solver_dense as SD

from torch_jax_state import (WOB_ADMM_KW, close as _close, seeded_state,
                             to_jax, to_port)

torch.set_num_threads(2)

# float64, the same operations in another summation order (~1e-12) for
# the row assembly; the solvers iterate on top, which can amplify rounding
TOL = 1e-8
TOL_SOLVE = 1e-6


def _world(**put_kw):
    env = jax_env(dtype=jnp.float64)
    jm = (jio.put_model(env.mj_model, dtype=jnp.float64, **put_kw)
          if put_kw else env.model)
    pm = bridge.model_from_numpy(bridge.to_numpy(jm))
    pd = F.smooth_forward(pm, to_port(seeded_state(jm, seed=0), pm))
    return jm, pm, pd, to_jax(pd, jm)


@pytest.fixture(scope="module")
def shipped():
    return _world()


@pytest.fixture(scope="module")
def wob_admm():
    return _world(**WOB_ADMM_KW)


def _with_solver(jm, pm, solver):
    return (jm.replace(opt=jm.opt.replace(contact_solver=solver)),
            pm.replace(opt=pm.opt.replace(contact_solver=solver)))


def test_make_efc(shipped):
    jm, pm, pd, jd = shipped
    jlim, jgroups = jax.jit(JC.make_efc)(jm, jd)
    lim, groups = C.make_efc(pm, pd)
    for n in ("sign", "aref", "R", "active", "diag", "pos", "k", "b"):
        _close("lim." + n, getattr(lim, n), getattr(jlim, n), TOL)
    assert [(g.condim, g.K) for g in groups] == \
        [(g.condim, g.K) for g in jgroups]
    assert float(sum(g.active.sum() for g in groups)) > 0
    for n in ("jac", "aref", "R", "mu", "active", "diag"):
        # one scale per field over all groups: a group of far-apart
        # contacts holds values near zero
        scale = max(float(np.max(np.abs(np.asarray(getattr(jg, n)))))
                    for jg in jgroups)
        for i, (g, jg) in enumerate(zip(groups, jgroups)):
            _close(f"group{i}.{n}", getattr(g, n), getattr(jg, n), TOL,
                   scale)
    for g, jg in zip(groups, jgroups):
        np.testing.assert_array_equal(g.sel.numpy(), np.asarray(jg.sel))


def _check_solve(jm, pm, pd, jd):
    want = jax.jit(JC.solve)(jm, jd)
    got = C.solve(pm, pd)
    for n in ("qacc", "qfrc_constraint", "warm_f", "warm_lim"):
        _close(n, getattr(got, n), getattr(want, n), TOL_SOLVE)
    np.testing.assert_array_equal(got.warm_sel.numpy(),
                                  np.asarray(want.warm_sel))


@pytest.mark.parametrize("solver", ["apgd", "admm"])
def test_solve_shipped_budgets(shipped, solver):
    jm, pm, pd, jd = shipped
    _check_solve(*_with_solver(jm, pm, solver), pd, jd)


def test_option_default_is_apgd():
    """The port's Option default is the JAX package's: "apgd"."""
    from flybody_tpu.physics.types import Option as JOption
    from flybody_tpu_torch.physics.types import Option
    default = lambda cls: cls.__dataclass_fields__["contact_solver"].default
    assert default(Option) == default(JOption) == "apgd"


def test_admm_kernel_on_wob_admm(wob_admm):
    """The ADMM kernel's path: 226 rows, kl 40, kc 62; on the CPU the
    wrapper runs the plain version (no launch)."""
    jm, pm, pd, jd = wob_admm
    assert pm.opt.contact_solver == "admm_kernel"
    lim, groups = C.make_efc(pm, pd)
    ls = SD._LimSel(pm, lim, SD.LIMIT_ACTIVE)
    rows = SD._gather_rows(ls, groups, pd)[0].shape[0]
    assert rows == 226
    assert SD.kernel_layout(ls, groups, rows)[:3] == (True, 40, 62)
    before = AK.admm_iterate.launches
    _check_solve(jm, pm, pd, jd)
    assert AK.admm_iterate.launches == before == 0
