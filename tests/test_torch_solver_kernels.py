"""The fused dual solve ``solve_rows`` and its stage kernels
``upsolve_build_yd``, ``upsolve_yd`` and ``apgd_iterate``: the port's
plain versions against ``flybody_tpu.ops.solver_kernels`` (``solve_rows``
and ``upsolve_build_yd`` on the CPU run their jnp reference paths,
``upsolve_yd`` and ``apgd_iterate`` run the Pallas kernels in interpret
mode, as tests/test_solver_fused.py runs them), on random inputs and on
inputs captured from a fly state; and ``solve_fused(_stage=...)`` against
the JAX package's. Float64 throughout."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.ops import solver_kernels as JSK
from flybody_tpu.ops import tree_ldl as JTL
from flybody_tpu.physics import solver_fused as JSF
from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env
from flybody_tpu_torch.physics import bridge
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball

from torch_jax_state import close, seeded_state, to_jax, to_port

torch.set_num_threads(2)

# float64, same operations in another summation order: the 20 APGD
# iterations (restart decisions included) agree to ~1e-13 relative
TOL = 1e-9
ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
        "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr", "rreg",
        "active", "mu", "f0", "v0")


def _close(name, got, want):
    close(name, got, want, TOL)


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


def test_random_inputs_walk_imitation_shapes():
    """walk_imitation's shapes: nv 108 on the free-root dof tree (six root
    dofs above every hinge), kl 32, kc 48 (R = 176, the kernel's wide
    instance)."""
    from flybody_tpu_torch.tasks import walk_imitation as WI
    p = SK.random_rows_problem(B=3, seed=2, kl=32, kc=48,
                               parent=WI.load_model()["dof_parentid"])
    tree = TL.build_tree_meta(p["parent"])
    assert tree.nv == 108 and len(TL.flat_up(tree)) == 1105
    ld, dinv = TL.factor(tree, torch.as_tensor(p["Ms"]))
    args = {k: p[k] for k in ARGS if k not in ("ld", "dinv")}
    args.update(ld=ld.numpy(), dinv=dinv.numpy())
    kw = dict(kl=32, kc=48, iterations=20, noslip_iterations=3,
              power_iters=3)
    got, want = _both(p["parent"], args, kw)
    _check(got, want)
    assert SK.solve_rows.launches == 0


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


def test_restart_trace_and_flip(fly_rows):
    """The plain version's restart trace (r, sum |g dz|) per iteration and
    its ``flip`` of one env's decision at one iteration: a mask of no
    flips changes nothing, a flip changes that env alone, and the flipped
    iteration's r is the one the trace gave."""
    parent, args, kw = fly_rows
    tree = TL.build_tree_meta(parent)
    a = {k: torch.as_tensor(v) for k, v in args.items()}
    trace = []
    want = SK.solve_rows_reference(tree, **a, **kw, trace=trace)
    B = a["f0"].shape[1]
    assert len(trace) == kw["iterations"]
    r = torch.cat([t[0] for t in trace])
    s = torch.cat([t[1] for t in trace])
    assert r.shape == s.shape == (kw["iterations"], B)
    assert bool((r.abs() <= s * (1 + 1e-12)).all()) and bool((s > 0).any())
    none = torch.zeros(kw["iterations"], B, dtype=torch.bool)
    same = SK.solve_rows_reference(tree, **a, **kw, flip=none)
    assert all(torch.equal(x, y) for x, y in zip(same, want))
    flip = none.clone()
    flip[3, 1] = True
    trace2 = []
    alt = SK.solve_rows_reference(tree, **a, **kw, flip=flip, trace=trace2)
    assert torch.equal(trace2[3][0], trace[3][0])   # decided on the same r
    for x, y in zip(alt, want):
        assert torch.equal(x[..., 0], y[..., 0])
    assert not torch.equal(alt[0][:, 1], want[0][:, 1])
    assert torch.equal(alt[1], want[1])             # v: no restart in it
    assert SK.solve_rows.launches == 0


# ---- the stage kernels ----------------------------------------------------

ROW_ARGS = ARGS[:14]        # upsolve_build_yd's inputs after the tree
UP_ARGS = ("ld", "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr")
APGD_ARGS = ("rreg", "active", "mu", "f0", "v0")


def _stages_both(parent, args, kw):
    """B3, B4 (on B3's J^T) and B2 (on B3's Yd): JAX (interpret mode / jnp
    path) and the port's wrappers (CPU -> plain versions) on the same
    numpy inputs. Returns {name: (port, jax)}."""
    jtree = JTL.build_tree_meta(parent)
    ptree = TL.build_tree_meta(parent)
    ja = {k: (np.asarray(v) if k == "maskd" else jnp.asarray(v))
          for k, v in args.items()}
    pa = {k: torch.as_tensor(v) for k, v in args.items()}

    def jax_side(a):
        yd, b = JSK.upsolve_build_yd(jtree, *(a[k] for k in ROW_ARGS),
                                     interpret=True)
        jt = JSK.build_jt_reference(*(a[k] for k in ARGS[:6]),
                                    jnp.asarray(a["maskd"]))
        yd4, b4 = JSK.upsolve_yd(jtree, jt, *(a[k] for k in UP_ARGS),
                                 interpret=True)
        f, ystar, v = JSK.apgd_iterate(yd, b, *(a[k] for k in APGD_ARGS),
                                       **kw, interpret=True)
        return dict(yd=yd, b=b, yd4=yd4, b4=b4, f=f, ystar=ystar, v=v)

    want = jax.jit(jax_side)(ja)
    yd, b = SK.upsolve_build_yd(ptree, *(pa[k] for k in ROW_ARGS))
    jt = SK.build_jt_reference(*(pa[k] for k in ARGS[:7]))
    yd4, b4 = SK.upsolve_yd(ptree, jt, *(pa[k] for k in UP_ARGS))
    f, ystar, v = SK.apgd_iterate(yd, b, *(pa[k] for k in APGD_ARGS), **kw)
    got = dict(yd=yd, b=b, yd4=yd4, b4=b4, f=f, ystar=ystar, v=v)
    return {k: (got[k], want[k]) for k in got}


def _check_stages(parent, args, kw):
    before = (SK.upsolve_build_yd.launches, SK.upsolve_yd.launches,
              SK.apgd_iterate.launches)
    for name, (g, w) in _stages_both(parent, args, kw).items():
        _close(name, g, w)
    # CPU tensors never reach the kernels
    assert (SK.upsolve_build_yd.launches, SK.upsolve_yd.launches,
            SK.apgd_iterate.launches) == before == (0, 0, 0)


def test_stage_kernels_random_small():
    """nv 10, kl 8, kc 8 (tests/test_solver_fused.py's sizes)."""
    p = SK.random_rows_problem(B=4, seed=3, nv=10, nbody=5, kl=8, kc=8)
    ld, dinv = TL.factor(TL.build_tree_meta(p["parent"]),
                         torch.as_tensor(p["Ms"]))
    args = {k: p[k] for k in ARGS if k not in ("ld", "dinv")}
    args.update(ld=ld.numpy(), dinv=dinv.numpy())
    _check_stages(p["parent"], args,
                  dict(kl=8, kc=8, iterations=12, noslip_iterations=2,
                       power_iters=4))


def test_stage_kernels_fly_state(fly_rows):
    parent, args, kw = fly_rows
    args = dict(args, v0=args["active"])
    _check_stages(parent, args, kw)


def test_apgd_iterate_matches_solve_rows(fly_rows):
    """B2 on B3's Yd is B1's APGD: the same f (same math, same inputs)."""
    parent, args, kw = fly_rows
    tree = TL.build_tree_meta(parent)
    pa = {k: torch.as_tensor(v) for k, v in args.items()}
    yd, b = SK.upsolve_build_yd(tree, *(pa[k] for k in ROW_ARGS))
    f, _, v = SK.apgd_iterate(yd, b, *(pa.get(k) for k in APGD_ARGS), **kw)
    f1, v1, _, _ = SK.solve_rows(tree, **pa, **kw)
    assert torch.equal(f, f1) and torch.equal(v, v1)


@pytest.fixture(scope="module")
def fused_world():
    """A seeded walk_on_ball state after the smooth stages (the port's,
    float64), in both packages."""
    jm = jax_env(dtype=jnp.float64).model
    pm = bridge.model_from_numpy(bridge.to_numpy(jm))
    pd = F.smooth_forward(pm, to_port(seeded_state(jm, seed=0), pm))
    return jm, pm, pd, to_jax(pd, jm)


@pytest.mark.parametrize("stage", ["assembly", "yd", "apgd", "full"])
def test_solve_fused_stage(fused_world, stage):
    jm, pm, pd, jd = fused_world
    want = jax.jit(lambda m, d: JSF.solve_fused(m, d, _stage=stage))(jm, jd)
    got = SF.solve_fused(pm, pd, _stage=stage)
    _close("qacc", got.qacc, want.qacc)
    if stage != "full":      # a probe adds 0 to the smooth solution
        assert torch.equal(got.qacc, pd.qacc_smooth)
