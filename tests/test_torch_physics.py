"""Stage-by-stage parity of the PyTorch port's physics with the JAX package.

One JAX-built walk_on_ball state (float64, B=2, made from a numpy seed) is
passed through ``flybody_tpu_torch.physics.bridge``; each port stage gets
the JAX input of that stage and is held against the JAX output. Then one
full fresh substep and, from a perturbed copy of its result, one
selection-persistent update substep. Single steps only: the resting
self-contact cluster is chaotic, so long trajectories are never compared.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.physics import actuation as JA
from flybody_tpu.physics import collision as JCOL
from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import forward as JF
from flybody_tpu.physics import kinematics as JK
from flybody_tpu.physics import passive as JP
from flybody_tpu.physics import sensors as JS
from flybody_tpu.physics import smooth as JSM
from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env

from flybody_tpu_torch.physics import actuation as A
from flybody_tpu_torch.physics import bridge
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import sensors as S
from flybody_tpu_torch.physics import smooth as SM

from torch_jax_state import close as _close, seeded_state, to_port

torch.set_num_threads(2)

B = 2
# float64 on both sides; the stages are the same arithmetic in another
# summation order, so results agree to ~1e-12 relative. The solve runs 20
# APGD iterations + 6 noslip sweeps on top, which can amplify rounding.
TOL = 1e-8
TOL_SOLVE = 1e-6
# the convex narrowphase is an iterative minimization (BB-step PGD, then
# accept-if-better Newton steps), which amplifies last-bit differences
TOL_CCD = 1e-6


def _fields(td, jd, names, tol=TOL):
    for n in names:
        _close(n, getattr(td, n), getattr(jd, n), tol)


# the stages of one fresh JAX substep (JF.step), in order
_CHAIN = (("kinematics", JK.kinematics), ("com_pos", JK.com_pos),
          ("tendon", JK.tendon), ("crb", JSM.crb),
          ("collision", JCOL.collision), ("transmission", JSM.transmission),
          ("com_vel", JSM.com_vel), ("passive", JP.passive),
          ("rne", JSM.rne), ("act_dynamics", JA.act_dynamics),
          ("actuation", JA.actuation),
          ("acceleration", JF.fwd_acceleration),
          ("solve", JC.solve), ("sensor", JS.sensor), ("euler", JF.euler))


def _jax_chain(m, d):
    """Every stage's output Data of one fresh JAX substep."""
    out = []
    for _, fn in _CHAIN:
        d = fn(m, d)
        out.append(d)
    return tuple(out)


@pytest.fixture(scope="module")
def world():
    env = jax_env(dtype=jnp.float64)
    jm = env.model
    pm = bridge.model_from_numpy(bridge.to_numpy(jm))
    jd0 = seeded_state(jm, seed=0)
    chain = list(zip([n for n, _ in _CHAIN], jax.jit(_jax_chain)(jm, jd0)))
    # update substep: from the fresh substep's result, perturbed so that a
    # fresh selection would differ from the stored one
    rng = np.random.RandomState(1)
    jd1 = chain[-1][1]
    jd1p = jd1.replace(qvel=jd1.qvel + 0.5 * rng.randn(*jd1.qvel.shape),
                       qpos=jd1.qpos.at[np.asarray(jm.jnt_qposadr)[
                           np.asarray(jm.jnt_type) == 3]].add(
                           0.02 * rng.randn(
                               int((np.asarray(jm.jnt_type) == 3).sum()),
                               B)))
    jd2 = jax.jit(functools.partial(JF.step, col_update=True))(jm, jd1p)
    return dict(jm=jm, pm=pm, jd0=jd0, chain=dict(chain),
                order=[n for n, _ in chain], jd1p=jd1p, jd2=jd2)


def _port(world, jd):
    return to_port(jd, world["pm"])


def _stage_io(world, name):
    """(JAX input Data, JAX output Data) of one stage."""
    order = world["order"]
    i = order.index(name)
    jin = world["jd0"] if i == 0 else world["chain"][order[i - 1]]
    return jin, world["chain"][name]


def test_model_bridge_matches_committed_model(world):
    """The bridged JAX model and the port's own build from the committed
    asset agree on every static table and numeric parameter."""
    from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball
    own = make_walk_on_ball("cpu", dtype=torch.float64).model
    pm = world["pm"]
    from flybody_tpu_torch.physics import types as T
    for n in T.MODEL_TENSORS:
        _close(n, getattr(own, n), getattr(pm, n), 1e-12)
    for n in ("pair_geom1", "pair_geom2", "con_dim", "ccd_geom1",
              "ccd_geom2", "body_dof_mask", "sensor_type", "sensor_adr"):
        np.testing.assert_array_equal(getattr(own, n), getattr(pm, n))
    assert own.ccd_classes == pm.ccd_classes
    assert own.ncon_max == pm.ncon_max and own.nccd == pm.nccd


@pytest.mark.parametrize("name,fn,fields", [
    ("kinematics", K.kinematics,
     ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
      "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")),
    ("com_pos", K.com_pos, ("subtree_com", "cinert", "cdof")),
    ("tendon", K.tendon, ("ten_length",)),
    ("crb", SM.crb, ("qM", "qLD", "qLDiagInv", "qLDh", "qLDiagInvh")),
    ("transmission", SM.transmission,
     ("actuator_length", "actuator_velocity", "ten_velocity")),
    ("com_vel", SM.com_vel, ("cvel", "cdof_dot")),
    ("passive", P.passive, ("qfrc_passive", "qfrc_fluid")),
    ("rne", SM.rne, ("qfrc_bias",)),
    ("act_dynamics", A.act_dynamics, ("act_dot",)),
    ("actuation", A.actuation, ("actuator_force", "qfrc_actuator")),
    ("acceleration", F.fwd_acceleration, ("qfrc_smooth", "qacc_smooth")),
    ("sensor", S.sensor, ("sensordata",)),
    ("euler", F.euler, ("qpos", "qvel", "act", "time")),
])
def test_stage(world, name, fn, fields):
    jin, jout = _stage_io(world, name)
    _fields(fn(world["pm"], _port(world, jin)), jout, fields)


def test_collision_selection(world):
    """Selected contacts by slot id (``sel``) and their geometry and
    impedance; the state has penetrating contacts."""
    jin, jout = _stage_io(world, "collision")
    got = COL.collision(world["pm"], _port(world, jin))
    jc = jout.contact
    assert float(np.min(np.asarray(jc.dist))) < 0.0
    np.testing.assert_array_equal(got.contact.sel.numpy(), np.asarray(jc.sel))
    for n in ("dist", "pos", "frame", "k", "b", "R", "mu", "invw",
              "margin", "marginfull", "b1", "b2", "g1", "g2", "typ", "sub",
              "solref", "solimp"):
        _close("contact." + n, getattr(got.contact, n), getattr(jc, n),
               TOL_CCD)
    _fields(got, jout, ("ccd_warm_id", "ccd_warm_u", "ccd_lane_tab"),
            TOL_CCD)


def test_fluid_ellipsoid_terms(world):
    """The ellipsoid fluid model (off on walk_on_ball's geoms) on three
    geoms switched on with nonzero coefficients."""
    jin, _ = _stage_io(world, "passive")
    jm = world["jm"]
    gids = np.array([3, 10, 20])
    fluid = np.zeros((jm.ngeom, 12))
    fluid[gids] = np.random.RandomState(2).rand(3, 12) + 0.1
    active = np.zeros(jm.ngeom, bool)
    active[gids] = True
    jm2 = jm.replace(geom_fluid=jnp.asarray(fluid),
                     geom_fluid_active=type(jm.geom_fluid_active)(active))
    pm2 = world["pm"].replace(geom_fluid=torch.as_tensor(fluid),
                              geom_fluid_active=active)
    want = JP.fluid_ellipsoid(jm2, jin)
    got = P.fluid_ellipsoid(pm2, _port(world, jin))
    assert float(np.max(np.abs(np.asarray(want)))) > 0
    _close("fluid_ellipsoid", got, want, TOL)
    _close("fluid_box", P.fluid_box(pm2, _port(world, jin)),
           JP.fluid_box(jm2, jin), TOL)


def test_fused_solve(world):
    jin, jout = _stage_io(world, "solve")
    got = C.solve(world["pm"], _port(world, jin))
    _fields(got, jout, ("qacc", "qfrc_constraint", "warm_f", "warm_lim",
                        "apgd_v", "sol_f"), TOL_SOLVE)
    _fields(got, jout, ("warm_sel", "sol_lim_sel", "sol_cone_sel"), 0.0)


def test_fresh_substep(world):
    got = F.step(world["pm"], _port(world, world["jd0"]))
    _fields(got, world["chain"]["euler"],
            ("qpos", "qvel", "act", "qacc", "sensordata", "warm_f",
             "sol_f"), TOL_SOLVE)


def test_update_substep_reuses_selection(world):
    """col_update substep from a perturbed state: geometry refreshed for
    the stored lanes, solver selection carried over (not re-ranked)."""
    jd1p, jd2 = world["jd1p"], world["jd2"]
    got = F.step(world["pm"], _port(world, jd1p), col_update=True)
    _fields(got, jd2, ("qpos", "qvel", "act", "qacc", "sensordata",
                       "warm_f", "sol_f", "ccd_warm_u"), TOL_SOLVE)
    for n in ("sol_lim_sel", "sol_cone_sel"):
        np.testing.assert_array_equal(getattr(got, n).numpy(),
                                      np.asarray(getattr(jd1p, n)))
    np.testing.assert_array_equal(got.contact.sel.numpy(),
                                  np.asarray(jd1p.contact.sel))
    # the perturbation matters: a fresh selection ranks differently
    fresh = F.forward(world["pm"], _port(world, jd1p))
    assert not torch.equal(fresh.sol_cone_sel, got.sol_cone_sel) or \
        not torch.equal(fresh.sol_lim_sel, got.sol_lim_sel)
