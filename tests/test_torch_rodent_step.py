"""One physics substep of the rat, the port against the JAX package stage
by stage (float64 on the CPU, B=2): from a seeded state on the floor, from
the same state pitched head down until its skull and jaw boxes press into
the floor (the box pairs in the contact selection), and from a seeded
state on the gaps corridor's heightfield (the rat's heightfield pairs)."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu import rodent_envs as jre
from flybody_tpu.physics import actuation as JA
from flybody_tpu.physics import collision as JCOL
from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import forward as JF
from flybody_tpu.physics import kinematics as JK
from flybody_tpu.physics import passive as JP
from flybody_tpu.physics import sensors as JS
from flybody_tpu.physics import smooth as JSM
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.physics import actuation as A
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import smooth as SM
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.physics import types as T

from test_torch_rodent import head_down, lower_onto
from torch_jax_state import close, seeded_state, to_jax, to_port

torch.set_num_threads(2)

B = 2
# float64 on both sides, the same arithmetic in another summation order
# (test_torch_physics): the stages to ~1e-12, the solve (20 APGD
# iterations and noslip sweeps) and the convex narrowphase (an iterative
# minimization) amplify the last bits
TOL = 1e-8
TOL_SOLVE = 1e-6
TOL_CCD = 1e-6

# the stages of one fresh JAX substep (JF.step), in order
_CHAIN = (("kinematics", JK.kinematics), ("com_pos", JK.com_pos),
          ("tendon", JK.tendon), ("crb", JSM.crb),
          ("collision", JCOL.collision), ("transmission", JSM.transmission),
          ("com_vel", JSM.com_vel), ("passive", JP.passive),
          ("rne", JSM.rne), ("act_dynamics", JA.act_dynamics),
          ("actuation", JA.actuation),
          ("acceleration", JF.fwd_acceleration),
          ("solve", JC.solve), ("sensor", JS.sensor), ("euler", JF.euler))
_FIELDS = {"kinematics": ("xpos", "xmat", "geom_xpos", "site_xpos"),
           "crb": ("qM", "qLD"), "tendon": ("ten_length",),
           "rne": ("qfrc_bias",), "actuation": ("qfrc_actuator",),
           "passive": ("qfrc_passive",)}


def _jax_chain(m, d):
    out = []
    for _, fn in _CHAIN:
        d = fn(m, d)
        out.append(d)
    return tuple(out)


@functools.lru_cache(maxsize=None)
def world(kind):
    """The JAX model of ``kind``'s task (float64) with its substep chain
    jitted once, and the port's model."""
    factory = {"floor": (jre.rodent_two_touch, rodent_envs.rodent_two_touch),
               "gaps": (jre.rodent_run_gaps, rodent_envs.rodent_run_gaps)}
    jax_env, port_env = factory[kind]
    return (jax_env(dtype=jnp.float64).model,
            port_env(device="cpu", dtype=torch.float64).model,
            jax.jit(_jax_chain))


def _substep(kind, jd):
    """Each stage of one fresh substep of ``jd`` through both packages;
    returns the port's contact after the collision stage and JAX's."""
    jm, pm, chain = world(kind)
    outs = dict(zip([n for n, _ in _CHAIN], chain(jm, jd)))
    d = to_port(jd, pm)
    got = COL.collision(pm, _stage_input(pm, d, "collision", outs))
    jc = outs["collision"].contact
    np.testing.assert_array_equal(got.contact.sel.numpy(),
                                  np.asarray(jc.sel))
    for n in ("dist", "pos", "frame", "k", "b", "R", "mu", "invw",
              "margin", "b1", "b2", "g1", "g2", "typ", "sub"):
        close("contact." + n, getattr(got.contact, n), getattr(jc, n),
              TOL_CCD)
    full = F.step(pm, d)
    for f in ("qpos", "qvel", "act", "qacc", "sensordata", "warm_f",
              "sol_f"):
        close(f, getattr(full, f), getattr(outs["euler"], f), TOL_SOLVE)
    for f in ("warm_sel", "sol_lim_sel", "sol_cone_sel"):
        np.testing.assert_array_equal(getattr(full, f).numpy(),
                                      np.asarray(getattr(outs["euler"], f)),
                                      err_msg=f)
    return got.contact, full


def _stage_input(pm, d, name, outs):
    """The port's Data entering stage ``name``: JAX's output of the stage
    before it."""
    order = [n for n, _ in _CHAIN]
    i = order.index(name)
    return to_port(outs[order[i - 1]], pm) if i else d


def _on_the_ground(jm, pm, seed):
    """A seeded state (torch_jax_state) lowered until its deepest ground
    contact is 2 mm deep."""
    d = to_port(seeded_state(jm, seed), pm)
    return to_jax(d.replace(qpos=lower_onto(pm, d.qpos)), jm)


def _penetrating(con, pm, kinds):
    """(B,) count of selected penetrating contacts whose geoms are of the
    types ``kinds`` (type1, type2)."""
    gt = torch.as_tensor(np.asarray(pm.geom_type))
    t1, t2 = gt[con.g1.long()], gt[con.g2.long()]
    hit = (t1 == kinds[0]) & (t2 == kinds[1]) & (con.dist < 0)
    return hit.sum(dim=0)


@pytest.mark.parametrize("stage", ["kinematics", "tendon", "crb", "passive",
                                   "rne", "actuation"])
def test_stages_on_the_floor(stage):
    """The rat's smooth stages (its fixed tendons, filter actuators and
    passive springs included) on a seeded state on the floor."""
    jm, pm, chain = world("floor")
    jd = seeded_state(jm, 0)
    outs = dict(zip([n for n, _ in _CHAIN], chain(jm, jd)))
    fn = {"kinematics": K.kinematics, "tendon": K.tendon, "crb": SM.crb,
          "passive": P.passive, "rne": SM.rne,
          "actuation": A.actuation}[stage]
    got = fn(pm, _stage_input(pm, to_port(jd, pm), stage, outs))
    for f in _FIELDS[stage]:
        close(f, getattr(got, f), getattr(outs[stage], f), TOL)


def test_substep_on_the_floor():
    """A fresh substep from a seeded state lowered onto the floor: the
    contact selection slot for slot, then qpos, qvel, qacc, the sensors
    and the fused solve's forces and selections; feet on the floor."""
    jm, pm, _ = world("floor")
    con, _ = _substep("floor", _on_the_ground(jm, pm, 0))
    feet = _penetrating(con, pm, (T.GEOM_PLANE, T.GEOM_CAPSULE)) + \
        _penetrating(con, pm, (T.GEOM_PLANE, T.GEOM_SPHERE))
    assert bool((feet > 0).all()), feet


def test_substep_head_down_selects_the_box_pairs():
    """A fresh substep with the rat pitched nose down until its skull and
    jaw boxes press 2 mm into the floor: plane-box contacts are selected,
    penetrate and enter the fused solver's cones, in both packages
    alike."""
    jm, pm, _ = world("floor")
    jd = seeded_state(jm, 1)
    d = to_port(jd, pm)
    jd = to_jax(d.replace(qpos=head_down(pm, d.qpos)), jm)
    con, full = _substep("floor", jd)
    boxes = _penetrating(con, pm, (T.GEOM_PLANE, T.GEOM_BOX))
    assert bool((boxes > 0).all()), boxes
    lay = SF.fused_layout(pm, C.efc_meta(pm))
    rows = np.concatenate([np.arange(a, b) for a, b in lay["cone"]])
    gt = torch.as_tensor(np.asarray(pm.geom_type))
    is_box = (gt[con.g2.long()] == T.GEOM_BOX) & (con.dist < 0)
    taken = torch.gather(is_box, 0, torch.as_tensor(rows)[
        full.sol_cone_sel.long()])
    assert bool(taken.any(dim=0).all())


def test_substep_on_the_gaps_heightfield():
    """A fresh substep from a seeded state lowered onto the gaps
    corridor's start platform: heightfield-capsule and -sphere contacts
    are selected and penetrate; the substep as on the floor."""
    jm, pm, _ = world("gaps")
    con, _ = _substep("gaps", _on_the_ground(jm, pm, 2))
    H = T.GEOM_HFIELD
    feet = _penetrating(con, pm, (H, T.GEOM_CAPSULE)) + \
        _penetrating(con, pm, (H, T.GEOM_SPHERE))
    assert bool((feet > 0).all()), feet


def test_a_blown_up_env_keeps_no_poisoned_warm_start():
    """An env whose state turns non-finite (a blow-up under training
    actions) leaves no non-finite warm start for the solves after its
    auto-reset: its failed solve keeps its previous power vector, and a
    convex lane whose previous direction is not finite is reseeded as an
    unmatched lane is (bit for bit the same substep as with a zero
    direction)."""
    jm, pm, _ = world("floor")
    one = F.step(pm, to_port(_on_the_ground(jm, pm, 3), pm))
    q = one.qpos.clone()
    q[10, 1] = float("nan")
    two = F.step(pm, one.replace(qpos=q))
    assert not bool(torch.isfinite(two.qpos[:, 1]).all())
    assert torch.equal(two.apgd_v[:, 1], one.apgd_v[:, 1])
    assert bool(torch.isfinite(two.apgd_v).all())
    u_nan, u_zero = one.ccd_warm_u.clone(), one.ccd_warm_u.clone()
    u_nan[..., 0] = float("nan")
    u_zero[..., 0] = 0.0
    a = F.step(pm, one.replace(ccd_warm_u=u_nan))
    b = F.step(pm, one.replace(ccd_warm_u=u_zero))
    assert bool(torch.isfinite(a.qacc).all())
    assert torch.equal(a.qacc, b.qacc) and torch.equal(a.ccd_warm_u,
                                                       b.ccd_warm_u)
