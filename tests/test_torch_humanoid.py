"""The port's CMU humanoid and walk_humanoid against the JAX package
(float64 on the CPU, inputs seeded with numpy): the committed asset, the
walker's tables and observables (its empty end_effectors_pos included),
the synthetic clips' features, the reset from JAX's draws with the
observations and the reward in the fly tuning, one substep; then inverse
kinematics by autograd on the JAX package's toy arm (its iterates, its
convergence and its gradient against finite differences), and the
training CLI on walk_humanoid and its reference config."""

import functools

import mujoco
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu import rodent_envs as jre
from flybody_tpu.inverse_kinematics import qpos_from_site_xpos as j_ik
from flybody_tpu.physics import forward as JF
from flybody_tpu.physics import io_mj as jio
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.envs.humanoid_walker import HumanoidWalker
from flybody_tpu_torch.inverse_kinematics import qpos_from_site_xpos
from flybody_tpu_torch.models import rodent as RM
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import types as T

from test_torch_rodent import lower_onto
from test_torch_rodent_train import _cli
from test_torch_tracking import (TOL_F32, TOL_KIN, TOL_REF, TOL_SOLVE,
                                 _hold_clips, _jax_reset)
from torch_jax_state import close, seeded_state, to_jax, to_port

torch.set_num_threads(2)

# the same float64 closed forms in another operation order
TOL_FORM = 1e-12


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def envs():
    """(JAX env, port env) of walk_humanoid, float64, built once."""
    return (jre.walk_humanoid(dtype=jnp.float64),
            rodent_envs.walk_humanoid(device="cpu", dtype=torch.float64))


def test_humanoid_asset():
    """The committed humanoid equals a fresh export and the JAX package's
    MjModel field for field (MuJoCo's timestep 0.002 kept; the env sets
    the task's 0.005); the put model has the JAX put model's sizes,
    candidate pairs and fused layout (R 96 = 16 + 8 + 3 x 24 over nv
    62)."""
    jenv, penv = envs()
    fresh = RM.export_humanoid_model(None)
    committed = RM.load_humanoid_model()
    theirs = io_mj.export_mj(jenv.mj_model)
    assert sorted(fresh) == sorted(committed) == sorted(theirs)
    for k in committed:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        np.testing.assert_array_equal(committed[k], theirs[k], err_msg=k)
    assert float(committed["opt_timestep"]) == 0.002
    pm, jm = penv.model, jenv.model
    assert (pm.nq, pm.nv, pm.nu, pm.nbody, pm.ngeom) == (63, 62, 56, 34, 48)
    for f in ("ncon_max", "nccd", "ccd_budget", "nefc", "col_refresh",
              "nsensordata"):
        assert getattr(pm, f) == getattr(jm, f), f
    for f in ("pair_geom1", "pair_geom2", "pair_type", "sensor_type",
              "ccd_geom1", "ccd_geom2"):
        np.testing.assert_array_equal(np.asarray(getattr(pm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    gt = np.asarray(pm.geom_type)
    assert [int((gt == t).sum()) for t in (T.GEOM_PLANE, T.GEOM_SPHERE,
                                          T.GEOM_CAPSULE, T.GEOM_ELLIPSOID,
                                          T.GEOM_BOX)] == [1, 6, 39, 2, 0]
    assert io_mj.fused_dims(pm) == (96, 16, 24)
    assert penv.n_substeps == 6 and pm.col_refresh == 3
    assert float(pm.opt.timestep) == 0.005 and penv.episode_steps == 333


def test_walker_tables_and_observables():
    """The humanoid walker's tables equal the JAX walker's (its root,
    pelvis, hands and five end-effector bodies; no limb tips, so an
    empty end_effectors_pos, as in the JAX package); its observables of a
    seeded state equal the JAX walker's."""
    jenv, penv = envs()
    jw, pw = jenv.task.walker, penv.task.walker
    assert isinstance(pw, HumanoidWalker)
    for f in ("root_body_id", "torso_id", "pelvis_id", "head_site",
              "lhand_body", "rhand_body", "n_limb_tips", "root_qposadr",
              "sensor_adr", "action_size"):
        assert getattr(pw, f) == getattr(jw, f), f
    for f in ("end_effector_bodies", "joint_qposadr", "joint_dofadr",
              "obs_joint_qposadr", "obs_joint_dofadr",
              "mocap_tracking_bodies", "ground_geoms"):
        np.testing.assert_array_equal(getattr(pw, f), getattr(jw, f),
                                      err_msg=f)
    names = {v: k for k, v in penv.model.names["body"].items()}
    assert [names[b] for b in pw.end_effector_bodies] == [
        "walker/" + n for n in ("lhand", "rhand", "lfoot", "rfoot", "head")]
    assert names[pw.root_body_id] == "walker/root" and pw.n_limb_tips == 0
    pm = penv.model
    rng = np.random.RandomState(4)
    d = to_port(seeded_state(jenv.model, 4, B=3), pm)
    d = F.fwd_velocity(pm, F.fwd_position(pm, d))
    sm = _t(rng.randn(pm.nsensordata, 3))
    want = jax.jit(jax.vmap(
        lambda dd, s: jw.observables(jenv.model, dd, s), in_axes=(-1, -1)))(
            to_jax(d, jenv.model), jnp.asarray(_np(sm)))
    got = pw.observables(pm, d, sm)
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_KIN, scale=1.0)
    assert got["end_effectors_pos"].shape == (3, 0)
    assert got["appendages_pos"].shape == (3, 15)
    assert got["sensors_touch"].shape == (3, 10)


def test_synthetic_clip_features():
    """The humanoid's two synthetic clips of 120 frames, field by field
    against the JAX package's (qpos and qvel bit for bit; the features
    within a float32 ulp)."""
    jenv, penv = envs()
    pc, jc = penv.task.clips, jenv.task.clips
    assert pc.num_clips == 2 and pc.fields["qpos"].shape == (2, 120, 63)
    for k in ("qpos", "qvel"):
        np.testing.assert_array_equal(_np(pc.fields[k]),
                                      np.asarray(jc.fields[k]), err_msg=k)
    _hold_clips(pc, jc, TOL_F32)
    assert pc.fields["appendages"].shape == (2, 120, 5, 3)


def test_reset_observations_and_reward():
    """walk_humanoid's reset from the JAX package's draws: qpos, qvel and
    the task state; the observations (1667 floats) and, after one
    control step's counter, reward, termination, discount and the fly
    tuning's channels on a perturbed state against the JAX task's."""
    jenv, penv = envs()
    jm, pm = jenv.model, penv.model
    jd, jts = _jax_reset(jenv, jax.random.split(jax.random.PRNGKey(7), 3))
    st = penv.reset(3, clip=_t(jts["clip"]), start=_t(jts["start"]))
    close("qpos", st.data.qpos, jd.qpos, 0.0, scale=1.0)
    close("qvel", st.data.qvel, jd.qvel, 0.0, scale=1.0)
    for k in jts:
        np.testing.assert_array_equal(_np(st.task_state[k]),
                                      np.asarray(jts[k]), err_msg=k)
    want = jax.jit(jax.vmap(
        lambda d, t: jenv.task.observations(jm, d, t, d.sensordata),
        in_axes=(-1, -1)))(to_jax(st.data, jm), jts)
    assert sorted(st.obs) == sorted(want)
    for k in want:
        close(k, st.obs[k], want[k], TOL_KIN, scale=1.0)
    assert sum(v[0].numel() for v in st.obs.values()) == 1667
    rng = np.random.RandomState(8)
    qpos = st.data.qpos.clone()
    qpos[7:] += _t(0.05 * rng.randn(pm.nq - 7, 3))
    qpos[0, 2] += 3.0                        # env 2 3 m off its reference
    d = F.fwd_velocity(pm, F.fwd_position(pm, st.data.replace(qpos=qpos)))
    _, ts = penv.task.after_substeps(pm, d, st.task_state)
    jts1 = {k: jnp.asarray(_np(v), jnp.int32) for k, v in ts.items()}
    got = penv.task.reward_term_discount(pm, d, ts, d.sensordata)
    jw = jax.jit(jax.vmap(
        lambda dd, t: jenv.task.reward_term_discount(jm, dd, t,
                                                     dd.sensordata),
        in_axes=(-1, -1)))(to_jax(d, jm), jts1)
    close("reward", got[0], jw[0], TOL_REF, scale=1.0)
    for g, w in zip(got[1:], jw[1:]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
    np.testing.assert_array_equal(_np(got[2]), [1, 1, 0])
    ch = penv.task.reward_factors(pm, d, ts, d.sensordata)
    close("channels", sum(ch.values()), got[0], TOL_FORM, scale=1.0)
    assert float(ch["appendages"].max()) <= 0.5 * 0.15


def test_substep_of_the_humanoid():
    """One fresh substep (5 ms) of a seeded state lowered onto the floor:
    qpos, qvel, qacc, the sensors (touch and torque among them) and the
    fused solve against the JAX package's forward.step, B=2."""
    jenv, penv = envs()
    jm, pm = jenv.model, penv.model
    d = to_port(seeded_state(jm, 5), pm)
    jd = to_jax(d.replace(qpos=lower_onto(pm, d.qpos)), jm)
    want = jax.jit(JF.step)(jm, jd)
    got = F.step(pm, to_port(jd, pm))
    for f in ("qpos", "qvel", "act", "qacc", "sensordata", "warm_f",
              "sol_f"):
        close(f, getattr(got, f), getattr(want, f), TOL_SOLVE)
    for f in ("warm_sel", "sol_lim_sel", "sol_cone_sel"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert bool((got.contact.dist < 0).any(0).all())


# ---- inverse kinematics -------------------------------------------------

_ARM = """
<mujoco><worldbody>
  <body name="a" pos="0 0 1">
    <joint name="j1" type="hinge" axis="0 1 0"/>
    <geom type="capsule" size=".04" fromto="0 0 0 .5 0 0" mass=".1"/>
    <body name="b" pos=".5 0 0">
      <joint name="j2" type="hinge" axis="0 1 0"/>
      <geom type="capsule" size=".04" fromto="0 0 0 .5 0 0" mass=".1"/>
      <site name="tip" pos=".5 0 0"/>
    </body>
  </body>
</worldbody></mujoco>"""


@functools.lru_cache(maxsize=None)
def arm():
    """tests/test_tasks_units.py's toy arm: (JAX model, port model)."""
    mj = mujoco.MjModel.from_xml_string(_ARM)
    return (jio.put_model(mj, dtype=jnp.float64),
            io_mj.put_model(io_mj.export_mj(mj), device="cpu",
                            dtype=torch.float64))


def _arm_targets(B):
    """B reachable tip targets (numpy-seeded), (1, 3, B), and JAX's."""
    rng = np.random.RandomState(9)
    r = rng.uniform(0.4, 0.9, B)
    a = rng.uniform(-1.0, 1.0, B)
    return np.stack([r * np.cos(a), 0 * r, 1.0 + r * np.sin(a)])[None]


def test_ik_iterates_against_jax():
    """40 momentum steps from the same start on 3 targets at once (one
    objective summed over the batch, so each env has its own gradient):
    qpos and the site error against the JAX package's (its lax.scan of
    jax.grad), env by env; each env alone gives the same qpos."""
    jm, pm = arm()
    tgt = _arm_targets(3)
    jd = jio.make_data(jm, B=3, dtype=jnp.float64)
    want = j_ik(jm, jd, np.array([0]), jnp.asarray(tgt), np.array([0, 1]),
                reg_strength=1e-3, lr=0.05, beta=0.9, max_steps=40)
    got = qpos_from_site_xpos(pm, io_mj.make_data(pm, 3), np.array([0]),
                              _t(tgt), np.array([0, 1]), reg_strength=1e-3,
                              lr=0.05, beta=0.9, max_steps=40)
    close("qpos", got.qpos, want.qpos, TOL_FORM, scale=1.0)
    close("site_error", got.site_error, want.site_error, TOL_FORM, scale=1.0)
    close("err_norm", got.err_norm, want.err_norm, TOL_FORM, scale=1.0)
    one = qpos_from_site_xpos(pm, io_mj.make_data(pm, 1), np.array([0]),
                              _t(tgt[..., 1:2]), np.array([0, 1]),
                              reg_strength=1e-3, lr=0.05, beta=0.9,
                              max_steps=40)
    close("env 1 alone", one.qpos[:, 0], got.qpos[:, 1], TOL_FORM, scale=1.0)


def test_ik_converges_on_the_toy_arm():
    """tests/test_tasks_units.py's case: 3000 steps bring the tip within
    1e-3 of (0.7, 0, 1.3)."""
    _, pm = arm()
    d = io_mj.make_data(pm)
    target = torch.tensor([[0.7, 0.0, 1.3]], dtype=torch.float64)
    res = qpos_from_site_xpos(pm, d, np.array([0]), target,
                              np.array([0, 1]), lr=0.01, beta=0.9,
                              max_steps=3000)
    tip = K.kinematics(pm, d.replace(qpos=res.qpos)).site_xpos[0, :, 0]
    err = float(torch.linalg.vector_norm(tip - target[0]))
    assert err < 1e-3, err


def test_ik_gradient_by_finite_differences():
    """The gradient autograd takes through the port's kinematics (its
    level writes into preallocated tensors) on the rat's 64-body tree:
    the site objective's gradient in 12 joints against central finite
    differences in float64 (step 1e-6: a truncation error ~1e-12 and a
    rounding error ~1e-10 of the objective's scale)."""
    penv = rodent_envs.rodent_walk_imitation(device="cpu",
                                             dtype=torch.float64)
    pm = penv.model
    rng = np.random.RandomState(12)
    d = io_mj.make_data(pm, 2)
    qpos = d.qpos.clone()
    qpos[7:] += _t(0.1 * rng.randn(pm.nq - 7, 2))
    d = d.replace(qpos=qpos)
    sites = np.arange(min(pm.nsite, 10))
    target = _t(rng.randn(len(sites), 3, 2) * 0.1) + K.kinematics(
        pm, d).site_xpos[sites]
    adr = np.asarray(penv.task.walker.joint_qposadr)[::6][:12]
    ix = torch.as_tensor(adr)

    def obj(q):
        dd = K.kinematics(pm, d.replace(qpos=d.qpos.index_put((ix,), q)))
        return torch.sum((dd.site_xpos[sites] - target) ** 2)

    q0 = d.qpos[ix].clone().requires_grad_(True)
    g = torch.autograd.grad(obj(q0), q0)[0]
    h = 1e-6
    fd = torch.zeros_like(g)
    with torch.no_grad():
        for i in range(len(adr)):
            for b in range(2):
                e = torch.zeros_like(g)
                e[i, b] = h
                fd[i, b] = (obj(q0 + e) - obj(q0 - e)) / (2 * h)
    close("gradient", g, fd, 1e-7, scale=1.0)
    assert float(g.abs().max()) > 1e-3




# ---- the training CLI ---------------------------------------------------


@pytest.mark.parametrize("argv", [
    ("--task", "walk_humanoid"),
    ("--config", "configs/train_config_humanoid.yaml")],
    ids=["task", "config"])
def test_cli_walk_humanoid(argv):
    """walk_humanoid trains one --test iteration (8 envs, unroll 10,
    batch 32: 80 updates with a finite critic loss) with the plain
    network and with the reference config's intention networks at their
    1024 widths: 1667 observation floats, 56 actions."""
    out, line = _cli(*argv)
    net = "intention" if argv[0] == "--config" else "plain"
    assert (f"task walk_humanoid: 1667 observation floats, 56 actions, "
            f"network {net}") in out, out
    assert "learner_steps=80" in line, line
