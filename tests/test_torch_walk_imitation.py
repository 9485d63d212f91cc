"""walk_imitation in the port against the JAX package (float64, numpy
seeds): the quaternion helpers, the four plane collision pairs, the
contact selection on a floor state, the synthetic dataset, the reward
features and DeepMimic factors, the committed model asset, and reset plus
one autoreset_step at B=2."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.io import trajectories as JTR
from flybody_tpu.math import quaternions as JQ
from flybody_tpu.physics import collision as JCOL
from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import solver_fused as JSF
from flybody_tpu.tasks.walk_imitation import make_walk_imitation as jax_env
from flybody_tpu_torch.io import trajectories as TR
from flybody_tpu_torch.math import quaternions as Q
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.tasks import walk_imitation as WI

from torch_jax_state import close, to_port

torch.set_num_threads(2)

B = 2
# the same float64 closed forms in another operation order
TOL_FORM = 1e-12
# closed forms over rotation matrices and square roots (pairs, features)
TOL_PAIR = 1e-10
# the convex narrowphase's frames: an iterative minimization amplifies
# last-bit differences (as in test_torch_physics.test_collision_selection)
TOL_CCD = 1e-6
# reset: the same float64 kinematics in another summation order
TOL_RESET = 1e-10
# one control step = 10 substeps of contact dynamics with iterative
# solvers (20 APGD iterations, BB-step narrowphase); ~1e-15 rounding
# differences grow through them but stay far below this bound
TOL_STEP = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.fixture(scope="module")
def envs():
    """Both envs, a JAX reset from seeded keys, and one JAX
    autoreset_step from it with seeded actions."""
    jenv = jax_env(dtype=jnp.float64)
    penv = WI.make_walk_imitation("cpu", dtype=torch.float64)
    jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    lo, hi = jenv.action_spec()
    action = lo + (hi - lo) * np.random.RandomState(0).rand(B, len(lo))
    jnext = jax.jit(jenv.autoreset_step)(jstate, jnp.asarray(action))
    return dict(jenv=jenv, penv=penv, jstate=jstate, jnext=jnext,
                action=action)


# ---- quaternion helpers ----------------------------------------------------


def _quats(rng, *shape):
    q = rng.randn(*shape, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quaternion_helpers():
    rng = np.random.RandomState(0)
    q1, q2 = _quats(rng, 7), _quats(rng, 7)
    # unnormalised quats for the reciprocal and the deltas
    u1 = q1 * rng.uniform(0.5, 2.0, (7, 1))
    vec = rng.randn(7, 3)
    angle = rng.uniform(-3.0, 3.0, 7)
    # quat_z2vec's rows: generic, zero, +z, -z, x = y = 0 scaled, tiny xy
    zv = np.concatenate([rng.randn(4, 3), [[0, 0, 0], [0, 0, 2.0],
                                          [0, 0, -0.5], [0, 0, -3.0],
                                          [1e-9, 0, -1.0]]])
    cases = [
        ("_safe_norm", (vec,)), ("mult_quat", (q1, q2)),
        ("reciprocal_quat", (u1,)), ("get_dquat", (u1, q2)),
        ("get_dquat_local", (u1, q2)),
        ("get_egocentric_vec", (vec, rng.randn(7, 3), q1)),
        ("axis_angle_to_quat", (vec, angle)), ("quat_z2vec", (zv,)),
        ("quat_dist_short_arc", (q1, q2)),
        ("joint_orientation_quat", (zv[:7], angle))]
    for name, args in cases:
        want = getattr(JQ, name)(*(jnp.asarray(a) for a in args))
        got = getattr(Q, name)(*(_t(a) for a in args))
        close(name, got, want, TOL_FORM, scale=1.0)
    # the degenerate rows: identity, identity, identity, 180 about x
    z2v = Q.quat_z2vec(_t(zv)).numpy()
    np.testing.assert_array_equal(z2v[4:8], [[1, 0, 0, 0], [1, 0, 0, 0],
                                             [0, 1, 0, 0], [0, 1, 0, 0]])


# ---- the plane pairs -------------------------------------------------------


def _rotations(rng, P, Bn):
    """(P, 3, 3, Bn) rotation matrices of random quaternions."""
    q = _quats(rng, P, Bn)
    return np.moveaxis(np.array(JQ.quat_to_mat(jnp.asarray(q))), 1, -1)


@pytest.mark.parametrize("name", ["_plane_sphere", "_plane_capsule",
                                  "_plane_ellipsoid", "_plane_cylinder"])
def test_plane_pair(name):
    """dist, pos, normal and contact frame of random plane / geom
    placements; the cylinder's last pair stands upright on its plane
    (the fallback rim direction)."""
    rng = np.random.RandomState(1)
    P, Bn = 5, 3
    p1, p2 = rng.randn(P, 3, Bn) * 0.1, rng.randn(P, 3, Bn) * 0.1
    m1, m2 = _rotations(rng, P, Bn), _rotations(rng, P, Bn)
    m2[-1] = m1[-1]
    s1 = np.tile([[50.0], [50.0], [0.1]], (P, 1, 1))
    s2 = rng.uniform(0.01, 0.1, (P, 3, 1))
    args = (p1, m1, s1, p2, m2, s2)
    want = getattr(JCOL, name)(*(jnp.asarray(a) for a in args))
    got = getattr(COL, name)(*(_t(a) for a in args))
    for label, g, w in zip(("dist", "pos", "normal"), got, want):
        close(f"{name} {label}", g, w, TOL_PAIR, scale=1.0)
    k = got[0].shape[1]
    nrm_p = got[2].reshape(P * k, 3, Bn)
    nrm_j = jnp.asarray(want[2]).reshape(P * k, 3, Bn)
    close(f"{name} frame", COL.make_frame(nrm_p), JCOL._make_frame(nrm_j),
          TOL_PAIR, scale=1.0)


# ---- contact selection on the floor --------------------------------------


def _sorted_by_sel(contact, names):
    """Each field with every env's selected rows in slot-id order."""
    sel = np.asarray(contact.sel if not isinstance(contact.sel, torch.Tensor)
                     else contact.sel.numpy())
    order = np.argsort(sel, axis=0, kind="stable")
    out = {"sel": np.take_along_axis(sel, order, axis=0)}
    for n in names:
        v = getattr(contact, n)
        v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        idx = order.reshape(order.shape[:1] + (1,) * (v.ndim - 2)
                            + order.shape[1:])
        out[n] = np.take_along_axis(v, idx, axis=0)
    return out


def test_collision_selection_on_floor(envs):
    """collision() on the JAX reset state (the fly standing on the floor,
    floor contacts penetrating) against the contacts the JAX reset
    selected there, from the same cold ccd start: the same selected slots
    per env, their geometry and frames."""
    pm = envs["penv"].model
    jd = envs["jstate"].data
    want = jd.contact
    cold = jd.replace(ccd_warm_id=jnp.full_like(jd.ccd_warm_id, -1),
                      ccd_warm_u=jnp.zeros_like(jd.ccd_warm_u))
    got = COL.collision(pm, to_port(cold, pm)).contact
    floor = pm.names["geom"]["floor"]
    on_floor = np.asarray(want.g1) == floor
    assert on_floor.sum(axis=0).min() > 0
    assert (np.asarray(want.dist)[on_floor] < 0).sum() > 0
    names = ("dist", "pos", "frame", "k", "b", "R", "mu", "g1", "g2",
             "typ", "sub")
    w, g = _sorted_by_sel(want, names), _sorted_by_sel(got, names)
    np.testing.assert_array_equal(g["sel"], w["sel"])
    for n in names:
        close("contact." + n, g[n], w[n], TOL_CCD)


# ---- dataset, model asset --------------------------------------------------


def test_synthetic_dataset_equal_to_jax():
    qpos0 = np.zeros(7 + 85, np.float32)
    qpos0[2], qpos0[3] = 0.1278, 1.0
    want = JTR.synthetic_walking_dataset(qpos0, n_joints=85, n_sites=6)
    got = TR.synthetic_walking_dataset(qpos0, n_joints=85, n_sites=6)
    assert sorted(got.fields) == sorted(want.fields)
    for k in want.fields:
        np.testing.assert_array_equal(got.fields[k].numpy(),
                                      np.asarray(want.fields[k]), err_msg=k)
        assert got.fields[k].dtype == torch.float32
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert (got.num_trajectories, got.max_len) == (4, 200)
    assert got.timestep == want.timestep


def test_committed_model_is_a_fresh_export(tmp_path):
    fresh = WI.export_model(str(tmp_path / "m.npz"))
    committed = WI.load_model()
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


def test_builder_matches_jax_mjmodel(envs):
    """The port's MjModel build is the JAX package's, field for field, and
    both packages lay out the fused solve in 176 rows."""
    mine, amap = WI.build_mj_model()
    theirs = envs["jenv"].mj_model
    a, b = io_mj.export_mj(mine), io_mj.export_mj(theirs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (mine.nq, mine.nv, mine.nu) == (109, 108, 59)
    assert amap["total"] == 59
    pm, jm = envs["penv"].model, envs["jenv"].model
    lay = SF.fused_layout(pm, C.efc_meta(pm))
    jlay = JSF.fused_layout(jm, JC.efc_meta(jm))
    assert (lay["R"], lay["kl"], lay["kc"]) == (176, 32, 48)
    assert (jlay["R"], jlay["kl"], jlay["kc"]) == (176, 32, 48)


# ---- rewards, reset, one control step ------------------------------------


def _task_state(jts):
    return WI.ImitationState(traj_idx=_t(jts.traj_idx).long(),
                             step=_t(jts.step).long(),
                             snippet_len=_t(jts.snippet_len).long())


def test_reward_features_and_factors(envs):
    """get_walker_features, get_reference_features and the DeepMimic
    factors on the state after one JAX control step (the fly off its
    reference), the port's env axis last against JAX's vmap."""
    jenv, penv, jnext = envs["jenv"], envs["penv"], envs["jnext"]
    jm = jenv.model
    jt = jenv.task
    factors, wft, rft = jax.jit(jax.vmap(
        lambda d, ts: jt._deep_mimic_factors(jm, d, ts),
        in_axes=(-1, -1)))(jnext.data, jnext.task_state)
    pm = penv.model
    got = penv.task._deep_mimic_factors(pm, to_port(jnext.data, pm),
                                        _task_state(jnext.task_state))
    lead = lambda x: np.moveaxis(np.asarray(x), 0, -1)
    close("factors", got[0], lead(factors), TOL_PAIR)
    assert float(np.min(np.asarray(factors)[:, 0])) < 20.0  # off reference
    for label, g, w in (("walker", got[1], wft), ("reference", got[2], rft)):
        assert set(g) == set(w)
        for k in w:
            close(f"{label}.{k}", g[k], lead(w[k]), TOL_PAIR, scale=1.0)


def test_reset_with_jax_draw(envs):
    """reset from the JAX package's snippet draw gives its state, obs and
    task state."""
    penv, jst = envs["penv"], envs["jstate"]
    traj = _t(jst.task_state.traj_idx)
    pst = penv.reset(B, traj_idx=traj)
    assert set(pst.obs) == set(jst.obs)
    for k in jst.obs:
        close("obs." + k, pst.obs[k], jst.obs[k], TOL_RESET, scale=1.0)
    for f in ("qpos", "qvel", "xpos", "xquat", "qM", "qfrc_bias"):
        close(f, getattr(pst.data, f), getattr(jst.data, f), TOL_RESET,
              scale=1.0)
    for f in ("traj_idx", "step", "snippet_len"):
        np.testing.assert_array_equal(
            getattr(pst.task_state, f).numpy(),
            np.asarray(getattr(jst.task_state, f)), err_msg=f)
    np.testing.assert_array_equal(np.sort(pst.data.contact.sel.numpy(), 0),
                                  np.sort(np.asarray(jst.data.contact.sel),
                                          0))


def test_autoreset_step(envs):
    """One control step from the JAX reset state (no episode ends, so the
    auto-reset draw does not enter): obs, reward, done, discount and the
    state within TOL_STEP of scale, selections as sets."""
    penv, jst, jnext = envs["penv"], envs["jstate"], envs["jnext"]
    assert not bool(np.asarray(jnext.done).any())
    pst = penv.reset(B, traj_idx=_t(jst.task_state.traj_idx))
    pst = pst.replace(data=to_port(jst.data, penv.model))
    nxt = penv.autoreset_step(pst, torch.as_tensor(envs["action"]))
    assert set(nxt.obs) == set(jnext.obs)
    for k in jnext.obs:
        close("obs." + k, nxt.obs[k], jnext.obs[k], TOL_STEP, scale=1.0)
    for f in ("reward", "discount", "step_idx"):
        close(f, getattr(nxt, f), getattr(jnext, f), TOL_STEP, scale=1.0)
    np.testing.assert_array_equal(nxt.done.numpy(), np.asarray(jnext.done))
    for f in ("qpos", "qvel", "act", "ctrl", "time"):
        close(f, getattr(nxt.data, f), getattr(jnext.data, f), TOL_STEP,
              scale=1.0)
    np.testing.assert_array_equal(nxt.task_state.step.numpy(),
                                  np.asarray(jnext.task_state.step))
    for f in ("warm_sel", "sol_cone_sel", "sol_lim_sel"):
        np.testing.assert_array_equal(
            np.sort(getattr(nxt.data, f).numpy(), axis=0),
            np.sort(np.asarray(getattr(jnext.data, f)), axis=0), err_msg=f)
