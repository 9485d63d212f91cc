"""The port's multi-clip tracking against the JAX package, piece by piece
(float64 on the CPU, inputs seeded with numpy): the quaternion functions;
the tracking rewards and their channels in both tunings; the foot-mods
rat's committed asset; the synthetic clips' features; the clip loaders on
both HDF5 layouts and the STAC conversion, on files written to tmp_path;
rodent_walk_imitation's reset from the JAX package's clip and start
draws, its observations, reward, channels, termination and discount on
crafted states; the observation layout the trainer flattens; one substep
of the foot-mods rat; and the clip playback's frames."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import render_stac as j_render_stac
from flybody_tpu import rodent_envs as jre
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.agents.train import DEFAULT_TASK_KEYS as J_TASK_KEYS
from flybody_tpu.io import stac as j_stac
from flybody_tpu.math import quaternions as jq
from flybody_tpu.physics import forward as JF
from flybody_tpu.physics import io_mj as jio
from flybody_tpu.tasks import tracking as JTRK
from flybody_tpu.tasks import tracking_rewards as JTR
from flybody_tpu_torch import render_stac as p_render_stac
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents.train import DEFAULT_TASK_KEYS
from flybody_tpu_torch.io import stac as p_stac
from flybody_tpu_torch.math import quaternions as pq
from flybody_tpu_torch.models import rodent as RM
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.tasks import tracking as TRK
from flybody_tpu_torch.tasks import tracking_rewards as TR

from test_torch_rodent import lower_onto
from torch_jax_state import close, seeded_state, to_jax, to_port

torch.set_num_threads(2)

# the same float64 closed forms in another operation order
TOL_FORM = 1e-12
# kinematics, sensors and the reward of the same state, float64
TOL_KIN = 1e-10
# a clip feature: float64 forward kinematics in both packages (~1e-15
# apart), each rounded to float32: at most one float32 ulp apart
TOL_F32 = 2 ** -23
# the reward of a float64 state against float32 reference quaternions:
# both packages normalise each reference quaternion in float32 (as the JAX
# package does), where the two norms may round one ulp apart; that moves a
# body's bounded distance by ~1e-7 at most
TOL_REF = 1e-6
# one substep, float64 (test_torch_rodent_step: the solve's 20 APGD
# iterations and noslip sweeps amplify the last bits)
TOL_SOLVE = 1e-6


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def envs():
    """(JAX env, port env) of rodent_walk_imitation, float64, built
    once."""
    return (jre.rodent_walk_imitation(dtype=jnp.float64),
            rodent_envs.rodent_walk_imitation(device="cpu",
                                              dtype=torch.float64))


# ---- quaternions --------------------------------------------------------


def _quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mats(rng):
    """Rotations whose mat_to_quat takes each of its four branches: trace
    positive, and near pi about x, y and z (the x, y or z diagonal entry
    the largest, the trace negative)."""
    q = _quats(rng, 6)
    q[:, 0] = np.abs(q[:, 0]) + 1.0
    near = []
    for axis in range(3):
        a = np.zeros((4, 4))
        a[:, 1 + axis] = 1.0
        a[:, 0] = 0.05 * rng.normal(size=4)
        a[:, 1:] += 0.05 * rng.normal(size=(4, 3))
        near.append(a)
    q = np.concatenate([q] + near)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(jq.quat_to_mat(jnp.asarray(q)))


def _cases(rng):
    """{function: (port call, JAX call)} on seeded inputs."""
    q1, q2 = _quats(rng, 8), _quats(rng, 8)
    v = rng.normal(size=(8, 3))
    hover = _quats(rng, 1)[0]
    near_id = np.concatenate([np.ones((4, 1)), 1e-9 * rng.normal(
        size=(4, 3))], 1)
    logq = np.concatenate([2.0 * q1, near_id])
    seq = _quats(rng, 6)
    w = rng.normal(size=(8, 3))
    mats = _mats(np.random.RandomState(7))
    return {
        "get_quat": (lambda: torch.stack([pq.get_quat(
            _t(a), _t(ax)) for a, ax in zip([0.3, -2.0, 4.0],
                                            v[:3])]),
                     lambda: jnp.stack([jq.get_quat(a, ax) for a, ax in zip(
                         [0.3, -2.0, 4.0], v[:3])])),
        "vec_world_to_local": (
            lambda: torch.stack([pq.vec_world_to_local(_t(v), _t(q1)),
                                 pq.vec_world_to_local(_t(v), _t(q1),
                                                       _t(hover))]),
            lambda: jnp.stack([jq.vec_world_to_local(v, q1),
                               jq.vec_world_to_local(v, q1, hover)])),
        "vec_global_to_local": (
            lambda: pq.vec_global_to_local(_t(v), _t(2.0 * q2)),
            lambda: jq.vec_global_to_local(v, 2.0 * q2)),
        "log_quat": (lambda: pq.log_quat(_t(logq)),
                     lambda: jq.log_quat(logq)),
        "quat_to_angvel": (lambda: pq.quat_to_angvel(_t(q1), dt=0.02),
                           lambda: jq.quat_to_angvel(q1, dt=0.02)),
        "quat_seq_to_angvel": (
            lambda: torch.stack([pq.quat_seq_to_angvel(_t(seq), 0.02, loc)
                                 for loc in (False, True)]),
            lambda: jnp.stack([jq.quat_seq_to_angvel(seq, 0.02, loc)
                               for loc in (False, True)])),
        "quat_to_mat": (lambda: pq.quat_to_mat(_t(q1)),
                        lambda: jq.quat_to_mat(q1)),
        "mat_to_quat": (lambda: pq.mat_to_quat(_t(mats)),
                        lambda: jq.mat_to_quat(mats)),
        "quat_integrate": (lambda: pq.quat_integrate(_t(q1), _t(w), 0.02),
                           lambda: jq.quat_integrate(q1, w, 0.02)),
    }


@pytest.mark.parametrize("name", ["get_quat", "vec_world_to_local",
                                  "vec_global_to_local", "log_quat",
                                  "quat_to_angvel", "quat_seq_to_angvel",
                                  "quat_to_mat", "mat_to_quat",
                                  "quat_integrate"])
def test_quaternion_functions_equal_to_jax(name):
    """Each quaternion function on numpy-seeded inputs: mat_to_quat on
    rotations of each of its four branches (it recovers the quaternions
    with w >= 0), log_quat also near the identity (a vector part of
    1e-9)."""
    got, want = (f() for f in _cases(np.random.RandomState(3))[name])
    close(name, got, want, TOL_FORM, scale=1.0)
    if name == "mat_to_quat":
        d = np.diag
        m = _mats(np.random.RandomState(7))
        tr = np.trace(m, axis1=1, axis2=2)
        assert (tr > 0).sum() == 6 and all(
            np.argmax(d(x)) == i for x, i in zip(m[6:], np.repeat(
                np.arange(3), 4))) and (tr[6:] < 0).all()
        back = pq.quat_to_mat(got)
        close("round trip", back, m, TOL_FORM, scale=1.0)
    if name == "log_quat":
        # the vector part's angle near the identity, not 0 / 0
        assert np.isfinite(_np(got)).all()


def test_random_quat_from_a_generator():
    """random_quat draws the angle, then the axis, from the generator:
    the same generator state gives the same quaternions, which are the
    JAX package's axis_angle_to_quat of those draws, of unit norm."""
    gen = lambda: torch.Generator().manual_seed(4)
    q = pq.random_quat(gen(), (5,), dtype=torch.float64)
    assert torch.equal(q, pq.random_quat(gen(), (5,), dtype=torch.float64))
    g = gen()
    theta = 2 * np.pi * torch.rand((5,), generator=g, dtype=torch.float64)
    axis = 2 * torch.rand((5, 3), generator=g, dtype=torch.float64) - 1
    close("random_quat", q,
          jq.axis_angle_to_quat(_np(axis), _np(theta)), TOL_FORM, scale=1.0)
    np.testing.assert_allclose(torch.linalg.vector_norm(q, dim=-1), 1.0,
                               atol=1e-14)


# ---- rewards ------------------------------------------------------------


def _features(rng, B=4, nj=7, nb=5, ne=3, spread=0.1):
    def one():
        return dict(joints=rng.normal(size=(B, nj)),
                    joints_velocity=rng.normal(size=(B, nj)),
                    body_quaternions=_quats(rng, B * nb).reshape(B, nb, 4),
                    appendages=rng.normal(size=(B, ne, 3)),
                    center_of_mass=rng.normal(size=(B, 3)))
    w = one()
    r = {k: v + spread * rng.normal(size=v.shape) for k, v in w.items()}
    r["body_quaternions"] /= np.linalg.norm(r["body_quaternions"], axis=-1,
                                            keepdims=True)
    return w, r


@pytest.mark.parametrize("key", ["termination_reward",
                                 "multi_term_pose_reward", "comic"])
@pytest.mark.parametrize("tuning", ["rodent", "fly"])
def test_rewards_and_channels_equal_to_jax(key, tuning):
    """Each reward of the family in each tuning on seeded features of 4
    envs (one equal to its reference): the reward and every channel, in
    the channel table's order, against the JAX functions vmapped over the
    envs; bounded_quat_dist on its own."""
    rng = np.random.RandomState(len(key) + len(tuning))
    w, r = _features(rng)
    for k in w:
        r[k][0] = w[k][0]
    err = rng.uniform(0, 0.2, 4)
    pw = {k: _t(v) for k, v in w.items()}
    pr = {k: _t(v) for k, v in r.items()}
    got, ch = TR.get_reward(key)(
        termination_error=_t(err), termination_error_threshold=0.12,
        walker_features=pw, reference_features=pr, tuning=tuning)
    want, jch = jax.vmap(lambda e, ww, rr: JTR.get_reward(key)(
        termination_error=e, termination_error_threshold=0.12,
        walker_features=ww, reference_features=rr, tuning=tuning))(
            err, w, r)
    close("reward", got, want, TOL_FORM, scale=1.0)
    assert list(ch) == list(jch) and sorted(ch) == sorted(
        TR.get_reward_channels(key))
    assert TR.get_reward_channels(key) == JTR.get_reward_channels(key)
    for k in ch:
        close(k, ch[k], jch[k], TOL_FORM, scale=1.0)
    if key != "termination_reward":
        full = 4.0 if tuning == "rodent" else 1.9
        assert abs(float(sum(ch[k][0] for k in ch if k != "termination"))
                   - (full if key != "comic" else 0.5 * full)) < 1e-12
    q1 = w["body_quaternions"]
    close("bounded_quat_dist", TR.bounded_quat_dist(_t(q1), _t(-2 * q1[::-1])),
          JTR.bounded_quat_dist(q1, -2 * q1[::-1]), TOL_FORM, scale=1.0)
    with pytest.raises(ValueError):
        TR.get_reward("deep_mimic")


# ---- the foot-mods rat's asset ------------------------------------------


def test_imitation_asset_is_the_foot_mods_rat():
    """The committed foot-mods asset equals a fresh export and the JAX
    package's MjModel field for field; it is the floor rat's asset but for
    jnt_range (foot_mods moves joint limits by up to 0.7 rad); the put
    model has the JAX put model's sizes and fused layout (R 96)."""
    jenv, penv = envs()
    fresh = RM.export_model("imitation", None)
    committed = RM.load_model("imitation")
    theirs = io_mj.export_mj(jenv.mj_model)
    assert sorted(fresh) == sorted(committed) == sorted(theirs)
    for k in committed:
        np.testing.assert_array_equal(fresh[k], committed[k], err_msg=k)
        np.testing.assert_array_equal(committed[k], theirs[k], err_msg=k)
    floor = RM.load_model("floor")
    differ = [k for k in committed
              if not np.array_equal(committed[k], floor[k])]
    assert differ == ["jnt_range"], differ
    assert np.abs(committed["jnt_range"] - floor["jnt_range"]).max() > 0.5
    pm, jm = penv.model, jenv.model
    assert (pm.nq, pm.nv, pm.nu) == (74, 73, 38)
    for f in ("ncon_max", "nccd", "ccd_budget", "nefc", "col_refresh"):
        assert getattr(pm, f) == getattr(jm, f), f
    np.testing.assert_array_equal(_np(pm.jnt_range), np.asarray(jm.jnt_range))
    assert io_mj.fused_dims(pm) == (96, 16, 24)
    assert penv.n_substeps == 20 and penv.episode_steps == 500
    assert float(pm.opt.timestep) == 0.001


# ---- clips --------------------------------------------------------------


def _hold_clips(pc, jc, tol=TOL_F32):
    assert sorted(pc.fields) == sorted(jc.fields)
    for k, v in pc.fields.items():
        assert v.dtype == torch.float32, k
        close(k, v, np.asarray(jc.fields[k]), tol, scale=1.0)
    np.testing.assert_array_equal(_np(pc.lengths), np.asarray(jc.lengths))
    assert pc.timestep == jc.timestep


def test_synthetic_clip_features():
    """The rat's three synthetic clips of 120 frames: qpos and qvel bit
    for bit (the same numpy draws), every feature the port's forward
    kinematics computes (body poses, root pose, egocentric appendages)
    within a float32 ulp of the JAX package's."""
    jenv, penv = envs()
    pc, jc = penv.task.clips, jenv.task.clips
    assert pc.num_clips == 3 and pc.fields["qpos"].shape == (3, 120, 74)
    for k in ("qpos", "qvel", "joints", "joints_velocity"):
        np.testing.assert_array_equal(_np(pc.fields[k]),
                                      np.asarray(jc.fields[k]), err_msg=k)
    _hold_clips(pc, jc)
    assert pc.fields["appendages"].shape == (3, 120, 5, 3)
    assert pc.fields["body_positions"].shape == (3, 120, penv.model.nbody, 3)


def _flat_clip_file(path, nq, nv, lengths, seed):
    import h5py
    rng = np.random.RandomState(seed)
    with h5py.File(path, "w") as f:
        f.create_group("id2name")
        for i, n in enumerate(lengths):
            g = f.create_group(f"{i:03d}")
            qp = np.tile(np.r_[0, 0, 0.06, 1, 0, 0, 0, np.zeros(nq - 7)],
                         (n, 1)) + 0.02 * rng.normal(size=(n, nq))
            g.create_dataset("qpos", data=qp)
            g.create_dataset("qvel", data=rng.normal(size=(n, nv)))


@pytest.mark.parametrize("layout", ["flat", "walkers"])
def test_load_hdf5_clips_on_both_layouts(layout, tmp_path):
    """load_hdf5_clips on a file of flat qpos / qvel groups (clips of 30
    and 40 frames, padded with the last pose) and on the STAC layout
    (walkers/walker_0): the port's ClipCollection equals the JAX
    package's."""
    jenv, penv = envs()
    path = str(tmp_path / "clips.h5")
    if layout == "flat":
        _flat_clip_file(path, 74, 73, (30, 40), seed=5)
    else:
        p_stac.write_stac_fixture(path, num_clips=2, length=40, nj=67)
    pc = TRK.load_hdf5_clips(penv.model, penv.task.walker, path)
    jc = JTRK.load_hdf5_clips(jenv.model, jenv.task.walker, path)
    _hold_clips(pc, jc)
    if layout == "flat":
        np.testing.assert_array_equal(_np(pc.lengths), [30, 40])
        q = _np(pc.fields["qpos"][0])
        assert (q[30:] == q[29]).all()
    _flat_clip_file(path, 74, 73, (), seed=0)
    with pytest.raises(ValueError, match="no clips"):
        TRK.load_hdf5_clips(penv.model, penv.task.walker, path)


def test_stac_round_trip(tmp_path):
    """write_stac_fixture writes the JAX package's file, dataset for
    dataset; convert_stac writes its clip file ([pos, quat, joints] and
    [vel, angvel, joint velocities] per clip, the name tables, timestep
    and lengths); the converted clips load into the rat's env and reset
    it."""
    import h5py
    mine, theirs = str(tmp_path / "p.h5"), str(tmp_path / "j.h5")
    p_stac.write_stac_fixture(mine, num_clips=2, length=30, nj=67, seed=2)
    j_stac.write_stac_fixture(theirs, num_clips=2, length=30, nj=67, seed=2)
    outs = []
    for src in (mine, theirs):
        dst = src + ".clips"
        mod = p_stac if src == mine else j_stac
        assert mod.convert_stac(src, dst, joint_names=["j%d" % i for i in
                                                       range(67)]) == 2
        outs.append(dst)

    def items(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda k, v: out.__setitem__(k, v[()]) if isinstance(
                v, h5py.Dataset) else None)
        return out

    for a, b in ((mine, theirs), tuple(outs)):
        ia, ib = items(a), items(b)
        assert sorted(ia) == sorted(ib)
        for k in ia:
            np.testing.assert_array_equal(ia[k], ib[k], err_msg=k)
    got = items(outs[0])
    assert got["0/qpos"].shape == (30, 74) and got["0/qvel"].shape == (30, 73)
    np.testing.assert_allclose(np.linalg.norm(got["0/qpos"][:, 3:7], axis=1),
                               1.0, atol=1e-6)
    assert float(got["timestep_seconds"]) == 0.02
    assert list(got["trajectory_lengths"]) == [30, 30]
    env = rodent_envs.rodent_walk_imitation(device="cpu", ref_path=outs[0],
                                            time_limit=0.5)
    st = env.reset(2, torch.Generator().manual_seed(0))
    assert env.task.clips.num_clips == 2
    assert all(bool(torch.isfinite(v).all()) for v in st.obs.values())


# ---- the task -----------------------------------------------------------


def _jax_reset(jenv, keys):
    """The JAX package's init_state over ``keys`` as its FlyEnv.reset
    splits them: (Data, task state with its clip and start draws)."""
    jm, task = jenv.model, jenv.task
    init_keys = jax.vmap(jax.random.split)(keys)[:, 1]
    jd = jio.make_data(jm, B=keys.shape[0], dtype=jnp.float64)
    return jax.vmap(lambda d, k: task.init_state(jm, d, k),
                    in_axes=(-1, 0), out_axes=-1)(jd, init_keys)


def test_init_state_from_jax_draws():
    """init_state from the JAX package's clip and start draws gives its
    qpos, qvel and task state; from a generator it draws clip then start
    (the same generator state, the same draws), every start within its
    clip's range and every clip drawn over 64 envs."""
    jenv, penv = envs()
    B = 6
    jd, jts = _jax_reset(jenv, jax.random.split(jax.random.PRNGKey(5), B))
    pm = penv.model
    pd, pts = penv.task.init_state(pm, io_mj.make_data(pm, B), None,
                                   clip=_t(jts["clip"]), start=_t(jts["start"]))
    close("qpos", pd.qpos, jd.qpos, 0.0, scale=1.0)
    close("qvel", pd.qvel, jd.qvel, 0.0, scale=1.0)
    assert sorted(pts) == sorted(jts)
    for k in pts:
        np.testing.assert_array_equal(_np(pts[k]), np.asarray(jts[k]))
    gen = lambda: torch.Generator().manual_seed(1)
    a = penv.task.init_state(pm, io_mj.make_data(pm, 64), gen())[1]
    b = penv.task.init_state(pm, io_mj.make_data(pm, 64), gen())[1]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert sorted(a["clip"].unique().tolist()) == [0, 1, 2]
    assert int(a["start"].min()) >= 0 and int(a["start"].max()) < 120 - 6
    assert not bool(a["step"].any())


def _crafted(penv):
    """Four envs of different clips: env 0 near its reference at step 3;
    env 1 moved 10 m along x (past the termination threshold); env 2 at
    its clip's end (start 110, step 5, the previews clamped to the last
    frame); env 3 with a blown-up qacc. -> (port Data, task state)."""
    pm, task = penv.model, penv.task
    rng = np.random.RandomState(11)
    f = task.clips.fields
    ts = dict(clip=_t([0, 1, 2, 0]), start=_t([10, 40, 110, 0]),
              step=_t([3, 0, 5, 2]))
    t = ts["start"] + ts["step"]
    qpos = f["qpos"][ts["clip"], t].T.double()
    qpos[7:] += _t(0.02 * rng.normal(size=(pm.nq - 7, 4)))
    qpos[0, 1] += 10.0
    d = io_mj.make_data(pm, 4).replace(
        qpos=qpos, qvel=f["qvel"][ts["clip"], t].T.double()
        + _t(0.1 * rng.normal(size=(pm.nv, 4))))
    d = F.fwd_velocity(pm, F.fwd_position(pm, d))
    qacc = _t(rng.normal(size=(pm.nv, 4)))
    qacc[:, 3] *= 1e16
    return d.replace(qacc=qacc), ts


def _jax_channels(jenv, d, ts):
    """The JAX task's reward channels of one env (its reward function
    called as reward_term_discount calls it)."""
    task, jm = jenv.task, jenv.model
    wf = task._walker_features(jm, d)
    ref = dict(joints=task._ref("joints", ts),
               joints_velocity=task._ref("joints_velocity", ts),
               body_quaternions=task._ref("body_quaternions", ts),
               appendages=task._ref("appendages", ts),
               center_of_mass=task._ref("position", ts))
    walker = {k: wf[k] for k in ref}
    return JTR.get_reward(task.reward_key)(
        termination_error=task._termination_error(wf, ts),
        termination_error_threshold=task.termination_error_threshold,
        walker_features=walker, reference_features=ref,
        tuning=task.tuning)[1]


def test_observations_reward_and_termination():
    """observations, reward_term_discount and the reward channels of the
    crafted envs against the JAX task's (vmapped over the envs): env 0 is
    rewarded and goes on; env 1 diverged (discount 0); env 2 ends with
    its clip (discount 1); env 3 blew up (discount 0)."""
    jenv, penv = envs()
    pm, jm = penv.model, jenv.model
    pd, ts = _crafted(penv)
    jd = to_jax(pd, jm)
    jts = {k: jnp.asarray(_np(v), jnp.int32) for k, v in ts.items()}
    sm = pd.sensordata
    jsm = jnp.asarray(_np(sm))
    task, jtask = penv.task, jenv.task
    want = jax.jit(jax.vmap(
        lambda d, t, s: jtask.observations(jm, d, t, s),
        in_axes=(-1, -1, -1)))(jd, jts, jsm)
    got = task.observations(pm, pd, ts, sm)
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_KIN, scale=1.0)
    r, term, disc = task.reward_term_discount(pm, pd, ts, sm)
    jr, jterm, jdisc = jax.jit(jax.vmap(
        lambda d, t, s: jtask.reward_term_discount(jm, d, t, s),
        in_axes=(-1, -1, -1)))(jd, jts, jsm)
    close("reward", r, jr, TOL_REF, scale=1.0)
    np.testing.assert_array_equal(_np(term), np.asarray(jterm))
    np.testing.assert_array_equal(_np(disc), np.asarray(jdisc))
    np.testing.assert_array_equal(_np(term), [False, True, True, True])
    np.testing.assert_array_equal(_np(disc), [1, 0, 1, 0])
    ch = task.reward_factors(pm, pd, ts, sm)
    jch = jax.jit(jax.vmap(lambda d, t: _jax_channels(jenv, d, t),
                           in_axes=(-1, -1)))(jd, jts)
    assert list(ch) == list(JTR.get_reward_channels("comic"))
    for k in ch:
        close(k, ch[k], jch[k], TOL_REF, scale=1.0)
    close("sum of channels", sum(ch.values()), r, TOL_FORM, scale=1.0)
    assert float(r[0]) > 0.2
    # the clamp: env 2's last two previews are its clip's last frame
    ref = got["ref_rel_joints"][2].reshape(5, -1)
    assert torch.equal(ref[3], ref[4]) and not torch.equal(ref[2], ref[3])


def test_after_substeps_and_autoreset():
    """The step counter counts control steps; an autoreset swaps a done
    env's clip, start and step for a fresh draw and keeps the rest."""
    _, penv = envs()
    pd, ts = _crafted(penv)
    _, ts1 = penv.task.after_substeps(penv.model, pd, ts)
    np.testing.assert_array_equal(_np(ts1["step"]), [4, 1, 6, 3])
    st = penv.reset(4, torch.Generator().manual_seed(2))
    st = st.replace(done=torch.tensor([False, True, False, True]),
                    task_state=ts1)
    out = penv.apply_autoreset(st)
    for k in ("clip", "start", "step"):
        assert torch.equal(out.task_state[k][[0, 2]], ts1[k][[0, 2]])
    assert not bool(out.task_state["step"][[1, 3]].any())


def test_obs_layout_and_trainer_order():
    """The reset's observations have the JAX observations' keys and sizes
    (2829 floats: the rat's 158, and 2671 of references and the clip id)
    and both
    packages' obs_layout with the task keys agree; the intention trainer
    flattens in that task-first order (ref_* and clip_id first)."""
    from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig
    jenv, penv = envs()
    keys = jax.random.split(jax.random.PRNGKey(6), 2)
    jd, jts = _jax_reset(jenv, keys)
    st = penv.reset(2, clip=_t(jts["clip"]), start=_t(jts["start"]))
    want = jax.jit(jax.vmap(
        lambda d, t: jenv.task.observations(jenv.model, d, t, d.sensordata),
        in_axes=(-1, -1)))(to_jax(st.data, jenv.model), jts)
    for k in want:
        close(k, st.obs[k], want[k], TOL_KIN, scale=1.0)
    assert tuple(DEFAULT_TASK_KEYS) == tuple(J_TASK_KEYS)
    pk, ps = p_nets.obs_layout(st.obs, DEFAULT_TASK_KEYS)
    jk, js = j_nets.obs_layout(want, J_TASK_KEYS)
    assert pk == jk and ps == js
    assert sum(s[1] for s in ps.values()) == 2829
    tr = DMPOTrainer(penv, TrainerConfig(
        num_envs=2, network="intention", encoder_layers=(8,),
        decoder_layers=(8,), critic_layers=(8,), intention_size=4))
    assert list(tr.obs_keys) == list(pk) and tr.task_obs_size == 2671
    assert tuple(tr.obs_keys[:6]) == ("clip_id", "ref_appendages_pos",
                               "ref_ego_bodies_quats",
                               "ref_rel_bodies_pos_local",
                               "ref_rel_joints", "ref_rel_root_quat")


# ---- one substep --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_step():
    return jax.jit(JF.step)


def test_substep_of_the_foot_mods_rat():
    """One fresh substep of a seeded state (torch_jax_state) lowered onto
    the floor: qpos, qvel, qacc, the sensors and the fused solve's forces
    and selections against the JAX package's forward.step, B=2."""
    jenv, penv = envs()
    jm, pm = jenv.model, penv.model
    d = to_port(seeded_state(jm, 4), pm)
    jd = to_jax(d.replace(qpos=lower_onto(pm, d.qpos)), jm)
    want = _jax_step()(jm, jd)
    got = F.step(pm, to_port(jd, pm))
    for f in ("qpos", "qvel", "act", "qacc", "sensordata", "warm_f",
              "sol_f"):
        close(f, getattr(got, f), getattr(want, f), TOL_SOLVE)
    for f in ("warm_sel", "sol_lim_sel", "sol_cone_sel"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert bool((got.contact.dist < 0).any(0).all())


# ---- playback -----------------------------------------------------------


def test_playback_frames_against_jax():
    """render_stac's playback of two frames of clip 1 at 96x72: the port's
    frames against the JAX package's playback_frames. Both rasterize the
    same float32 geometry with the same C++ source, so the frames agree
    but where a float64 pose (the same to ~1e-15) rounds to another
    float32 and moves a pixel's edge: at most 0.1 % of pixels may
    differ."""
    jenv, penv = envs()
    qpos = penv.task.clips.fields["qpos"][1]
    got = np.asarray(p_render_stac.playback_frames(penv, qpos, 2, 96, 72))
    want = np.asarray(j_render_stac.playback_frames(jenv, np.asarray(
        jenv.task.clips.fields["qpos"])[1], 2, 96, 72))
    assert got.shape == (2, 72, 96, 3) and got.dtype == np.uint8
    differ = np.any(got != want, axis=-1).mean()
    print(f"playback: share of pixels that differ {differ:.2e}")
    assert differ <= 1e-3, differ
    assert got.std() > 1.0 and not np.array_equal(got[0], got[1])
