"""flight_imitation in the port against the JAX package (float64, numpy
seeds): the constants, the CoM <-> root maps, the wing-beat pattern
generator's tables and a 60-step run, the flight datasets and loaders, the
committed model asset, passive forces with the wing fluid, reset from the
JAX package's draws, one autoreset_step at B=2, the observation set, the
reward and termination, the walker helpers, and the CLI's --test mode.

The JAX control step is jitted once, in the module fixture (about 80 s of
compile on the CPU); every other JAX function here is small."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.io import trajectories as JTR
from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import passive as JP
from flybody_tpu.physics import solver_fused as JSF
from flybody_tpu.tasks import constants as JCON
from flybody_tpu.tasks import pattern_generators as JPG
from flybody_tpu.tasks import task_utils as JTU
from flybody_tpu.tasks.flight_imitation import FlightState as JFlightState
from flybody_tpu.tasks.flight_imitation import make_flight_imitation as jax_env
from flybody_tpu_torch.io import trajectories as TR
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.tasks import constants as CON
from flybody_tpu_torch.tasks import flight_imitation as FI
from flybody_tpu_torch.tasks import pattern_generators as PG
from flybody_tpu_torch.tasks import task_utils as TU

from torch_jax_state import close, to_jax, to_port

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
# the same float64 closed forms in another operation order
TOL_FORM = 1e-12
# passive forces: body velocities in local frames, quadratic drag and lift
# terms summed over the wing geoms (test_torch_physics.TOL)
TOL_PASSIVE = 1e-8
# reset: the same float64 kinematics in another summation order
TOL_RESET = 1e-10
# one control step = 4 substeps of wing dynamics with the fused solver's
# iterations and the convex narrowphase; ~1e-15 rounding differences grow
# through them but stay far below this bound
TOL_STEP = 1e-5


def _t(x):
    return torch.as_tensor(np.array(x))


def _jax_draws(keys):
    """The (traj_idx, initial_phase) the JAX reset draws from ``keys``
    (FlyEnv.reset splits each key, init_state splits the second half)."""
    init_keys = jax.vmap(jax.random.split)(keys)[:, 1]
    k = jax.vmap(jax.random.split)(init_keys)
    phase = jax.vmap(jax.random.uniform)(k[:, 1])
    return np.asarray(phase)


def _task_state(jts):
    """The port's FlightState of a JAX one."""
    w = jts.wbpg
    return FI.FlightState(
        traj_idx=_t(jts.traj_idx).long(), step=_t(jts.step).long(),
        snippet_len=_t(jts.snippet_len).long(),
        wbpg=PG.WBPGState(freq_idx=_t(w.freq_idx).long(),
                          step=_t(w.step).long(),
                          ctrl_freq=_t(w.ctrl_freq)))


@pytest.fixture(scope="module")
def envs():
    """Both envs, a JAX reset from seeded keys, and one JAX
    autoreset_step from it with seeded actions."""
    jenv = jax_env(dtype=jnp.float64)
    penv = FI.make_flight_imitation("cpu", dtype=torch.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = jax.jit(jenv.reset)(keys)
    lo, hi = jenv.action_spec()
    action = lo + (hi - lo) * np.random.RandomState(0).rand(B, len(lo))
    jnext = jax.jit(jenv.autoreset_step)(jstate, jnp.asarray(action))
    return dict(jenv=jenv, penv=penv, jstate=jstate, jnext=jnext,
                action=action, phase=_jax_draws(keys))


# ---- constants, frame maps -------------------------------------------------


def test_constants_equal_to_jax():
    names = [n for n in dir(JCON) if n.isupper()]
    assert {"FLY_PHYSICS_TIMESTEP", "FLY_CONTROL_TIMESTEP",
            "TERMINAL_HEIGHT", "WING_PARAMS",
            "BODY_PITCH_ANGLE"} <= set(names)
    for n in names:
        assert getattr(CON, n) == getattr(JCON, n), n


def test_com_root_maps():
    rng = np.random.RandomState(0)
    pos = rng.randn(7, 3)
    q = rng.randn(7, 4)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    lo, hi = -rng.rand(7, 5), rng.rand(7, 5)
    act = rng.uniform(-1.5, 1.5, (7, 5))
    for name, args in (("com2root", (pos, q)), ("root2com", (pos, q)),
                       ("real_to_canonical", (act, lo, hi)),
                       ("canonical_to_real", (act, lo, hi))):
        want = getattr(JTU, name)(*(jnp.asarray(a) for a in args))
        got = getattr(TU, name)(*(_t(a) for a in args))
        close(name, got, want, TOL_FORM, scale=1.0)
    back = TU.root2com(TU.com2root(_t(pos), _t(q)), _t(q))
    close("root2com(com2root)", back, pos, TOL_FORM, scale=1.0)


# ---- the wing-beat pattern generator --------------------------------------


def _tables_equal(got, want):
    np.testing.assert_array_equal(got.table.numpy(), np.asarray(want.table))
    np.testing.assert_array_equal(got.phase_table.numpy(),
                                  np.asarray(want.phase_table))
    np.testing.assert_array_equal(got.cycle_len.numpy(),
                                  np.asarray(want.cycle_len))
    np.testing.assert_array_equal(got.beat_freqs_t.numpy(),
                                  np.asarray(want.beat_freqs_j))
    np.testing.assert_array_equal(got.beat_freqs, want.beat_freqs)
    assert got.table.dtype == got.phase_table.dtype == torch.float32
    assert got.rate == float(want.rate)


def test_wbpg_tables_equal_to_jax():
    """The synthetic base pattern and the generator's tables, bit for bit;
    the tables hold 201 rows, padded with 1e9 phases."""
    np.testing.assert_array_equal(PG.synthetic_base_pattern(),
                                  JPG.synthetic_base_pattern())
    got, want = PG.WingBeatPatternGenerator(), JPG.WingBeatPatternGenerator()
    _tables_equal(got, want)
    assert got.table.shape[0] == 201
    assert int(got.cycle_len.min()) < got.table.shape[1]
    assert float(got.phase_table.max()) == 1e9


def test_wbpg_run_equal_to_jax():
    """Reset at seeded phases, then 60 steps over 8 envs whose requested
    frequencies jump across the band: the integer state exactly, the
    filtered frequency and the angles bit for bit (float32)."""
    Bw = 8
    rng = np.random.RandomState(3)
    jg, pg = JPG.WingBeatPatternGenerator(), PG.WingBeatPatternGenerator()
    phase = rng.rand(Bw)
    ja, jq, js = jax.jit(jax.vmap(lambda p: jg.reset(initial_phase=p)))(
        jnp.asarray(phase))
    pa, pq, ps = pg.reset(_t(phase))
    np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    jstep = jax.jit(jax.vmap(jg.step))
    rel = float(jg.beat_freqs[-1] / jg.base_beat_freq - 1.0)
    # a random walk of the user action with jumps, in float64 as the env
    # computes the request
    act = np.clip(np.cumsum(rng.uniform(-0.6, 0.6, (60, Bw)), axis=0)
                  + rng.choice([0.0, 1.5, -1.5], (60, Bw),
                               p=[0.8, 0.1, 0.1]), -1.0, 1.0)
    seen = set()
    for i in range(60):
        f = jg.base_beat_freq * (1.0 + rel * act[i])
        ja, js = jstep(js, jnp.asarray(f))
        pa, ps = pg.step(ps, _t(f))
        for n in ("freq_idx", "step"):
            np.testing.assert_array_equal(getattr(ps, n).numpy(),
                                          np.asarray(getattr(js, n)),
                                          err_msg=f"{n} at step {i}")
        assert ps.ctrl_freq.dtype == torch.float32
        np.testing.assert_array_equal(ps.ctrl_freq.numpy(),
                                      np.asarray(js.ctrl_freq))
        np.testing.assert_array_equal(pa.numpy(), np.asarray(ja))
        seen.update(ps.freq_idx.tolist())
    assert len(seen) >= 10, sorted(seen)


def test_synthetic_flight_dataset_equal_to_jax():
    want = JTR.synthetic_flight_dataset()
    got = TR.synthetic_flight_dataset()
    assert sorted(got.fields) == sorted(want.fields) == ["com_qpos",
                                                         "com_qvel"]
    for k in want.fields:
        np.testing.assert_array_equal(got.fields[k].numpy(),
                                      np.asarray(want.fields[k]), err_msg=k)
        assert got.fields[k].dtype == torch.float32
    np.testing.assert_array_equal(got.lengths.numpy(),
                                  np.asarray(want.lengths))
    assert (got.num_trajectories, got.max_len) == (4, 3000)
    assert got.timestep == want.timestep


def test_data_files_equal_to_jax(tmp_path):
    """load_hdf5_flight and a recorded base pattern, on files written
    here: both packages load the same dataset and build the same WBPG
    tables, and the factories take the files."""
    import h5py
    rng = np.random.RandomState(4)
    ref = str(tmp_path / "flight.h5")
    with h5py.File(ref, "w") as f:
        f["timestep_seconds"] = 2e-4
        for i, n in enumerate((40, 25, 33)):
            g = f.create_group(f"trajectories/{i:03d}")
            qp = rng.randn(n, 7)
            qp[:, 3:] /= np.linalg.norm(qp[:, 3:], axis=1, keepdims=True)
            g["com_qpos"] = qp
            g["com_qvel"] = rng.randn(n, 6)
    want, got = JTR.load_hdf5_flight(ref), TR.load_hdf5_flight(ref)
    for k in want.fields:
        np.testing.assert_array_equal(got.fields[k].numpy(),
                                      np.asarray(want.fields[k]), err_msg=k)
    np.testing.assert_array_equal(got.lengths.numpy(), [40, 25, 33])
    assert got.timestep == want.timestep
    np.testing.assert_array_equal(got.fields["com_qpos"][:, 0, :2].numpy(),
                                  0.0)
    pat = str(tmp_path / "pattern.npy")
    np.save(pat, (rng.randn(80, 3) * 0.5).astype(np.float32))
    jenv = jax_env(ref_path=ref, wpg_pattern_path=pat)
    penv = FI.make_flight_imitation("cpu", ref_path=ref,
                                    wpg_pattern_path=pat)
    _tables_equal(penv.task.wbpg, jenv.task.wbpg)
    np.testing.assert_array_equal(
        penv.task.dataset.fields["com_qpos"].numpy(),
        np.asarray(jenv.task.dataset.fields["com_qpos"]))


# ---- model asset -----------------------------------------------------------


def test_committed_model_is_a_fresh_export(tmp_path):
    fresh = FI.export_model(str(tmp_path / "m.npz"))
    committed = FI.load_model()
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


def test_builder_matches_jax_mjmodel(envs):
    """The port's MjModel build is the JAX package's, field for field: the
    published flight fly with the wing fluid on, 12 action floats (the
    user action has no ctrl slot). Both packages split the 32 convex
    lanes over the same classes and lay out the fused solve in 64 rows."""
    mine, amap = FI.build_mj_model()
    theirs = envs["jenv"].mj_model
    a, b = io_mj.export_mj(mine), io_mj.export_mj(theirs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (mine.nq, mine.nv, mine.nu, amap["total"]) == (43, 42, 11, 12)
    assert (mine.opt.density, mine.opt.viscosity) == (1.28e-3, 1.85e-4)
    assert int((mine.geom_fluid[:, 0] != 0).sum()) == 2
    pm, jm = envs["penv"].model, envs["jenv"].model
    assert pm.opt.has_fluid
    assert pm.ccd_classes == jm.ccd_classes
    assert [c[4] for c in pm.ccd_classes] == [8, 8, 8, 8]
    assert pm.ncon_max == jm.ncon_max and pm.con_sel == jm.con_sel
    lay = SF.fused_layout(pm, C.efc_meta(pm))
    jlay = JSF.fused_layout(jm, JC.efc_meta(jm))
    for L in (lay, jlay):
        assert (L["R"], L["kl"], L["kc"], L["n_lim"], L["k_cone"]) == \
            (64, 16, 16, 8, 16)
    walker = envs["penv"].task.walker
    user = amap["action"]["user"]
    assert user == [11] and user[0] not in walker.ctrl_from_action
    hover = pm.names["site"]["hover_up_dir"]
    np.testing.assert_array_equal(pm.site_quat[hover].numpy(),
                                  mine.site_quat[hover])


# ---- passive forces with the wing fluid ------------------------------------


def test_passive_with_wing_fluid(envs):
    """passive() on the JAX reset state with wing velocities at the WBPG's
    scale (~1e3 rad/s) and a moving root: both packages on the same
    kinematics; the fluid force is nonzero in every env."""
    jm, pm = envs["jenv"].model, envs["penv"].model
    rng = np.random.RandomState(5)
    pd = to_port(envs["jstate"].data, pm)
    qvel = pd.qvel.clone()
    wing = pm.ix(envs["penv"].task.wing_dofadr)
    qvel[wing] = _t(1e3 * rng.randn(6, B))
    qvel[:6] = _t(np.concatenate([30.0 * rng.randn(3, B),
                                  5.0 * rng.randn(3, B)]))
    pd = F.fwd_velocity(pm, F.fwd_position(pm, pd.replace(qvel=qvel)))
    want = jax.jit(JP.passive)(jm, to_jax(pd, jm))
    got = P.passive(pm, pd)
    fluid = np.asarray(want.qfrc_fluid)
    assert np.all(np.abs(fluid).max(axis=0) > 0)
    for n in ("qfrc_passive", "qfrc_fluid"):
        close(n, getattr(got, n), getattr(want, n), TOL_PASSIVE)


# ---- reset, one control step ----------------------------------------------


def test_reset_with_jax_draws(envs):
    """reset from the JAX package's snippet and phase draws gives its
    state, obs and task state."""
    penv, jst = envs["penv"], envs["jstate"]
    pst = penv.reset(B, traj_idx=_t(jst.task_state.traj_idx),
                     initial_phase=_t(envs["phase"]))
    assert set(pst.obs) == set(jst.obs)
    for k in jst.obs:
        close("obs." + k, pst.obs[k], jst.obs[k], TOL_RESET, scale=1.0)
    for f in ("qpos", "qvel", "xpos", "xquat", "qM", "qfrc_bias",
              "qfrc_fluid"):
        close(f, getattr(pst.data, f), getattr(jst.data, f), TOL_RESET,
              scale=1.0)
    want = _task_state(jst.task_state)
    for f in ("traj_idx", "step", "snippet_len"):
        np.testing.assert_array_equal(getattr(pst.task_state, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    for f in ("freq_idx", "step", "ctrl_freq"):
        np.testing.assert_array_equal(
            getattr(pst.task_state.wbpg, f).numpy(),
            getattr(want.wbpg, f).numpy(), err_msg="wbpg." + f)
    np.testing.assert_array_equal(np.sort(pst.data.contact.sel.numpy(), 0),
                                  np.sort(np.asarray(jst.data.contact.sel),
                                          0))


def test_observation_keys_and_sizes(envs):
    """10 keys and 80 floats per env in both packages; the joint
    observations hold the six wing joints only."""
    sizes = {"accelerometer": 3, "actuator_activation": 11, "gyro": 3,
             "joints_pos": 6, "joints_vel": 6, "ref_displacement": 18,
             "ref_root_quat": 24, "velocimeter": 3, "world_zaxis": 3,
             "world_zaxis_hover": 3}
    pst = envs["penv"].reset(B, torch.Generator().manual_seed(0))
    for obs in (pst.obs, envs["jnext"].obs):
        assert {k: v.shape[1] for k, v in obs.items()} == sizes
    assert sum(sizes.values()) == 80


def test_autoreset_step(envs):
    """One control step from the JAX reset state (no episode ends, so the
    auto-reset draw does not enter): obs, reward, done, discount and the
    state within TOL_STEP of scale, the WBPG state exactly, selections as
    sets."""
    penv, jst, jnext = envs["penv"], envs["jstate"], envs["jnext"]
    assert not bool(np.asarray(jnext.done).any())
    pst = penv.reset(B, traj_idx=_t(jst.task_state.traj_idx),
                     initial_phase=_t(envs["phase"]))
    pst = pst.replace(data=to_port(jst.data, penv.model),
                      task_state=_task_state(jst.task_state))
    nxt = penv.autoreset_step(pst, torch.as_tensor(envs["action"]))
    assert set(nxt.obs) == set(jnext.obs)
    for k in jnext.obs:
        close("obs." + k, nxt.obs[k], jnext.obs[k], TOL_STEP, scale=1.0)
    for f in ("reward", "discount", "step_idx"):
        close(f, getattr(nxt, f), getattr(jnext, f), TOL_STEP, scale=1.0)
    assert float(np.min(np.asarray(jnext.reward))) > 0.9
    np.testing.assert_array_equal(nxt.done.numpy(), np.asarray(jnext.done))
    for f in ("qpos", "qvel", "act", "ctrl", "time", "qfrc_fluid"):
        close(f, getattr(nxt.data, f), getattr(jnext.data, f), TOL_STEP,
              scale=1.0)
    want = _task_state(jnext.task_state)
    np.testing.assert_array_equal(nxt.task_state.step.numpy(),
                                  want.step.numpy())
    for f in ("freq_idx", "step", "ctrl_freq"):
        np.testing.assert_array_equal(
            getattr(nxt.task_state.wbpg, f).numpy(),
            getattr(want.wbpg, f).numpy(), err_msg="wbpg." + f)
    for f in ("warm_sel", "sol_cone_sel", "sol_lim_sel", "ccd_warm_id"):
        np.testing.assert_array_equal(
            np.sort(getattr(nxt.data, f).numpy(), axis=0),
            np.sort(np.asarray(getattr(jnext.data, f)), axis=0), err_msg=f)


def test_reward_termination_discount(envs):
    """reward_term_discount on four envs of the stepped state: as is; the
    fly pushed below TERMINAL_HEIGHT (fatal: discount 0); pushed below at
    the end of its snippet (discount 1); moved 0.5 cm off its reference
    (fatal)."""
    jenv, penv, jnext = envs["jenv"], envs["penv"], envs["jnext"]
    jm, pm, jt = jenv.model, penv.model, jenv.task
    idx = np.array([0, 1, 0, 1])
    take = lambda tree: jax.tree_util.tree_map(lambda x: x[..., idx], tree)
    jd = take(jnext.data)
    qpos, xpos = np.array(jd.qpos), np.array(jd.xpos)
    for e in (1, 2):
        qpos[2, e] -= 0.9
        xpos[:, 2, e] -= 0.9
    qpos[0, 3] += 0.5
    xpos[:, 0, 3] += 0.5
    jd = jd.replace(qpos=jnp.asarray(qpos), xpos=jnp.asarray(xpos))
    step = np.array(jnext.task_state.step)[idx]
    step[2] = np.array(jnext.task_state.snippet_len)[idx][2]
    jts = take(jnext.task_state)
    jts = JFlightState(traj_idx=jts.traj_idx, step=jnp.asarray(step),
                       snippet_len=jts.snippet_len, wbpg=jts.wbpg)
    got = penv.task.reward_term_discount(pm, to_port(jd, pm),
                                         _task_state(jts), None)
    want = jax.jit(jax.vmap(lambda d, s: jt.reward_term_discount(
        jm, d, s, None), in_axes=(-1, -1)))(jd, jts)
    close("reward", got[0], want[0], TOL_FORM, scale=1.0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[1].numpy(), [False, True, True, True])
    np.testing.assert_array_equal(got[2].numpy(), [1.0, 0.0, 1.0, 0.0])
    assert float(got[0][0]) > 0.9 and float(got[0][3]) < float(got[0][0])


def test_walker_helpers(envs):
    """The walker's flight helpers on the stepped state against the JAX
    walker's, env by env."""
    jenv, penv, jnext = envs["jenv"], envs["penv"], envs["jnext"]
    jm, pm = jenv.model, penv.model
    jw, pw = jenv.task.walker, penv.task.walker
    pd = to_port(jnext.data, pm)
    vec = np.random.RandomState(6).randn(B, 3)

    def jax_all(d, v):
        return dict(hover=jw.world_zaxis_hover(jm, d),
                    zbody=jw.world_zaxis_body(d, jw.abdomen_id),
                    thorax=jw.thorax_height(d), abdomen=jw.abdomen_height(d),
                    self_contact=jw.self_contact(jm, d),
                    ego2world=jw.egocentric_to_world(d, v),
                    world2ego=jw.world_to_egocentric(d, v))

    want = jax.jit(jax.vmap(jax_all, in_axes=(-1, 0)))(jnext.data,
                                                       jnp.asarray(vec))
    got = dict(hover=pw.world_zaxis_hover(pm, pd),
               zbody=pw.world_zaxis_body(pd, pw.abdomen_id),
               thorax=pw.thorax_height(pd), abdomen=pw.abdomen_height(pd),
               self_contact=pw.self_contact(pm, pd),
               ego2world=pw.egocentric_to_world(pd, _t(vec)),
               world2ego=pw.world_to_egocentric(pd, _t(vec)))
    assert (pw.hover_site, pw.abdomen_id) == (jw.hover_site, jw.abdomen_id)
    for k in want:
        close(k, got[k], want[k], TOL_FORM, scale=1.0)
    back = pw.egocentric_to_world(pd, got["world2ego"])
    close("ego round trip", back, vec, TOL_FORM, scale=1.0)


# ---- the CLI ----------------------------------------------------------------


def test_cli_flight_imitation_on_cpu():
    """The CLI trains flight_imitation in --test mode on the CPU: 80
    observation floats and 12 actions, and the first iteration's 80
    updates give a finite critic loss."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "flight_imitation", "--test", "--device", "cpu", "--iterations",
         "1"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "task flight_imitation: 80 observation floats, 12 actions" \
        in res.stdout, res.stdout
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=80" in line[0], res.stdout
    loss = float(line[0].split("critic_loss=")[1].split()[0].rstrip(","))
    assert np.isfinite(loss) and loss != 0.0, line[0]
