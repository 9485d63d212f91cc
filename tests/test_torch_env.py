"""walk_on_ball end to end: the committed model asset, reset, one
autoreset_step and the auto-reset swap, against the JAX package (float64,
B=2, actions from a numpy seed)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env
from flybody_tpu_torch.physics import bridge
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.tasks import walk_on_ball as WOB

torch.set_num_threads(2)

B = 2
# reset: same float64 kinematics in another summation order
TOL_RESET = 1e-10
# one control step = 10 substeps of contact dynamics with iterative
# solvers (20 APGD iterations, BB-step narrowphase); rounding differences
# of ~1e-15 grow through them but stay far below this bound
TOL_STEP = 1e-5


def _close(name, got, want, tol):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.dtype == bool or want.dtype.kind in "iu":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    scale = max(float(np.max(np.abs(want))) if want.size else 0.0, 1.0)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, f"{name}: max err {err:.3e}"


@pytest.fixture(scope="module")
def envs():
    jenv = jax_env(dtype=jnp.float64)
    penv = WOB.make_walk_on_ball("cpu", dtype=torch.float64)
    jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    lo, hi = jenv.action_spec()
    rng = np.random.RandomState(0)
    action = lo + (hi - lo) * rng.rand(B, len(lo))
    jnext = jax.jit(jenv.autoreset_step)(jstate, jnp.asarray(action))
    return dict(jenv=jenv, penv=penv, jstate=jstate, jnext=jnext,
                action=action)


def test_committed_model_is_a_fresh_export(tmp_path):
    """The committed .npz equals what the port's builder exports now."""
    fresh = WOB.export_model(str(tmp_path / "m.npz"))
    committed = WOB.load_model()
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


def test_builder_matches_jax_mjmodel():
    """The port's MjModel build is the JAX package's, field for field."""
    mine, amap = WOB.build_mj_model()
    theirs = jax_env(dtype=jnp.float64).mj_model
    a, b = io_mj.export_mj(mine), io_mj.export_mj(theirs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (mine.nq, mine.nv, mine.nbody, mine.ngeom, mine.nu) == \
        (106, 105, 69, 77, 59)
    assert amap["total"] == 59


def test_reset(envs):
    pst = envs["penv"].reset(B)
    jst = envs["jstate"]
    assert set(pst.obs) == set(jst.obs)
    for k in jst.obs:
        _close("obs." + k, pst.obs[k], jst.obs[k], TOL_RESET)
    for f in ("qpos", "qvel", "xpos", "xmat", "cinert", "qM", "qLD", "cvel",
              "qfrc_bias", "qfrc_passive"):
        _close(f, getattr(pst.data, f), getattr(jst.data, f), TOL_RESET)
    np.testing.assert_array_equal(pst.data.contact.sel.numpy(),
                                  np.asarray(jst.data.contact.sel))
    _close("reward", pst.reward, jst.reward, 0)
    _close("done", pst.done, jst.done, 0)
    _close("discount", pst.discount, jst.discount, 0)


def test_autoreset_step(envs):
    penv, jst, jnext = envs["penv"], envs["jstate"], envs["jnext"]
    data = bridge.data_from_numpy(bridge.to_numpy(jst.data), penv.model)
    pst = penv.reset(B).replace(data=data)
    before = penv.model.tree  # the model is not rebuilt by stepping
    nxt = penv.autoreset_step(pst, torch.as_tensor(envs["action"]))
    assert penv.model.tree is before
    assert set(nxt.obs) == set(jnext.obs)
    for k in jnext.obs:
        _close("obs." + k, nxt.obs[k], jnext.obs[k], TOL_STEP)
    for f in ("reward", "discount", "done", "step_idx"):
        _close(f, getattr(nxt, f), getattr(jnext, f), TOL_STEP)
    for f in ("qpos", "qvel", "act", "ctrl", "time"):
        _close(f, getattr(nxt.data, f), getattr(jnext.data, f), TOL_STEP)
    # selections: near-tied candidates may swap rank after 10 substeps, so
    # compare the selected sets per env
    for f in ("warm_sel", "sol_cone_sel", "sol_lim_sel"):
        _close(f, np.sort(getattr(nxt.data, f).numpy(), axis=0),
               np.sort(np.asarray(getattr(jnext.data, f)), axis=0), 0)
    _close("episode_return", nxt.metrics["episode_return"],
           jnext.metrics["episode_return"], TOL_STEP)


def test_forced_done_swaps_only_state_fields(envs):
    """Auto-reset of env 0: its STATE_FIELDS become the fresh state's,
    every derived field and env 1 stay as they were."""
    penv, jst = envs["penv"], envs["jstate"]
    data = bridge.data_from_numpy(bridge.to_numpy(jst.data), penv.model)
    state = penv.reset(B).replace(data=data)
    moved = state.data.replace(
        qpos=state.data.qpos + 0.01, qvel=state.data.qvel + 0.1,
        time=state.data.time + 1.0, xpos=state.data.xpos + 1.0)
    state = state.replace(
        data=moved, done=torch.tensor([True, False]),
        step_idx=torch.tensor([7, 7], dtype=torch.int32),
        obs={k: v + 1.0 for k, v in state.obs.items()})
    out = penv.apply_autoreset(state)
    fresh = penv.reset(1)
    for f in dataclasses.fields(T.Data):
        if f.name == "contact":
            continue
        got, old = getattr(out.data, f.name), getattr(state.data, f.name)
        assert torch.equal(got[..., 1], old[..., 1]), f.name
        want0 = getattr(fresh.data, f.name)[..., 0] \
            if f.name in T.STATE_FIELDS else old[..., 0]
        assert torch.equal(got[..., 0], want0), f.name
    assert out.step_idx.tolist() == [0, 7]
    assert out.done.tolist() == [True, False]
    for k in out.obs:
        assert torch.equal(out.obs[k][0], fresh.obs[k][0]), k
        assert torch.equal(out.obs[k][1], state.obs[k][1]), k
