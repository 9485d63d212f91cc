"""The template task and the observation wrappers in the port against the
JAX package (float64, numpy seeds): the committed model asset, reset and
one control step at B=2, the action corruptor, DropObservations and
remove_vision, and the CLI's --test mode on the template task.

The JAX control step is jitted once, in the module fixture (about 50 s of
compile on the CPU)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.envs.wrappers import DropObservations as JDrop
from flybody_tpu.tasks.template_task import make_template_task as jax_env
from flybody_tpu_torch.envs import wrappers as W
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.tasks import template_task as TT

from torch_jax_state import close, to_port

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
# reset: the same float64 kinematics in another summation order
TOL_RESET = 1e-10
# one control step = 10 substeps of floor and self contact with the
# matrix-free APGD solver; ~1e-15 rounding differences grow through them
# but stay far below this bound (as test_torch_walk_imitation.TOL_STEP)
TOL_STEP = 1e-5


@pytest.fixture(scope="module")
def envs():
    """Both envs, a JAX reset and one JAX control step from it with
    seeded actions."""
    jenv = jax_env(dtype=jnp.float64)
    penv = TT.make_template_task("cpu", dtype=torch.float64)
    jstate = jax.jit(jenv.reset)(jax.random.split(jax.random.PRNGKey(0), B))
    lo, hi = jenv.action_spec()
    action = lo + (hi - lo) * np.random.RandomState(0).rand(B, len(lo))
    jnext = jax.jit(jenv.step)(jstate, jnp.asarray(action))
    return dict(jenv=jenv, penv=penv, jstate=jstate, jnext=jnext,
                action=action)


def test_committed_model_is_a_fresh_export(tmp_path):
    fresh = TT.export_model(str(tmp_path / "m.npz"))
    committed = TT.load_model()
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


def test_builder_matches_jax_mjmodel(envs):
    """The port's MjModel build is the JAX package's, field for field: the
    free fly on a floor, with put_model's default budgets (the APGD
    solver, a contact selection every substep)."""
    mine, amap = TT.build_mj_model()
    a, b = io_mj.export_mj(mine), io_mj.export_mj(envs["jenv"].mj_model)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (mine.nq, mine.nv, mine.nu, amap["total"]) == (109, 108, 59, 59)
    pm, jm = envs["penv"].model, envs["jenv"].model
    assert pm.opt.contact_solver == jm.opt.contact_solver == "apgd"
    assert pm.col_refresh == 1 and io_mj.fused_dims(pm) == (0, 0, 0)
    assert pm.ccd_classes == jm.ccd_classes
    assert envs["penv"].n_substeps == envs["jenv"].n_substeps == 10


def test_reset(envs):
    penv, jst = envs["penv"], envs["jstate"]
    pst = penv.reset(B)
    assert set(pst.obs) == set(jst.obs)
    for k in jst.obs:
        close("obs." + k, pst.obs[k], jst.obs[k], TOL_RESET, scale=1.0)
    for f in ("qpos", "qvel", "xpos", "xquat", "qM", "qfrc_bias"):
        close(f, getattr(pst.data, f), getattr(jst.data, f), TOL_RESET,
              scale=1.0)


def test_step(envs):
    """One control step from the JAX reset state (no episode ends):
    obs, reward, done, discount and the state within TOL_STEP of scale,
    selections as sets."""
    penv, jst, jnext = envs["penv"], envs["jstate"], envs["jnext"]
    assert not bool(np.asarray(jnext.done).any())
    pst = penv.reset(B)
    pst = pst.replace(data=to_port(jst.data, penv.model))
    nxt = penv.autoreset_step(pst, torch.as_tensor(envs["action"]))
    assert set(nxt.obs) == set(jnext.obs)
    for k in jnext.obs:
        close("obs." + k, nxt.obs[k], jnext.obs[k], TOL_STEP, scale=1.0)
    for f in ("reward", "discount", "step_idx"):
        close(f, getattr(nxt, f), getattr(jnext, f), 0.0, scale=1.0)
    np.testing.assert_array_equal(nxt.done.numpy(), np.asarray(jnext.done))
    for f in ("qpos", "qvel", "act", "ctrl", "time"):
        close(f, getattr(nxt.data, f), getattr(jnext.data, f), TOL_STEP,
              scale=1.0)
    np.testing.assert_array_equal(
        np.sort(nxt.data.warm_sel.numpy(), axis=0),
        np.sort(np.asarray(jnext.data.warm_sel), axis=0))


def test_action_corruptor():
    """The corruptor maps the action before it reaches ctrl."""
    env = TT.make_template_task("cpu", action_corruptor=lambda a: -a)
    st = env.reset(2)
    lo, hi = env.action_spec()
    a = torch.as_tensor(lo + 0.3 * (hi - lo), dtype=torch.float32)[None
                                                                   ].repeat(
        2, 1)
    data, _ = env.task.before_step(env.model, st.data, st.task_state, a)
    plain, _ = TT.TemplateTask(env.task.walker).before_step(
        env.model, st.data, st.task_state, -a)
    assert torch.equal(data.ctrl, plain.ctrl)
    assert float(data.ctrl.abs().max()) > 0


def test_drop_observations(envs):
    """DropObservations removes the named keys from reset, step and
    autoreset_step, as the JAX wrapper does, and passes everything else
    through; remove_vision drops eye and camera keys (none here)."""
    penv = envs["penv"]
    drop = ("force", "touch")
    wrapped = W.DropObservations(penv, drop)
    assert wrapped.model is penv.model
    assert wrapped.action_size == penv.action_size == 59
    want = set(JDrop(envs["jenv"], drop)._filter(envs["jstate"]).obs)
    st = wrapped.reset(B)
    assert set(st.obs) == want == set(penv.reset(B).obs) - set(drop)
    a = torch.zeros((B, penv.action_size), dtype=torch.float64)
    assert set(wrapped.step(st, a).obs) == want
    assert set(wrapped.autoreset_step(st, a).obs) == want
    blind = W.remove_vision(penv)
    assert set(blind.reset(B).obs) == set(penv.reset(B).obs)
    assert blind._drop == ("left_eye", "right_eye", "egocentric_camera")


def test_cli_template_on_cpu():
    """The CLI trains the template task in --test mode on the CPU: the
    trainer reads the env's observation width, and the first iteration's
    80 updates give a finite critic loss."""
    width = sum(v.shape[1] for v in TT.make_template_task(
        "cpu").reset(1).obs.values())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "template", "--test", "--device", "cpu", "--iterations", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert f"task template: {width} observation floats, 59 actions" \
        in res.stdout, res.stdout
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=80" in line[0], res.stdout
    loss = float(line[0].split("critic_loss=")[1].split()[0].rstrip(","))
    assert np.isfinite(loss) and loss != 0.0, line[0]
