"""The port's evaluator and rendering against the JAX package (float64,
inputs seeded with numpy): the evaluator's episode loop from a carried
walk_on_ball state and on a toy env whose episodes end early,
walk_imitation's reward channels, the rasterizer's frames bit for bit, and
the reward strip beside the frames."""

import dataclasses
import sys
from typing import NamedTuple
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.agents import distributions as j_dist
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.agents.evaluator import make_evaluator as j_make_evaluator
from flybody_tpu.utils import rendering as j_render
from flybody_tpu_torch.agents import distributions as p_dist
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.agents.evaluator import make_evaluator, save_video
from flybody_tpu_torch.utils import rendering as p_render

from torch_jax_state import close, to_port

torch.set_num_threads(2)

# float64 closed forms in another summation order
TOL_NET = 1e-10
# one walk_on_ball control step is held at 1e-5 of scale
# (test_torch_env.TOL_STEP); the evaluator sums three
TOL_EVAL = 1e-5
# the toy env: the same float64 sums
TOL_TOY = 1e-12


def _t(x):
    return torch.from_numpy(np.array(x))


def _noisy(tree, seed, noise):
    """float64 flax params plus numpy noise (every layer O(1))."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        + noise * rng.normal(size=x.shape),
                        jax.device_get(tree))


# ---- the evaluator --------------------------------------------------------------

class _JState(NamedTuple):
    obs: dict
    reward: jax.Array
    done: jax.Array


@dataclasses.dataclass
class _PState:
    obs: dict
    reward: torch.Tensor
    done: torch.Tensor


class _Toy:
    """Points pushed by their actions; an episode ends (and goes on being
    stepped) once |x0| > 1. ``xp`` is jnp or torch."""
    episode_steps, dtype, device = 5, torch.float64, torch.device("cpu")

    def __init__(self, xp, x0):
        self.xp, self.x0 = xp, x0

    def action_spec(self):
        return np.full(2, -1.0), np.full(2, 1.0)

    def _state(self, x, cls):
        return cls(obs={"x": x, "y": 2.0 * x[:, :1]},
                   reward=-abs(x[:, 0]), done=abs(x[:, 0]) > 1.0)

    def reset(self, *_):
        if self.xp is jnp:
            return self._state(jnp.asarray(self.x0), _JState)
        return self._state(_t(self.x0), _PState)

    def step(self, state, action):
        x = state.obs["x"] + 0.5 * action.sum(-1, keepdims=True)
        return self._state(x, _JState if self.xp is jnp else _PState)


def test_evaluator_against_jax_on_early_ends():
    """A toy env whose episodes end at different steps: the alive mask
    stops each episode's return and length at its first done, as JAX's
    evaluator does."""
    rng = np.random.RandomState(0)
    x0, w = rng.normal(0, 0.5, (6, 3)), rng.normal(0, 1.0, (4, 2))
    want = j_make_evaluator(_Toy(jnp, x0), lambda p, o: j_dist.NormalDiag(
        o @ p, jnp.ones_like(o @ p)), 6)(jnp.asarray(w), jax.random.PRNGKey(0))
    got = make_evaluator(_Toy(torch, x0), 6)(
        lambda o: p_dist.NormalDiag(o @ _t(w), torch.ones(len(o), 2)))
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_TOY)
    assert 1.0 < float(got["eval_episode_length_mean"]) < 5.0


def test_evaluator_against_jax():
    """The evaluator's episode loop on walk_on_ball (3 control steps, 2
    episodes, a plain policy with carried weights) from the JAX reset
    state: the five stats at TOL_EVAL of scale."""
    from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env
    from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball
    n, tl = 2, 0.006
    jenv = jax_env(dtype=jnp.float64, time_limit=tl)
    penv = make_walk_on_ball("cpu", dtype=torch.float64, time_limit=tl)
    assert penv.episode_steps == jenv.episode_steps == 3
    obs = sum(v.shape[1] for v in penv.reset(1).obs.values())
    jpol = j_nets.PolicyNetwork(action_size=penv.action_size,
                                layer_sizes=(32, 32, 32))
    params = _noisy(jpol.init(jax.random.PRNGKey(0), jnp.zeros((1, obs))),
                    0, 0.3)
    ppol = p_nets.PolicyNetwork(obs, penv.action_size, (32, 32, 32)).double()
    ppol.load_state_dict(p_params.policy_state_dict(params))
    rng = jax.random.PRNGKey(3)
    want = j_make_evaluator(jenv, lambda p, o: jpol.apply(p, o), n)(
        jax.tree.map(jnp.asarray, params), rng)
    jstate = jax.jit(jenv.reset)(jax.random.split(rng, n))
    states = penv.reset(n).replace(data=to_port(jstate.data, penv.model))
    got = make_evaluator(penv, n).run(ppol, states)
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_EVAL, scale=1.0)
    assert float(got["eval_episode_length_mean"]) == 3.0
    assert float(got["eval_episode_return_var"]) > 0


# ---- reward channels and rendering ----------------------------------------------

def test_walk_imitation_reward_factors_against_jax():
    """The four DeepMimic channels on a seeded state (noisy pose and
    velocity, each env at its own step of its snippet), the port's batch
    against JAX's vmap; their product is the reward."""
    from flybody_tpu.fly_envs import walk_imitation as jax_env
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.tasks import walk_imitation as WI
    from torch_jax_state import to_jax
    B = 3
    jenv = jax_env(dtype=jnp.float64)
    penv = WI.make_walk_imitation("cpu", dtype=torch.float64)
    pm = penv.model
    st = penv.reset(B, torch.Generator().manual_seed(0))
    rng = np.random.RandomState(2)
    d = st.data.replace(qpos=st.data.qpos + 0.01 * _t(rng.normal(
        size=st.data.qpos.shape)), qvel=st.data.qvel + 0.3 * _t(rng.normal(
            size=st.data.qvel.shape)))
    d = F.fwd_velocity(pm, F.fwd_position(pm, d))
    ts = dataclasses.replace(st.task_state, step=torch.tensor([0, 3, 7]))
    got = penv.task.reward_factors(pm, d, ts, d.sensordata)
    from flybody_tpu.tasks.walk_imitation import ImitationState
    jt = ImitationState(traj_idx=jnp.asarray(ts.traj_idx.numpy()),
                        step=jnp.asarray(ts.step.numpy()),
                        snippet_len=jnp.asarray(ts.snippet_len.numpy()))
    jm = jenv.model
    want = jax.vmap(lambda dd, t: jenv.task.reward_factors(
        jm, dd, t, dd.sensordata), in_axes=(-1, -1))(to_jax(d, jm), jt)
    assert list(got) == ["com", "qvel", "end_effectors", "joints"]
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_NET, scale=1.0)
    reward = penv.task.reward_term_discount(pm, d, ts, d.sensordata)[0]
    assert torch.equal(torch.prod(torch.stack(list(got.values())), 0),
                       reward)


def test_render_frame_bit_for_bit():
    """render_frame on a carried walk_on_ball state: the same C++ source
    with the same flags on the same float32 inputs gives JAX's pixels bit
    for bit; render_depth likewise."""
    from flybody_tpu.tasks.walk_on_ball import make_walk_on_ball as jax_env
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.tasks.walk_on_ball import make_walk_on_ball
    from torch_jax_state import seeded_state, to_jax
    jenv = jax_env(dtype=jnp.float64)
    penv = make_walk_on_ball("cpu", dtype=torch.float64)
    jm, pm = jenv.model, penv.model
    pd = F.fwd_position(pm, to_port(seeded_state(jm, 0, B=1), pm))
    jd = to_jax(pd, jm)
    target = pd.xpos[penv.task.walker.thorax_id, :, 0].numpy()
    cam_pos, cam_mat = p_render.track_camera(target)
    got = p_render.render_frame(pm, pd, cam_pos, cam_mat, width=96,
                                height=72)
    want = j_render.render_frame(jm, jd, cam_pos, cam_mat, width=96,
                                 height=72)
    assert got.shape == (72, 96, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    sky = np.all(got == p_render.SKY, axis=-1)
    assert 0 < sky.sum() < sky.size       # the ball and the fly in view
    np.testing.assert_array_equal(
        p_render.render_depth(pm, pd, cam_pos, cam_mat),
        j_render.render_depth(jm, jd, cam_pos, cam_mat))


def test_render_with_rewards_strip(tmp_path):
    """render_with_rewards on walk_imitation: each frame has the reward
    plot composited to its right; the channels are the task's; save_video
    writes frames it can read back (imageio or the .npz)."""
    from flybody_tpu_torch.fly_envs import walk_imitation
    env = walk_imitation(device="cpu", time_limit=0.02)
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32)[None]
    frames, resets, channels = p_render.render_with_rewards_info(
        env, lambda obs: mid, torch.Generator().manual_seed(0), n_steps=2,
        width=64, height=48)
    assert [f.shape for f in frames] == [(48, 64, 3)] * 2 and resets == []
    assert list(channels[0]) == ["com", "qvel", "end_effectors", "joints"]
    out = p_render.render_with_rewards(env, lambda obs: mid, None,
                                       n_steps=2, width=64, height=48)
    assert [o.shape for o in out] == [(48, 128, 3)] * 2
    strip = out[1][:, 64:]
    assert len(np.unique(strip.reshape(-1, 3), axis=0)) > 2
    # the card has no imageio: the frames go to an .npz
    with mock.patch.dict(sys.modules, {"imageio": None}):
        path = save_video(out, str(tmp_path / "eval.mp4"))
    assert path == str(tmp_path / "eval.mp4.npz")
    np.testing.assert_array_equal(np.load(path)["frames"], np.stack(out))


def test_render_eval_video_in_the_trainers_order():
    """render_eval_video of an intention policy on walk_imitation, given
    the trainer's task-first obs_keys: the policy reads each step's obs in
    that order, and the frames are a hand loop's (the policy's mode
    stepped, env 0 rendered from the tracking camera on its thorax).
    Without obs_keys it refuses."""
    from flybody_tpu_torch.agents.actors import canonical_to_real, flat_obs
    from flybody_tpu_torch.agents.evaluator import render_eval_video
    from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig
    from flybody_tpu_torch.fly_envs import walk_imitation
    env = walk_imitation(device="cpu", time_limit=0.02)
    trainer = DMPOTrainer(env, TrainerConfig(
        num_envs=1, network="intention", intention_size=4,
        encoder_layers=(8,), decoder_layers=(8,), critic_layers=(8,)))
    keys = trainer.obs_keys
    assert list(keys) != sorted(keys)
    seen = []

    def policy(flat):
        seen.append(flat)
        return trainer.policy(flat)

    with pytest.raises(TypeError):
        render_eval_video(env, policy, n_steps=1)
    got = render_eval_video(env, policy, torch.Generator().manual_seed(0),
                            n_steps=2, width=64, height=48, obs_keys=keys)
    lo, hi = (torch.as_tensor(x, dtype=env.dtype) for x in env.action_spec())
    state = env.reset(1, torch.Generator().manual_seed(0))
    thorax = env.task.walker.thorax_id
    assert len(got) == len(seen) == 2
    for frame, flat in zip(got, seen):
        assert torch.equal(flat, flat_obs(state.obs, keys))
        with torch.no_grad():
            state = env.autoreset_step(state, canonical_to_real(
                trainer.policy(flat).mode(), lo, hi))
        cam = p_render.track_camera(state.data.xpos[thorax, :, 0].numpy())
        np.testing.assert_array_equal(frame, p_render.render_frame(
            env.model, state.data, *cam, width=64, height=48))
