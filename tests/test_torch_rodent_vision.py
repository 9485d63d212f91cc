"""The rat's egocentric camera and its vision networks against the JAX
package (float64 on the CPU, inputs seeded with numpy): VisNetRodent on
grayscale and RGB cameras with carried flax weights, the scene geoms the
camera sees, the camera of two arenas from the JAX package's reset draws
(hit distances and hit masks), the heightfield of another seed, the
observation layout, the one-camera VisionPolicy / VisionCritic and two
learner updates with them, and one vision trainer iteration."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu import rodent_envs as jre
from flybody_tpu.agents import dmpo as j_dmpo
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.ops import raycast as JRC
from flybody_tpu.tasks import rodent_tasks as JRT
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.agents import dmpo as p_dmpo
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig

from test_torch_rodent import _jax_init
from torch_jax_state import close, to_jax

torch.set_num_threads(2)

B = 2
# the same float64 kinematics and sensors (test_torch_rodent)
TOL_KIN = 1e-10
# hit distances: the same march and closed forms, float64
TOL_HIT = 1e-9
# networks and learner updates (test_torch_agents)
TOL_NET = 1e-10
TOL_UPDATE = 1e-8
KINDS = ("floor", "gaps")
JAX_FACTORIES = {"floor": jre.rodent_two_touch, "gaps": jre.rodent_run_gaps}
PORT_FACTORIES = {"floor": rodent_envs.rodent_two_touch,
                  "gaps": rodent_envs.rodent_run_gaps}


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def envs(kind):
    """(JAX env, port env) of ``kind``'s task with the camera, float64."""
    return (JAX_FACTORIES[kind](dtype=jnp.float64, use_vision=True),
            PORT_FACTORIES[kind](device="cpu", dtype=torch.float64,
                                 use_vision=True))


def _jax_geoms(task):
    """The geom ids the JAX task's scene raycaster casts against."""
    groups = next(c.cell_contents for c in task._scene_cast.__closure__
                  if isinstance(c.cell_contents, dict))
    return sorted(int(g) for ids, _ in groups.values() for g in ids)


# ---- the camera -------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_scene_geoms_equal_to_jax(kind):
    """The 16 largest primitive geoms outside the head, picked by numpy's
    default sort from the same sizes (the rat's left and right limbs
    tie), in float64 and in float32."""
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        jenv = JAX_FACTORIES[kind](dtype=jdtype, use_vision=True)
        penv = PORT_FACTORIES[kind](device="cpu", dtype=dtype,
                                    use_vision=True)
        got = sorted(int(g) for g in penv.task.camera_geoms)
        assert len(got) == 16 and got == _jax_geoms(jenv.task)
        head = penv.task.walker.head_body_id
        assert not (np.asarray(penv.model.geom_bodyid)[got] == head).any()
    assert (penv.task.height_fn is None) == (kind == "floor")


def test_camera_reads_the_put_models_heights():
    """run_gaps at seed 1: the camera marches the heights written into the
    put model (seed 1's), as the JAX package's built from that seed."""
    jenv = jre.rodent_run_gaps(dtype=jnp.float64, seed=1, use_vision=True)
    penv = rodent_envs.rodent_run_gaps(device="cpu", dtype=torch.float64,
                                       seed=1, use_vision=True)
    base = rodent_envs.rodent_run_gaps(device="cpu", dtype=torch.float64,
                                       use_vision=True)
    rng = np.random.RandomState(3)
    x, y = rng.uniform(-2, 14, 400), rng.uniform(-2, 2, 400)
    got = penv.task.height_fn(_t(x), _t(y))
    close("heights", got, jenv.task._height_fn(jnp.asarray(x),
                                                jnp.asarray(y)), 1e-12,
          scale=1.0)
    assert not torch.equal(got, base.task.height_fn(_t(x), _t(y)))


def _jax_distances(jenv, jd):
    """Each pixel's nearest hit distance of the JAX task's camera in the
    JAX Data ``jd`` (batch-trailing), from its own pose, rays, terrain and
    scene raycaster."""
    task = jenv.task
    head = task.walker.head_body_id

    def one(d):
        pos = d.xpos[head] + d.xmat[head] @ jnp.asarray([0.035, 0.0, 0.0])
        mat = d.xmat[head] @ jnp.asarray(task._cam_fix)
        d_world = jnp.einsum("ij,hwj->hwi", mat,
                             task._cam_rays.astype(jnp.float64))
        t = jnp.full(d_world.shape[:2], jnp.inf, jnp.float64)
        if task._height_fn is not None:
            t = JRC.terrain_hit(pos, d_world, task._height_fn, 4.0)
        return jnp.minimum(t, task._scene_cast(pos, d_world, d.geom_xpos,
                                               d.geom_xmat))
    return np.asarray(jax.jit(jax.vmap(one, in_axes=-1))(jd))


@pytest.mark.parametrize("kind", KINDS)
def test_camera_and_observations_from_jax_draws(kind):
    """The reset state from the JAX package's draws: every observation,
    the camera included, equals the JAX task's observations of the same
    state (the camera's sky pixels exactly, its hits within TOL_HIT of
    255 with the same hit mask), the hit distances of both cameras agree
    where both hit, and obs_layout gives the same keys, sizes and order
    with the camera's 32 x 32."""
    jenv, penv = envs(kind)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    draws = _jax_init(jenv, keys)[0]
    st = penv.reset(B, **draws)
    jd = to_jax(st.data, jenv.model)
    jts = {k: jnp.asarray(_np(v)) for k, v in st.task_state.items()}
    if isinstance(jenv.task, JRT.TwoTouch):
        jts["rng"] = jnp.moveaxis(keys, 0, -1)
    want = jax.jit(jax.vmap(
        lambda d, ts, s: jenv.task.observations(jenv.model, d, ts, s),
        in_axes=(-1, -1, -1)))(jd, jts, jnp.asarray(_np(st.data.sensordata)))
    assert sorted(st.obs) == sorted(want)
    assert st.obs["egocentric_camera"].shape == (B, 32, 32)
    for k in want:
        if k != "egocentric_camera":
            close(k, st.obs[k], want[k], TOL_KIN, scale=1.0)

    jdist = _jax_distances(jenv, jd)
    pdist = _np(penv.task.render_camera(st.data, distance=True))
    jhit, phit = jdist < 4.0, pdist < 4.0
    np.testing.assert_array_equal(phit, jhit)
    close("hit distances", pdist[phit], jdist[jhit], TOL_HIT, scale=1.0)
    cam, jcam = _np(st.obs["egocentric_camera"]), np.asarray(
        want["egocentric_camera"])
    np.testing.assert_array_equal(cam[~phit], jcam[~jhit])
    close("camera hits", cam[phit], jcam[jhit], TOL_HIT, scale=255.0)
    assert np.all((cam >= 0) & (cam <= 255))
    # the floor is neither seen (a plane) nor marched (no heightfield):
    # the two-touch camera sees the rat's own geoms only; the corridor's
    # terrain fills much of the gaps camera
    if kind == "gaps":
        assert phit.mean() > 0.2

    pkeys, pslices = p_nets.obs_layout(st.obs)
    jkeys, jslices = j_nets.obs_layout(want)
    assert pkeys == jkeys and pslices == jslices
    assert pslices["egocentric_camera"][1:] == (1024, (32, 32))
    size = sum(s[1] for s in pslices.values())
    assert size == (165 if kind == "floor" else 162) + 1024


# ---- the vision networks ----------------------------------------------------

ACT = 38
NARROW = ((32, 32, 32), (64, 64, 32))


def _layout(shape=(32, 32)):
    """A rodent-like flat layout: 40 floats, then the camera, then 30."""
    size = int(np.prod(shape))
    return 70 + size, ((40, size, tuple(shape)),)


def _obs_batch(rng, n, obs_size, eyes):
    obs = 3.0 * rng.normal(size=(n, obs_size))
    for s, sz, _ in eyes:
        obs[:, s:s + sz] = rng.uniform(0, 255, (n, sz))
    return obs


def _carried_vision(obs_size, eyes, seed, noise=0.3):
    """JAX one-camera vision networks with float64 params (flax init plus
    numpy noise) and the port's carrying the same weights."""
    jpol = j_nets.VisionPolicy(action_size=ACT, eye_slices=eyes,
                               layer_sizes=NARROW[0])
    jcrit = j_nets.VisionCritic(eye_slices=eyes, layer_sizes=NARROW[1])
    obs0, act0 = jnp.zeros((1, obs_size)), jnp.zeros((1, ACT))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    noisy = lambda tree: jax.tree.map(
        lambda x: np.asarray(x, np.float64) + noise * rng.normal(
            size=x.shape), jax.device_get(tree))
    params = {"policy": noisy(jpol.init(k1, obs0)),
              "critic": noisy(jcrit.init(k2, obs0, act0))}
    ppol = p_nets.VisionPolicy(obs_size, ACT, eyes, NARROW[0]).double()
    pcrit = p_nets.VisionCritic(obs_size, ACT, eyes, NARROW[1]).double()
    ppol.load_state_dict(p_params.policy_state_dict(params["policy"]))
    pcrit.load_state_dict(p_params.critic_state_dict(params["critic"]))
    return jpol, jcrit, params, ppol, pcrit


@pytest.mark.parametrize("shape", [(32, 32), (32, 32, 3)])
def test_visnet_rodent_with_carried_weights(shape):
    """VisNetRodent ("VALID" 3x3 convs at strides 1, 1, 2, 2: 32 -> 30 ->
    28 -> 13 -> 6, 576 floats flattened in flax's (H, W, C) order; an RGB
    camera averaged first), VisionPolicy and VisionCritic on one camera
    slice with carried weights."""
    obs_size, eyes = _layout(shape)
    jpol, jcrit, params, ppol, pcrit = _carried_vision(obs_size, eyes, 0)
    assert isinstance(ppol.vis, p_nets.VisNetRodent)
    assert ppol.vis.dense.in_features == 576
    rng = np.random.RandomState(1)
    obs = _obs_batch(rng, 8, obs_size, eyes)
    act = rng.uniform(-1.5, 1.5, (8, ACT))
    cam = obs[:, 40:40 + eyes[0][1]].reshape((8,) + shape)
    jvis = j_nets.VisNetRodent()
    want = jvis.apply(
        {"params": params["policy"]["params"]["VisNetRodent_0"]},
        jnp.asarray(cam))
    jd = jpol.apply(params["policy"], jnp.asarray(obs))
    jz = jcrit.apply(params["critic"], jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        feat = ppol.vis(_t(cam))
        pdist = ppol(_t(obs))
        pz = pcrit(_t(obs), _t(act))
        tiled = pcrit(_t(obs)[None].expand(3, -1, -1),
                      _t(act)[None].expand(3, -1, -1))
    close("VisNetRodent", feat, want, TOL_NET)
    close("policy mean", pdist.mean, jd.mean, TOL_NET)
    close("policy stddev", pdist.stddev, jd.stddev, TOL_NET)
    close("critic logits", pz.logits, jz.logits, TOL_NET)
    close("critic logits, leading axes", tiled.logits[1], jz.logits, TOL_NET)


def test_vision_front_end_takes_one_or_two_slices():
    with pytest.raises(ValueError, match="image slices"):
        p_nets.VisionPolicy(10, ACT, ())
    obs_size, eyes = _layout()
    with pytest.raises(ValueError, match="image slices"):
        p_nets.VisionPolicy(obs_size, ACT, eyes * 3)


def test_two_learner_updates_with_rodent_vision_nets():
    """Two consecutive DMPOLearner updates with the one-camera vision
    networks from the same carried state on the same batches and action
    normals (test_torch_agents' procedure)."""
    obs_size, eyes = _layout()
    Bt, N = 16, 20
    inits = [_carried_vision(obs_size, eyes, s, noise=0.05)[2]
             for s in range(2)]
    jpol, jcrit = _carried_vision(obs_size, eyes, 0)[:2]
    kw = dict(batch_size=Bt, num_samples=N, target_policy_update_period=1,
              target_critic_update_period=2)
    jlearner = j_dmpo.DMPOLearner(jpol, jcrit, ACT, obs_size,
                                  j_dmpo.DMPOConfig(**kw))
    f64 = lambda tree: jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    jstate = f64(jlearner.init(jax.random.PRNGKey(0)))
    as_j = lambda tree: jax.tree.map(jnp.asarray, tree)
    jstate = jstate.replace(
        policy_params=as_j(inits[0]["policy"]),
        critic_params=as_j(inits[0]["critic"]),
        target_policy_params=as_j(inits[1]["policy"]),
        target_critic_params=as_j(inits[1]["critic"]))
    plearner = p_dmpo.DMPOLearner(
        p_nets.VisionPolicy(obs_size, ACT, eyes, NARROW[0]).double(),
        p_nets.VisionCritic(obs_size, ACT, eyes, NARROW[1]).double(),
        ACT, obs_size, p_dmpo.DMPOConfig(**kw))
    numpy_tree = lambda tree: jax.tree.map(np.asarray,
                                           jax.device_get(tree))
    carried = {f.name: numpy_tree(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    carried["dual_params"] = dataclasses.asdict(carried["dual_params"])
    pstate = p_params.carry_train_state(plearner, carried)

    update = jax.jit(jlearner.update)
    rng = np.random.RandomState(4)
    for step in (1, 2):
        batch = j_dmpo.Transition(
            obs=_obs_batch(rng, Bt, obs_size, eyes),
            action=rng.uniform(-1.2, 1.2, (Bt, ACT)),
            reward=rng.uniform(0, 5, Bt),
            discount=0.99 ** 5 * (rng.uniform(size=Bt) > 0.2),
            next_obs=_obs_batch(rng, Bt, obs_size, eyes))
        _, key = jax.random.split(jstate.rng)
        eps = jax.random.normal(key, (N, Bt, ACT), dtype=jnp.float64)
        jstate, jstats = update(jstate, j_dmpo.Transition(
            *(jnp.asarray(x) for x in dataclasses.astuple(batch))))
        pstats = plearner.update(pstate, p_dmpo.Transition(
            *(_t(x) for x in dataclasses.astuple(batch))), eps=_t(eps))
        assert sorted(pstats) == sorted(jstats)
        for k in jstats:
            close(f"update {step} {k}", pstats[k], jstats[k], TOL_UPDATE)
        for name, carry in (("policy", p_params.policy_state_dict),
                            ("target_policy", p_params.policy_state_dict),
                            ("critic", p_params.critic_state_dict),
                            ("target_critic", p_params.critic_state_dict)):
            want = carry(numpy_tree(getattr(jstate, name + "_params")))
            got = getattr(pstate, name).state_dict()
            assert sorted(got) == sorted(want)
            for k in want:
                close(f"update {step} {name}.{k}", got[k], want[k],
                      TOL_UPDATE)
    assert (pstate.target_policy_copies, pstate.target_critic_copies) == (2, 1)


# ---- the trainer ------------------------------------------------------------


def test_vision_mode_trains_rodent():
    """One DMPOTrainer iteration with the vision networks on the
    two-touch rat's camera (tests/test_agent_modes.py::
    test_vision_mode_trains_rodent): VisNetRodent in both networks,
    finite metrics; an env with no image observation raises."""
    env = rodent_envs.rodent_two_touch(time_limit=0.1, use_vision=True,
                                       device="cpu")
    cfg = TrainerConfig(
        num_envs=2, unroll_length=4, replay_capacity=64, min_replay_size=4,
        samples_per_insert=1.0, network="vision",
        dmpo=p_dmpo.DMPOConfig(batch_size=4, n_step=2, num_samples=3))
    trainer = DMPOTrainer(env, cfg)
    assert isinstance(trainer.policy.vis, p_nets.VisNetRodent)
    assert isinstance(trainer.critic.vis, p_nets.VisNetRodent)
    assert trainer.obs_size == 165 + 1024
    loop = trainer.init(0)
    loop, metrics = trainer.train_iteration(loop)
    assert loop.train.steps == 2
    for k, v in metrics.items():
        assert np.all(np.isfinite(np.asarray(v, dtype=float))), k
    with pytest.raises(ValueError, match="egocentric_camera observation"):
        DMPOTrainer(rodent_envs.rodent_two_touch(device="cpu"), cfg)
