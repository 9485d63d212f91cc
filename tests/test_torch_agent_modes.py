"""The port's agent modes against the JAX package (float64, inputs seeded
with numpy): the intention policy at one and two levels on both paths,
learner updates with the intention-latent KL and with a frozen decoder,
restore_decoder, the intention trainer and the multi-task trainer's
layout and round-robin (the evaluator and rendering:
test_torch_evaluator.py)."""

import dataclasses
import math
from unittest import mock

import numpy as np
import pytest
import torch

import flax
import jax
import jax.numpy as jnp

from flybody_tpu.agents import distributions as j_dist
from flybody_tpu.agents import dmpo as j_dmpo
from flybody_tpu.agents import intention_networks as j_int
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.agents.train import DMPOTrainer as JTrainer
from flybody_tpu_torch.agents import actors as p_actors
from flybody_tpu_torch.agents import dmpo as p_dmpo
from flybody_tpu_torch.agents import intention_networks as p_int
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.agents.dmpo import DMPOConfig
from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig

from torch_jax_state import close

torch.set_num_threads(2)

OBS, TASK, ACT = 40, 9, 7        # flat obs, its task prefix, actions
INT, HL = 6, 5                   # intention and high-level latent sizes
ENC, DEC, CRIT = (16, 16), (24, 24), (32, 32, 16)
LEVELS = {"one_level": None, "two_level": HL}
# float64 closed forms in another summation order
TOL_NET = 1e-10
# two Adam steps through the MPO losses (as test_torch_agents)
TOL_UPDATE = 1e-8


def _t(x):
    return torch.from_numpy(np.array(x))


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _noisy(tree, seed, noise):
    """float64 flax params plus numpy noise (every layer O(1))."""
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: np.asarray(x, np.float64)
                        + noise * rng.normal(size=x.shape), tree)


def _jax_policy(hl):
    return j_int.IntentionPolicy(action_size=ACT, task_obs_size=TASK,
                                 intention_size=INT, encoder_layers=ENC,
                                 decoder_layers=DEC,
                                 high_level_intention_size=hl)


def _port_policy(hl):
    return p_int.IntentionPolicy(OBS, ACT, TASK, INT, ENC, DEC, hl).double()


def _jax_params(jpol, seed, noise=0.3):
    return _noisy(_numpy_tree(jpol.init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, OBS)))), seed, noise)


# ---- the intention policy ---------------------------------------------------

@pytest.mark.parametrize("level", sorted(LEVELS))
def test_intention_policy_against_jax(level):
    """Carried flax variables: the learner path (the mean intention
    decoded) and the actor path (the latents sampled, high level first,
    from the normals JAX drew) at TOL_NET."""
    hl = LEVELS[level]
    jpol = _jax_policy(hl)
    params = _jax_params(jpol, 0)
    ppol = _port_policy(hl)
    ppol.load_state_dict(p_params.policy_state_dict(params))
    obs = 2.0 * np.random.RandomState(1).normal(size=(5, OBS))
    jd, ji = jpol.apply(params, jnp.asarray(obs), method=jpol.with_intention)
    with torch.no_grad():
        pd, pi = ppol.with_intention(_t(obs))
        mean_only = ppol(_t(obs))
    for name, got, want in (("action mean", pd.mean, jd.mean),
                            ("action stddev", pd.stddev, jd.stddev),
                            ("intention mean", pi.mean, ji.mean),
                            ("intention stddev", pi.stddev, ji.stddev)):
        close(name, got, want, TOL_NET)
    assert torch.equal(mean_only.mean, pd.mean)
    assert float(pd.stddev.min()) == float(pd.stddev.max()) == 0.1
    # the encoder heads' floor is 1e-4, not NormalDiagHead's 1e-6
    assert ppol.encoder.head.min_scale == 1e-4

    normals, sample = [], j_dist.NormalDiag.sample

    def recording_sample(dist, key, sample_shape=()):
        normals.append(np.asarray(jax.random.normal(
            key, tuple(sample_shape) + dist.mean.shape, dist.mean.dtype)))
        return sample(dist, key, sample_shape)

    with mock.patch.object(j_dist.NormalDiag, "sample", recording_sample):
        ja, jai = jpol.apply(params, jnp.asarray(obs),
                             rngs={"sample": jax.random.PRNGKey(7)},
                             method=jpol.with_intention)
    assert len(normals) == (2 if hl else 1)
    with torch.no_grad():
        pa, pai = ppol.with_intention(_t(obs), eps=[_t(e) for e in normals])
    close("actor action mean", pa.mean, ja.mean, TOL_NET)
    close("actor intention mean", pai.mean, jai.mean, TOL_NET)
    assert not np.allclose(np.asarray(ja.mean), np.asarray(jd.mean))
    # drawn from a generator: the draws come in the same order
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        drawn = ppol.with_intention(_t(obs), torch.Generator().manual_seed(3))
        g_eps = [torch.randn((5, n), generator=g, dtype=torch.float64)
                 for n in ((HL, INT) if hl else (INT,))]
        fed = ppol.with_intention(_t(obs), eps=g_eps)
    assert torch.equal(drawn[0].mean, fed[0].mean)


def test_decoder_filter_and_init():
    ppol = p_int.IntentionPolicy(OBS, ACT, TASK, INT, ENC, DEC, HL,
                                 generator=torch.Generator().manual_seed(0))
    dec, rest = p_int.decoder_param_filter(ppol.state_dict())
    assert dec and all(k.startswith("decoder.") for k in dec)
    assert rest and not any("decoder" in k for k in rest)
    # the decoder's mean kernel at variance scale 1e-4, zero bias
    w = dec["decoder.mean.weight"].double()
    assert float(w.abs().max()) <= 2 * math.sqrt(1e-4 / DEC[-1]) / 0.8796
    assert float(dec["decoder.mean.bias"].abs().max()) == 0.0
    p_int.freeze_decoder(ppol)
    assert not any(p.requires_grad for p in ppol.decoder.parameters())
    assert all(p.requires_grad for p in ppol.encoder.parameters())


# ---- learner updates ----------------------------------------------------------

def _learners(hl, freeze, **kw):
    """The JAX learner (intention policy, its KL, optionally the decoder
    freeze) at carried float64 params, and the port's learner and state
    carrying them."""
    jpol = _jax_policy(hl)
    jcrit = j_nets.DistributionalCritic(layer_sizes=CRIT)
    jcfg = j_dmpo.DMPOConfig(**kw)
    jlearner = j_dmpo.DMPOLearner(
        jpol, jcrit, ACT, OBS, jcfg,
        intention_apply=lambda p, o: jpol.apply(
            p, o, method=jpol.with_intention),
        policy_tx_wrapper=j_int.freeze_decoder_tx if freeze else None)
    jstate = _f64(jlearner.init(jax.random.PRNGKey(0)))
    crit = lambda s: _noisy(_numpy_tree(jcrit.init(
        jax.random.PRNGKey(s), jnp.zeros((1, OBS)), jnp.zeros((1, ACT)))),
        s, 0.05)
    jstate = jstate.replace(
        policy_params=jax.tree.map(jnp.asarray, _jax_params(jpol, 0, 0.05)),
        target_policy_params=jax.tree.map(jnp.asarray,
                                          _jax_params(jpol, 1, 0.05)),
        critic_params=jax.tree.map(jnp.asarray, crit(0)),
        target_critic_params=jax.tree.map(jnp.asarray, crit(1)))
    ppol = _port_policy(hl)
    if freeze:
        p_int.freeze_decoder(ppol)
    pcrit = p_nets.DistributionalCritic(OBS, ACT, CRIT).double()
    plearner = p_dmpo.DMPOLearner(ppol, pcrit, ACT, OBS,
                                  p_dmpo.DMPOConfig(**kw))
    carried = {f.name: _numpy_tree(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    carried["dual_params"] = dataclasses.asdict(carried["dual_params"])
    return jlearner, jstate, plearner, p_params.carry_train_state(
        plearner, carried)


def _batch(rng, B):
    return dict(obs=2.0 * rng.normal(size=(B, OBS)),
                action=rng.uniform(-1.2, 1.2, (B, ACT)),
                reward=rng.uniform(0, 5, B),
                discount=0.99 ** 5 * (rng.uniform(size=B) > 0.2),
                next_obs=2.0 * rng.normal(size=(B, OBS)))


def _step(jlearner, jstate, plearner, pstate, batch, N, B, update=None):
    _, key = jax.random.split(jstate.rng)
    eps = jax.random.normal(key, (N, B, ACT), dtype=jnp.float64)
    jstate, jstats = (update or jlearner.update)(
        jstate, j_dmpo.Transition(**{k: jnp.asarray(v)
                                     for k, v in batch.items()}))
    pstats = plearner.update(pstate, p_dmpo.Transition(
        **{k: _t(v) for k, v in batch.items()}), eps=_t(eps))
    return jstate, jstats, pstats


@pytest.mark.parametrize("level", sorted(LEVELS))
def test_two_intention_updates_against_jax(level):
    """Two updates from a carried TrainState with the intention-latent KL
    term, fed the JAX normals: stats, networks and duals at TOL_UPDATE;
    target periods 1 and 2."""
    B, N = 16, 10
    kw = dict(batch_size=B, num_samples=N, target_policy_update_period=1,
              target_critic_update_period=2, intention_kl_weight=0.3)
    jlearner, jstate, plearner, pstate = _learners(LEVELS[level], False,
                                                   **kw)
    update = jax.jit(jlearner.update)
    rng = np.random.RandomState(4)
    for step in (1, 2):
        jstate, jstats, pstats = _step(jlearner, jstate, plearner, pstate,
                                       _batch(rng, B), N, B, update)
        assert sorted(pstats) == sorted(jstats)
        assert float(jstats["intention_kl"]) > 0
        for k in jstats:
            close(f"update {step} {k}", pstats[k], jstats[k], TOL_UPDATE)
        for name in ("policy", "target_policy", "critic", "target_critic"):
            carry = p_params.policy_state_dict if "policy" in name \
                else p_params.critic_state_dict
            want = carry(_numpy_tree(getattr(jstate, name + "_params")))
            got = getattr(pstate, name).state_dict()
            assert sorted(got) == sorted(want)
            for k in want:
                close(f"update {step} {name}.{k}", got[k], want[k],
                      TOL_UPDATE)
        for k, v in pstate.dual_params.state_dict().items():
            close(f"update {step} {k}", v, getattr(jstate.dual_params, k),
                  TOL_UPDATE)


def test_frozen_decoder_update_against_jax():
    """One update with the decoder frozen against JAX's freeze_decoder_tx
    chain, the global-norm clip active (1e-3): the decoder stays bit for
    bit, and the encoder's clipped gradients (their norm is the clip, so
    the decoder's counted none) and updated parameters match."""
    B, N, clip = 16, 10, 1e-3
    kw = dict(batch_size=B, num_samples=N, clip_global_norm=clip,
              intention_kl_weight=0.3)
    jlearner, jstate, plearner, pstate = _learners(HL, True, **kw)
    start = {k: v.clone() for k, v in pstate.policy.state_dict().items()}
    batch = _batch(np.random.RandomState(5), B)
    jb = j_dmpo.Transition(**{k: jnp.asarray(v) for k, v in batch.items()})
    # JAX's policy gradients as its update takes them
    @jax.jit
    def policy_grads(state, jb):
        _, key = jax.random.split(state.rng)
        a_t = jlearner._critic_loss(state.critic_params, state, jb, key)[1][2]
        tiled = jnp.broadcast_to(jb.next_obs, (N,) + jb.next_obs.shape)
        q = jlearner.critic.apply(state.target_critic_params,
                                  tiled.reshape(-1, OBS),
                                  a_t.reshape(-1, ACT)).mean().reshape(N, -1)
        return jax.grad(lambda p: jlearner._policy_loss(
            p, state.dual_params, state, jb, a_t, q)[0])(state.policy_params)

    flat = flax.traverse_util.flatten_dict(_numpy_tree(policy_grads(jstate,
                                                                    jb)))
    enc = {k: v for k, v in flat.items() if "decoder" not in k}
    norm = math.sqrt(sum(float(np.sum(v * v)) for v in enc.values()))
    assert norm > clip
    want_grads = p_params.policy_state_dict(flax.traverse_util.unflatten_dict(
        {k: v * clip / norm if k in enc else 0 * v for k, v in flat.items()}))

    jstate, jstats, pstats = _step(jlearner, jstate, plearner, pstate, batch,
                                   N, B, jax.jit(jlearner.update))
    for k in jstats:
        close(f"stat {k}", pstats[k], jstats[k], TOL_UPDATE)
    got_grads = {k: p.grad for k, p in pstate.policy.named_parameters()
                 if p.grad is not None}
    # the decoder has none; nor has the high-level head's scale, which the
    # mean latent does not read (its JAX gradient is zero)
    assert not any("decoder" in k for k in got_grads)
    for k, g in want_grads.items():
        close(f"clipped grad {k}", got_grads.get(k, torch.zeros_like(g)), g,
              TOL_UPDATE)
    assert set(want_grads) - set(got_grads) == {
        k for k in want_grads if "decoder" in k or "high_head.scale" in k}
    got_norm = math.sqrt(sum(float(torch.sum(g * g))
                             for g in got_grads.values()))
    assert abs(got_norm - clip) <= TOL_UPDATE * clip
    want = p_params.policy_state_dict(_numpy_tree(jstate.policy_params))
    got = pstate.policy.state_dict()
    for k in want:
        if "decoder" in k:
            assert torch.equal(got[k], start[k]), k
            np.testing.assert_array_equal(want[k].numpy(), start[k].numpy(),
                                          err_msg=k)
        else:
            close(f"encoder {k}", got[k], want[k], TOL_UPDATE)
            assert torch.equal(got[k], start[k]) == (k not in got_grads), k


def test_restore_decoder_against_jax():
    """The donor's decoder grafted into the online and the target policy,
    as the JAX trainer's restore_decoder grafts it; the rest untouched."""
    _, jstate, _, pstate = _learners(None, False)
    donor = _jax_params(_jax_policy(None), 9)
    jout = JTrainer.restore_decoder(None, jstate, donor)
    out = DMPOTrainer.restore_decoder(None, pstate,
                                      p_params.policy_state_dict(donor))
    assert out is pstate
    for name in ("policy", "target_policy"):
        want = p_params.policy_state_dict(
            _numpy_tree(getattr(jout, name + "_params")))
        got = getattr(pstate, name).state_dict()
        for k in want:
            assert torch.equal(got[k], want[k]), (name, k)
    with pytest.raises(ValueError, match="decoder"):
        DMPOTrainer.restore_decoder(None, pstate,
                                    {"head.mean.weight": torch.zeros(1)})


# ---- the trainers ---------------------------------------------------------------

def test_intention_trainer_on_template_task():
    """The port alone, on the CPU: the intention trainer on the template
    task at B=4 with world_zaxis as the task key (tests/test_agent_modes.py
    does the same in the JAX package): two iterations with finite stats
    and the latent KL, a kickstart from an intention teacher, and
    restore_decoder through the trainer."""
    from flybody_tpu_torch.fly_envs import template_task
    cfg = TrainerConfig(
        num_envs=4, unroll_length=3, replay_capacity=128, min_replay_size=8,
        samples_per_insert=4.0, network="intention", intention_size=8,
        high_level_intention_size=6, task_obs_keys=("world_zaxis",),
        encoder_layers=(32, 32), decoder_layers=(32, 32),
        critic_layers=(32, 32, 32),
        dmpo=DMPOConfig(batch_size=8, n_step=2, num_samples=4,
                        intention_kl_weight=1e-3))
    trainer = DMPOTrainer(template_task(device="cpu", time_limit=0.02), cfg)
    assert trainer.obs_keys[0] == "world_zaxis" and trainer.task_obs_size == 3
    assert isinstance(trainer.policy, p_int.IntentionPolicy)
    loop = trainer.init(0)
    for it in (1, 2):
        loop, metrics = trainer.train_iteration(loop)
        assert metrics["learner_steps"] == 6 * it    # 4 x 3 x 4 / 8
    assert "intention_kl" in metrics
    for k, v in metrics.items():
        assert np.all(np.isfinite(np.asarray(v))), k
    teacher = {k: v.clone() for k, v in loop.train.policy.state_dict().items()}
    trainer.load_teacher(teacher, epsilon=0.1)
    loop, metrics = trainer.train_iteration(loop)
    assert math.isfinite(float(metrics["kickstart_kl"]))
    donor = trainer.init(1).train.policy.state_dict()
    before = {k: v.clone() for k, v in loop.train.policy.state_dict().items()}
    trainer.restore_decoder(loop.train, donor)
    for k, v in loop.train.policy.state_dict().items():
        assert torch.equal(v, donor[k] if "decoder" in k else before[k]), k
    for k, v in loop.train.target_policy.state_dict().items():
        if "decoder" in k:
            assert torch.equal(v, donor[k]), k
    # no task key in the env: a warning, and the encoder reads everything
    with pytest.warns(UserWarning, match="no task_obs_keys"):
        bare = DMPOTrainer(template_task(device="cpu", time_limit=0.02),
                           dataclasses.replace(cfg, task_obs_keys=("nope",)))
    assert bare.task_obs_size == bare.obs_size


def test_multitask_trainer_against_jax():
    """walk_on_ball + walk_imitation at B=2 each: the layout and update
    counts of the JAX constructor, the padded flat obs equal to JAX's
    concat, one iteration training round-robin, and the intention
    variant's refusal of unequal task prefixes."""
    from flybody_tpu import fly_envs as jenvs
    from flybody_tpu.agents.dmpo import DMPOConfig as JDMPOConfig
    from flybody_tpu.agents.multitask import MultiTaskDMPOTrainer as JMT
    from flybody_tpu.agents.train import TrainerConfig as JTrainerConfig
    from flybody_tpu_torch import fly_envs
    from flybody_tpu_torch.agents.multitask import MultiTaskDMPOTrainer
    names = ("walk_on_ball", "walk_imitation")
    num_envs = {k: 2 for k in names}
    kw = dict(unroll_length=4, replay_capacity=2048, min_replay_size=8,
              samples_per_insert=4.0)
    jax_envs = {k: getattr(jenvs, k)(time_limit=0.05) for k in names}
    jtr = JMT(jax_envs, num_envs, JTrainerConfig(**kw, dmpo=JDMPOConfig(
                  batch_size=16, n_step=2)))
    penvs = {k: getattr(fly_envs, k)(device="cpu", time_limit=0.05)
             for k in names}
    cfg = TrainerConfig(**kw, policy_layers=(32, 32, 32),
                        critic_layers=(64, 64, 32),
                        dmpo=DMPOConfig(batch_size=16, n_step=2,
                                        num_samples=4))
    tr = MultiTaskDMPOTrainer(penvs, num_envs, cfg)
    assert tr.names == jtr.names
    assert tr.obs_sizes == jtr.obs_sizes and len(set(tr.obs_sizes.values()))
    assert (tr.obs_size, tr.action_size, tr.updates_per_table) == \
        (jtr.obs_size, jtr.action_size, jtr.updates_per_table) == \
        (max(tr.obs_sizes.values()), 59, 2)
    assert tr.obs_keys == jtr.obs_keys
    loop = tr.init(0)
    for k in names:
        obs = loop.env_states[k].obs
        pad = tr.obs_size - tr.obs_sizes[k]
        got = p_actors.flat_obs(obs, tr.obs_keys[k], pad)
        x = jax.vmap(lambda o: j_nets.batch_concat(o, keys=jtr.obs_keys[k]))(
            {kk: jnp.asarray(v.numpy()) for kk, v in obs.items()})
        want = jnp.concatenate([x, jnp.zeros(x.shape[:-1] + (pad,))], -1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=k)
    loop, metrics = tr.train_iteration(loop)
    assert metrics["learner_steps"] == loop.train.steps == \
        len(names) * tr.updates_per_table
    for k in names:
        assert loop.replays[k].size == 8
        assert loop.replays[k].capacity == 1024
    assert {f"{k}/mean_reward" for k in names} <= set(metrics)
    for k, v in metrics.items():
        assert np.all(np.isfinite(np.asarray(v))), k
    intention = dict(kw, network="intention")
    with pytest.raises(ValueError, match="task-obs prefix"):
        JMT(jax_envs, num_envs, JTrainerConfig(**intention))
    with pytest.raises(ValueError, match="task-obs prefix"):
        MultiTaskDMPOTrainer(penvs, num_envs, TrainerConfig(**intention))


def test_cli_task_envs_on_cpu(tmp_path):
    """--task-envs walk_on_ball:8,walk_imitation:8 in --test mode on the
    CPU: one multi-task iteration trains round-robin over both tables (10
    updates each); a YAML config's task_envs map reaches the same spec."""
    import os
    import subprocess
    import sys
    from flybody_tpu_torch import train_dmpo
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task-envs",
         "walk_on_ball:8,walk_imitation:8", "--test", "--device", "cpu",
         "--iterations", "1", "--samples-per-insert", "4"],
        cwd=root, env=dict(os.environ, OMP_NUM_THREADS="2"),
        capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "task walk_imitation,walk_on_ball:" in res.stdout, res.stdout
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=20" in line[0], res.stdout
    assert "actor_steps=160" in line[0], line[0]
    cfg = tmp_path / "two_tasks.yaml"
    cfg.write_text("run_config:\n  actors_envs:\n    walk_on_ball: 8\n"
                   "    walk-imitation: 4\n    flight_imitation: 0\n")
    args = train_dmpo.parse_args(["--config", str(cfg)])
    assert train_dmpo.task_envs_of(args) == {"walk_on_ball": 8,
                                             "walk_imitation": 4}
