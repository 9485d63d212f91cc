"""The port's DMPO agent stack against the JAX package (float64, inputs
seeded with numpy): distributions, the networks with carried weights and
their init, the categorical projection, the MPO loss and its gradients,
two learner updates from a carried TrainState, replay semantics and the
n-step assembly."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.agents import actors as j_actors
from flybody_tpu.agents import distributions as j_dist
from flybody_tpu.agents import dmpo as j_dmpo
from flybody_tpu.agents import losses_mpo as j_mpo
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.agents import replay as j_replay
from flybody_tpu_torch.agents import actors as p_actors
from flybody_tpu_torch.agents import distributions as p_dist
from flybody_tpu_torch.agents import dmpo as p_dmpo
from flybody_tpu_torch.agents import losses_mpo as p_mpo
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.agents.replay import ReplayBuffer

torch.set_num_threads(2)

OBS, ACT = 289, 59       # walk_on_ball's flat observation and action
NARROW = ((32, 32, 32), (64, 64, 32))
FULL = ((256, 256, 256), (512, 512, 256))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(name, got, want, rtol):
    """max |got - want| <= rtol * max |want| (the tensor's own scale)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(float(np.max(np.abs(want))), 1e-300)
    err = float(np.max(np.abs(got - want)))
    assert err <= rtol * scale, f"{name}: max err {err:.3e}, scale {scale:.3e}"


def _f64(tree):
    return jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


# ---- distributions ------------------------------------------------------

def test_normal_diag_and_kl_against_jax():
    rng = np.random.RandomState(0)
    mean, std = rng.normal(size=(4, ACT)), rng.uniform(0.1, 2.0, (4, ACT))
    mean2, std2 = rng.normal(size=(4, ACT)), rng.uniform(0.1, 2.0, (4, ACT))
    x = 2.0 * rng.normal(size=(3, 4, ACT))
    jp, jq = j_dist.NormalDiag(mean, std), j_dist.NormalDiag(mean2, std2)
    pp, pq = (p_dist.NormalDiag(_t(mean), _t(std)),
              p_dist.NormalDiag(_t(mean2), _t(std2)))
    _close("log_prob_per_dim", pp.log_prob_per_dim(_t(x)),
           jp.log_prob_per_dim(x), 1e-12)
    _close("log_prob", pp.log_prob(_t(x)), jp.log_prob(x), 1e-12)
    _close("entropy", pp.entropy(), jp.entropy(), 1e-12)
    _close("kl", p_dist.kl_normal_diag_per_dim(pp, pq),
           j_dist.kl_normal_diag_per_dim(jp, jq), 1e-12)
    # sample = mean + stddev * eps on the normals JAX draws
    key = jax.random.PRNGKey(3)
    eps = jax.random.normal(key, (5, 4, ACT), dtype=jnp.float64)
    _close("sample", pp.transform(_t(eps)), jp.sample(key, (5,)), 1e-12)
    # the port's own sample draws its normals from the generator
    got = pp.sample(torch.Generator().manual_seed(7), (5,))
    eps_p = torch.randn((5, 4, ACT), generator=torch.Generator().manual_seed(
        7), dtype=torch.float64)
    assert torch.equal(got, pp.transform(eps_p))
    assert torch.equal(pp.mode(), pp.mean)
    logits, values = rng.normal(size=(6, 51)), np.linspace(-150, 150, 51)
    _close("discrete mean", p_dist.DiscreteValued(_t(logits), _t(values))
           .mean(), j_dist.DiscreteValued(logits, values).mean(), 1e-12)


# ---- networks -----------------------------------------------------------

def _carried_nets(policy_layers, critic_layers, seed=0, noise=0.3):
    """JAX networks with float64 params (flax init plus numpy noise, so
    every layer and the softplus head see O(1) values) and the port's
    networks carrying the same weights."""
    jpol, jcrit, jinit = j_nets.make_policy_critic(
        ACT, OBS, policy_layers=policy_layers, critic_layers=critic_layers)
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x, np.float64)
        + noise * rng.normal(size=x.shape), _numpy_tree(
            jinit(jax.random.PRNGKey(seed))))
    ppol = p_nets.PolicyNetwork(OBS, ACT, policy_layers).double()
    pcrit = p_nets.DistributionalCritic(OBS, ACT, critic_layers).double()
    ppol.load_state_dict(p_params.policy_state_dict(params["policy"]))
    pcrit.load_state_dict(p_params.critic_state_dict(params["critic"]))
    return jpol, jcrit, params, ppol, pcrit


@pytest.mark.parametrize("policy_layers,critic_layers", [NARROW, FULL],
                         ids=["narrow", "full"])
def test_networks_forward_with_carried_weights(policy_layers, critic_layers):
    jpol, jcrit, params, ppol, pcrit = _carried_nets(policy_layers,
                                                      critic_layers)
    rng = np.random.RandomState(1)
    obs = 3.0 * rng.normal(size=(16, OBS))
    act = rng.uniform(-1.5, 1.5, (16, ACT))      # some outside the clip
    jd = jpol.apply(params["policy"], jnp.asarray(obs))
    with torch.no_grad():
        pdist = ppol(_t(obs))
        pz = pcrit(_t(obs), _t(act))
    _close("policy mean", pdist.mean, jd.mean, 1e-10)
    _close("policy stddev", pdist.stddev, jd.stddev, 1e-10)
    jz = jcrit.apply(params["critic"], jnp.asarray(obs), jnp.asarray(act))
    _close("critic logits", pz.logits, jz.logits, 1e-10)
    _close("critic values", pz.values, jz.values, 1e-12)
    _close("critic mean", pz.mean(), jz.mean(), 1e-10)


def test_init_follows_flax():
    """Fresh port networks have flax's init: truncated-normal kernels of
    stddev sqrt(scale / fan_in) cut at 2 / 0.8796 of it, zero biases,
    LayerNorm 1 / 0; one seed gives the same weights in every dtype."""
    policy_layers, critic_layers = NARROW
    jparams = _numpy_tree(j_nets.make_policy_critic(
        ACT, OBS, policy_layers=policy_layers,
        critic_layers=critic_layers)[2](jax.random.PRNGKey(0)))
    ppol, pcrit = p_nets.make_policy_critic(
        ACT, OBS, policy_layers=policy_layers, critic_layers=critic_layers,
        generator=torch.Generator().manual_seed(0))
    for mine, theirs in ((ppol.state_dict(),
                          p_params.policy_state_dict(jparams["policy"])),
                         (pcrit.state_dict(),
                          p_params.critic_state_dict(jparams["critic"]))):
        assert sorted(mine) == sorted(theirs)
        for k, w in mine.items():
            want = theirs[k].numpy()
            assert w.shape == want.shape, k
            if k.endswith("bias") or "norm" in k:
                np.testing.assert_array_equal(w.numpy(), want, err_msg=k)
                continue
            scale = 1e-4 if k.startswith("head.") else 1.0
            std = np.sqrt(scale / w.shape[1])
            got = w.double().numpy()
            assert np.abs(got).max() <= 2 * std / 0.87962566 * (1 + 1e-6), k
            # the sample std of n truncated normals: 1 +- a few / sqrt(n)
            tol = 5.0 / np.sqrt(got.size)
            assert abs(got.std() / std - 1) < tol, (k, got.std() / std)
            assert abs(want.std() / std - 1) < tol, (k, want.std() / std)
    again = p_nets.PolicyNetwork(OBS, ACT, policy_layers,
                                 generator=torch.Generator().manual_seed(0))
    for k, w in again.double().state_dict().items():
        assert torch.equal(w.float(), ppol.state_dict()[k]), k


# ---- categorical projection and the MPO loss ----------------------------

def test_categorical_l2_project_against_jax():
    rng = np.random.RandomState(2)
    z_q = np.linspace(-150.0, 150.0, 51)
    z_p = rng.uniform(-200.0, 200.0, (8, 51))
    z_p[0] = z_q                       # exactly on the atoms
    z_p[1] = z_q * 0.99 + 1.0          # a discounted shift
    probs = rng.dirichlet(np.ones(51), size=8)
    got = p_dmpo.categorical_l2_project(_t(z_p), _t(probs), _t(z_q))
    want = j_dmpo.categorical_l2_project(jnp.asarray(z_p), jnp.asarray(probs),
                                         jnp.asarray(z_q))
    _close("projection", got, want, 1e-12)
    np.testing.assert_allclose(_np(got).sum(-1), 1.0, rtol=1e-12)


_MPO_CASES = {
    "default": dict(),
    "summed_kl_real_cost": dict(per_dim_constraining=False),
    "no_penalty": dict(action_penalization=False),
}


@pytest.mark.parametrize("case", sorted(_MPO_CASES))
def test_mpo_loss_stats_and_grads_against_jax(case):
    N, B, D = 20, 8, ACT
    rng = np.random.RandomState(3)
    lo, hi = -rng.uniform(0.5, 2, D), rng.uniform(0.5, 2, D)
    kw = dict(_MPO_CASES[case])
    if case == "summed_kl_real_cost":
        jcfg = j_mpo.MPOConfig(penalization_cost=(
            j_mpo.penalization_cost_real_actions(lo, hi)), **kw)
        pcfg = p_mpo.MPOConfig(penalization_cost=(
            p_mpo.penalization_cost_real_actions(lo, hi)), **kw)
    else:
        jcfg, pcfg = j_mpo.MPOConfig(**kw), p_mpo.MPOConfig(**kw)
    duals = dict(log_temperature=rng.uniform(-1, 2, 1),
                 log_alpha_mean=rng.uniform(-2, 3, D),
                 log_alpha_stddev=rng.uniform(5, 12, D),
                 log_penalty_temperature=rng.uniform(-1, 2, 1))
    duals["log_alpha_mean"][0] = -20.0     # below the clip at -18
    om, os_ = rng.normal(size=(B, D)), rng.uniform(0.2, 1.5, (B, D))
    tm = om + 0.05 * rng.normal(size=(B, D))
    ts = os_ * rng.uniform(0.9, 1.1, (B, D))
    actions = tm + ts * rng.normal(size=(N, B, D))
    q = 5.0 * rng.normal(size=(N, B))

    def jloss(mean, std, d):
        return j_mpo.mpo_loss(jcfg, d, j_dist.NormalDiag(mean, std),
                              j_dist.NormalDiag(tm, ts), actions, q)

    jd = j_mpo.DualParams(**{k: jnp.asarray(v) for k, v in duals.items()})
    (jl, jstats), grads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(om),
                                                jnp.asarray(os_), jd)
    pm, ps = _t(om).requires_grad_(), _t(os_).requires_grad_()
    pd = p_mpo.DualParams(**{k: _t(v).requires_grad_()
                             for k, v in duals.items()})
    pl, pstats = p_mpo.mpo_loss(pcfg, pd, p_dist.NormalDiag(pm, ps),
                                p_dist.NormalDiag(_t(tm), _t(ts)),
                                _t(actions), _t(q))
    pl.backward()
    _close("loss", pl, jl, 1e-9)
    assert sorted(pstats) == sorted(jstats)
    for k in jstats:
        _close(k, pstats[k], jstats[k], 1e-9)
    _close("grad mean", pm.grad, grads[0], 1e-9)
    _close("grad stddev", ps.grad, grads[1], 1e-9)
    for k in duals:
        g = getattr(pd, k).grad      # None: the loss does not use it
        _close(f"grad {k}", torch.zeros(1) if g is None else g,
               getattr(grads[2], k), 1e-9)
    assert float(pd.log_alpha_mean.grad[0]) == 0.0     # clipped entry


# ---- two learner updates from a carried JAX TrainState ------------------

def _transition(rng, B, module):
    return module.Transition(
        obs=3.0 * rng.normal(size=(B, OBS)),
        action=rng.uniform(-1.2, 1.2, (B, ACT)),
        reward=rng.uniform(0, 5, B),
        discount=0.99 ** 5 * (rng.uniform(size=B) > 0.2),
        next_obs=3.0 * rng.normal(size=(B, OBS)))


@pytest.mark.parametrize("regularized", [False, True],
                         ids=["plain", "kickstart_and_prior"])
def test_two_learner_updates_against_jax(regularized):
    """Two consecutive updates from the same carried state on the same
    batches and the same action normals; target periods 1 and 2, so the
    policy target copies twice and the critic target once."""
    B, N = 16, 20
    policy_layers, critic_layers = NARROW
    jpol, jcrit, _ = j_nets.make_policy_critic(
        ACT, OBS, policy_layers=policy_layers, critic_layers=critic_layers)
    inits = [jax.tree.map(jnp.asarray, _carried_nets(
        policy_layers, critic_layers, seed=s, noise=0.05)[2])
        for s in range(3)]
    kw = dict(batch_size=B, num_samples=N, target_policy_update_period=1,
              target_critic_update_period=2)
    if regularized:
        kw.update(kl_to_prior_weight=0.1, kickstart_epsilon=0.05)
    jcfg = j_dmpo.DMPOConfig(
        **kw, teacher_apply=(lambda o: jpol.apply(inits[2]["policy"], o))
        if regularized else None)
    jlearner = j_dmpo.DMPOLearner(jpol, jcrit, ACT, OBS, jcfg)
    jstate = _f64(jlearner.init(jax.random.PRNGKey(0)))
    jstate = jstate.replace(
        policy_params=inits[0]["policy"], critic_params=inits[0]["critic"],
        target_policy_params=inits[1]["policy"],
        target_critic_params=inits[1]["critic"])

    ppol, pcrit = p_nets.make_policy_critic(
        ACT, OBS, policy_layers=policy_layers, critic_layers=critic_layers)
    teacher = None
    if regularized:
        teacher = p_nets.PolicyNetwork(OBS, ACT, policy_layers).double()
        teacher.load_state_dict(p_params.policy_state_dict(
            _numpy_tree(inits[2]["policy"])))
    plearner = p_dmpo.DMPOLearner(
        ppol.double(), pcrit.double(), ACT, OBS,
        p_dmpo.DMPOConfig(**kw, teacher_apply=teacher))
    carried = {f.name: _numpy_tree(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    carried["dual_params"] = dataclasses.asdict(carried["dual_params"])
    pstate = p_params.carry_train_state(plearner, carried)

    update = jax.jit(jlearner.update)
    rng = np.random.RandomState(4)
    for step in (1, 2):
        batch = _transition(rng, B, j_dmpo)
        _, key = jax.random.split(jstate.rng)
        eps = jax.random.normal(key, (N, B, ACT), dtype=jnp.float64)
        jstate, jstats = update(jstate, j_dmpo.Transition(
            *(jnp.asarray(x) for x in dataclasses.astuple(batch))))
        pstats = plearner.update(pstate, p_dmpo.Transition(
            *(_t(x) for x in dataclasses.astuple(batch))), eps=_t(eps))
        assert sorted(pstats) == sorted(jstats)
        for k in jstats:
            _close(f"update {step} {k}", pstats[k], jstats[k], 1e-8)
        assert pstate.steps == int(jstate.steps) == step
        for name, carry in (("policy", p_params.policy_state_dict),
                            ("target_policy", p_params.policy_state_dict),
                            ("critic", p_params.critic_state_dict),
                            ("target_critic", p_params.critic_state_dict)):
            want = carry(_numpy_tree(getattr(jstate, name + "_params")))
            got = getattr(pstate, name).state_dict()
            for k in want:
                _close(f"update {step} {name}.{k}", got[k], want[k], 1e-8)
        for k, v in pstate.dual_params.state_dict().items():
            _close(f"update {step} {k}", v, getattr(jstate.dual_params, k),
                   1e-8)
    assert (pstate.target_policy_copies, pstate.target_critic_copies) == (2, 1)


# ---- replay -------------------------------------------------------------

def test_replay_ring_wraps_fifo_like_jax():
    """Overwrite-oldest: after overflow the ring holds the newest
    `capacity` items, slot for slot as the JAX ring."""
    cap = 8
    pbuf = ReplayBuffer(cap, {"x": torch.zeros((1,), dtype=torch.int32)})
    jstate = j_replay.replay_init(cap, {"x": jnp.zeros((1,), jnp.int32)})
    for start in range(0, 12, 3):
        pbuf.insert({"x": torch.arange(start, start + 3, dtype=torch.int32)})
        jstate = j_replay.replay_insert(
            jstate, {"x": jnp.arange(start, start + 3, dtype=jnp.int32)})
        assert (pbuf.size, pbuf.insert_pos) == (int(jstate.size),
                                                int(jstate.insert_pos))
    assert pbuf.size == cap
    np.testing.assert_array_equal(pbuf.storage["x"].numpy(),
                                  np.asarray(jstate.storage["x"]))
    assert set(pbuf.storage["x"].tolist()) == set(range(4, 12))
    with pytest.raises(ValueError):
        pbuf.insert({"x": torch.zeros(cap + 1, dtype=torch.int32)})


def test_replay_sample_uniform_over_filled_prefix():
    cap = 64
    buf = ReplayBuffer(cap, {"x": torch.zeros((1,), dtype=torch.int64)})
    buf.insert({"x": torch.arange(10, 26)})
    assert buf.size == 16
    vals = buf.sample(torch.Generator().manual_seed(0), 4096)["x"].numpy()
    assert vals.min() >= 10 and vals.max() < 26
    counts = np.bincount(vals - 10, minlength=16)
    # with replacement, 4096 draws over 16 bins: each ~256 +- 5 sigma
    assert counts.min() > 256 - 5 * 16 and counts.max() < 256 + 5 * 16


def test_replay_transitions_round_trip():
    ex = p_dmpo.Transition(obs=torch.zeros(1, 4), action=torch.zeros(1, 2),
                           reward=torch.zeros(1), discount=torch.zeros(1),
                           next_obs=torch.zeros(1, 4))
    buf = ReplayBuffer(8, ex)
    batch = p_dmpo.Transition(obs=torch.arange(20.0).reshape(5, 4),
                              action=torch.ones(5, 2),
                              reward=torch.arange(5.0),
                              discount=torch.ones(5),
                              next_obs=-torch.arange(20.0).reshape(5, 4))
    buf.insert(batch)
    buf.insert(batch)                                   # wraps
    assert (buf.size, buf.insert_pos) == (8, 2)
    got = buf.sample(torch.Generator().manual_seed(1), 16)
    assert isinstance(got, p_dmpo.Transition) and got.obs.shape == (16, 4)
    # every sampled row is one inserted transition, fields kept together
    idx = got.reward.long()
    assert torch.equal(got.obs, batch.obs[idx])
    assert torch.equal(got.next_obs, batch.next_obs[idx])


# ---- n-step assembly ----------------------------------------------------

def test_nstep_from_trajectory_against_jax():
    """A seeded (T, B) trajectory behind the inert seed tail, with dones
    inside windows and at the seam."""
    U, B, n, obs = 12, 5, 5, 7
    rng = np.random.RandomState(5)
    traj = dict(obs=rng.normal(size=(U, B, obs)),
                action=rng.normal(size=(U, B, 3)),
                reward=rng.normal(size=(U, B)),
                discount=(rng.uniform(size=(U, B)) > 0.3).astype(np.float64),
                done=rng.uniform(size=(U, B)) < 0.25,
                obs_after=rng.normal(size=(U, B, obs)),
                episode_return=rng.normal(size=(U, B)))
    traj["done"][0, :2] = True                           # at the seam
    jcfg = j_actors.RolloutConfig(unroll_length=U, n_step=n, discount=0.97)
    pcfg = p_actors.RolloutConfig(unroll_length=U, n_step=n, discount=0.97)
    jtail = j_actors.init_rollout_tail(jcfg, B, obs, 3)
    ptail = p_actors.init_rollout_tail(pcfg, B, obs, 3, dtype=torch.float64)
    for k in jtail:
        np.testing.assert_array_equal(ptail[k].numpy(), np.asarray(jtail[k]))
    jfull = {k: np.concatenate([np.asarray(jtail[k], traj[k].dtype),
                                traj[k]]) for k in traj}
    want = j_actors.nstep_from_trajectory(
        {k: jnp.asarray(v) for k, v in jfull.items()}, jcfg)
    got = p_actors.nstep_from_trajectory(
        {k: _t(v) for k, v in jfull.items()}, pcfg)
    for f in dataclasses.fields(want):
        _close(f.name, getattr(got, f.name), getattr(want, f.name), 1e-12)
    assert got.obs.shape == (U * B, obs)


def test_canonical_to_real_against_jax():
    rng = np.random.RandomState(6)
    a, lo = 1.5 * rng.normal(size=(4, ACT)), -rng.uniform(0.1, 2, ACT)
    hi = rng.uniform(0.1, 2, ACT)
    _close("real", p_actors.canonical_to_real(_t(a), _t(lo), _t(hi)),
           j_actors.canonical_to_real(a, lo, hi), 1e-12)
