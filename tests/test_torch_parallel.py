"""Data-parallel training over two ranks against one process and the JAX
package's mesh (float64 on the CPU, gloo, inputs seeded with numpy):
process_env_slice, each rank's shard of a loop state against the JAX
package's loop_shardings on a 2-device mesh, a sharded env step, two
learner updates on the halves of a batch, the dry run, the multi-task
trainer and the CLI on two ranks. The two ranks are spawned once for the
module (``two_ranks``)."""

import csv
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from flybody_tpu.agents import dmpo as j_dmpo
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.agents import replay as j_replay
from flybody_tpu.agents import train as j_train
from flybody_tpu.envs import core as j_core
from flybody_tpu.fly_envs import walk_on_ball as j_walk_on_ball
from flybody_tpu.parallel.mesh import make_mesh, shard_loop_state as j_shard
from flybody_tpu_torch import fly_envs
from flybody_tpu_torch.agents import dmpo as p_dmpo
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.agents.dmpo import DMPOConfig
from flybody_tpu_torch.agents.replay import ReplayBuffer
from flybody_tpu_torch.agents.train import LoopState, TrainerConfig
from flybody_tpu_torch.envs.core import EnvState
from flybody_tpu_torch.parallel import distributed as D
from flybody_tpu_torch.parallel import dryrun
from flybody_tpu_torch.parallel import mesh as M
from flybody_tpu_torch.physics import bridge

from torch_jax_state import close, seeded_state, to_port

torch.set_num_threads(2)

W = 2
OBS, ACT = 289, 59       # walk_on_ball's flat observation and action
NARROW = ((32, 32, 32), (64, 64, 32))
BATCH, N = 16, 20
# two ranks' mean of half-batch gradients against the whole batch's, and
# every stat reduced over the ranks: float64 sums in another order
TOL_SPLIT = 1e-10
# learner updates against the JAX package's (test_torch_agents)
TOL_UPDATE = 1e-8


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _numpy_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def test_process_env_slice(monkeypatch):
    assert D.process_env_slice(12) == (12, 0)
    monkeypatch.setattr(D, "world_size", lambda: 4)
    monkeypatch.setattr(D, "rank", lambda: 2)
    assert D.process_env_slice(12) == (3, 6)
    assert D.share(8, "batch_size") == 2
    with pytest.raises(ValueError, match="does not divide over 4 ranks"):
        D.process_env_slice(10)
    assert not D.init("cpu")          # one process: no group
    assert D.rank_seed(7, 0) == 7 and D.rank_seed(7, 1) != D.rank_seed(7, 2)


# ---- the plan of the shards -------------------------------------------------


def _device_shard(x, mesh, r):
    """The JAX array ``x``'s data on the mesh's device r."""
    dev = mesh.devices[r]
    return np.asarray(next(s.data for s in x.addressable_shards
                           if s.device == dev))


def test_shards_equal_the_jax_plan():
    """A seeded walk_on_ball loop state of 4 envs: every field of rank r's
    LoopState shard (Data, obs, reward, done, discount, step_idx, task
    state, metrics, the replay storage and the rollout tail) equals what
    the JAX package's loop_shardings puts on device r of make_mesh(2)."""
    Bn, cap = 4, 8
    jm = j_walk_on_ball(time_limit=0.05, dtype=jnp.float64).model
    pm = fly_envs.walk_on_ball(device="cpu", dtype=torch.float64).model
    rng = np.random.RandomState(0)
    jd = seeded_state(jm, 0, B=Bn)
    lead = {"obs": {"a": rng.normal(size=(Bn, 3)),
                    "b": rng.normal(size=(Bn, 2, 2))},
            "reward": rng.normal(size=Bn), "done": rng.uniform(size=Bn) > .5,
            "discount": rng.uniform(size=Bn),
            "step_idx": rng.randint(0, 9, Bn).astype(np.int32),
            "metrics": {"m": rng.normal(size=Bn)}}
    task_state = {"t": rng.normal(size=(5, Bn)), "u": rng.normal(size=Bn)}
    storage = {"obs": rng.normal(size=(cap, 5)),
               "reward": rng.normal(size=cap)}
    tail = {"obs": rng.normal(size=(4, Bn, 5)),
            "done": rng.uniform(size=(4, Bn)) > .5}
    as_j = lambda tree: jax.tree.map(jnp.asarray, tree)
    jes = j_core.EnvState(
        data=jd, rng=jax.random.split(jax.random.PRNGKey(0), Bn),
        task_state=as_j(task_state), **as_j(lead))
    jloop = j_train.LoopState(
        train={"w": jnp.ones(3)}, env_states=jes,
        replay=j_replay.ReplayState(storage=as_j(storage),
                                    insert_pos=jnp.int32(6),
                                    size=jnp.int32(6)),
        rng=jax.random.PRNGKey(1), actor_steps=jnp.int32(0),
        rollout_tail=as_j(tail))
    mesh = make_mesh(W)
    placed = j_shard(mesh, jloop)

    as_p = lambda tree: jax.tree.map(_t, tree)
    replay = ReplayBuffer(cap, {k: _t(v[:1]) for k, v in storage.items()})
    replay.storage = as_p(storage)
    replay.size = replay.insert_pos = 6
    ploop = LoopState(
        train=None, env_states=EnvState(
            data=to_port(jd, pm), rng=None, task_state=as_p(task_state),
            **as_p(lead)),
        replay=replay, generator=None, actor_steps=0,
        rollout_tail=as_p(tail))
    for r in range(W):
        gen = torch.Generator()
        shard = M.shard_loop_state(ploop, r, W, generator=gen)
        es, jes_r = shard.env_states, placed.env_states
        got = bridge.to_numpy(es.data)
        want = bridge.to_numpy(jax.tree.map(
            lambda x: _device_shard(x, mesh, r), jes_r.data))
        assert sorted(got) == sorted(want)
        flat_got = jax.tree_util.tree_leaves_with_path(got)
        flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
        assert len(flat_got) == len(flat_want) > 40
        for path, g in flat_got:
            np.testing.assert_array_equal(g, flat_want[path], err_msg=path)
            assert g.shape[-1] == Bn // W, path
        for name in ("obs", "reward", "done", "discount", "step_idx",
                     "task_state", "metrics"):
            g = jax.tree.map(_np, getattr(es, name))
            w_ = jax.tree.map(lambda x: _device_shard(x, mesh, r),
                              getattr(jes_r, name))
            jax.tree.map(np.testing.assert_array_equal, g, w_)
        for k in storage:
            np.testing.assert_array_equal(
                _np(shard.replay.storage[k]),
                _device_shard(placed.replay.storage[k], mesh, r))
        assert shard.replay.capacity == cap // W
        assert shard.replay.size == (4, 2)[r]
        for k in tail:
            np.testing.assert_array_equal(
                _np(shard.rollout_tail[k]),
                _device_shard(placed.rollout_tail[k], mesh, r))
        assert es.rng is gen and shard.generator is gen
    with pytest.raises(ValueError, match="does not divide over 3 ranks"):
        M.shard_env_states(ploop.env_states, 0, 3)


def test_sharded_step_equals_the_slice_of_one_step():
    """Rank r's autoreset_step from its shard of a walk_on_ball state
    equals rank r's shard of the one-process step."""
    env = fly_envs.walk_on_ball(device="cpu", dtype=torch.float64)
    st = env.reset(4)
    act = _t(np.random.RandomState(1).uniform(-1, 1, (4, env.action_size)))
    whole = M.shard_env_states(env.autoreset_step(st, act), 0, 1)
    for r in range(W):
        got = env.autoreset_step(M.shard_env_states(st, r, W),
                                 act[2 * r:2 * r + 2])
        want = M.shard_env_states(whole, r, W)
        for k in want.obs:
            close(f"obs {k}", got.obs[k], _np(want.obs[k]), 1e-12,
                  scale=1.0)
        for k in ("reward", "discount", "done", "step_idx"):
            close(k, getattr(got, k).double(),
                  _np(getattr(want, k).double()), 1e-12, scale=1.0)
        for k in ("qpos", "qvel", "qacc", "act"):
            close(k, getattr(got.data, k), _np(getattr(want.data, k)),
                  1e-12, scale=1.0)


# ---- two ranks --------------------------------------------------------------


def _jax_learner_and_carry():
    """A JAX DMPOLearner on walk_on_ball's sizes with the carried-weights
    state of test_torch_agents, and the port's learner and TrainState
    carrying it."""
    jpol, jcrit, jinit = j_nets.make_policy_critic(
        ACT, OBS, policy_layers=NARROW[0], critic_layers=NARROW[1])
    inits = []
    for s in range(2):
        rng = np.random.RandomState(s)
        inits.append(jax.tree.map(
            lambda x: jnp.asarray(np.asarray(x, np.float64)
                                  + 0.05 * rng.normal(size=x.shape)),
            _numpy_tree(jinit(jax.random.PRNGKey(s)))))
    kw = dict(batch_size=BATCH, num_samples=N, target_policy_update_period=1,
              target_critic_update_period=2)
    jlearner = j_dmpo.DMPOLearner(jpol, jcrit, ACT, OBS,
                                  j_dmpo.DMPOConfig(**kw))
    jstate = jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x,
        jlearner.init(jax.random.PRNGKey(0)))
    jstate = jstate.replace(
        policy_params=inits[0]["policy"], critic_params=inits[0]["critic"],
        target_policy_params=inits[1]["policy"],
        target_critic_params=inits[1]["critic"])
    ppol, pcrit = p_nets.make_policy_critic(
        ACT, OBS, policy_layers=NARROW[0], critic_layers=NARROW[1])
    plearner = p_dmpo.DMPOLearner(ppol.double(), pcrit.double(), ACT, OBS,
                                  p_dmpo.DMPOConfig(**kw))
    carried = {f.name: _numpy_tree(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    carried["dual_params"] = dataclasses.asdict(carried["dual_params"])
    return jlearner, jstate, plearner, carried


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Everything the two-rank tests read, from one spawn of two gloo
    ranks: two learner updates on the halves of two batches (after the
    JAX package's two updates over a 2-device mesh, whose normals they
    are fed), the dry run's iteration, a multi-task iteration and the CLI
    in --test mode."""
    jlearner, jstate, plearner, carried = _jax_learner_and_carry()
    mesh = make_mesh(W)
    rep = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P("env"))
    jstate = jax.device_put(jstate, rep)
    update = jax.jit(jlearner.update)
    rng = np.random.RandomState(4)
    batches, eps, jax_out = [], [], []
    for _ in range(2):
        b = j_dmpo.Transition(
            obs=3.0 * rng.normal(size=(BATCH, OBS)),
            action=rng.uniform(-1.2, 1.2, (BATCH, ACT)),
            reward=rng.uniform(0, 5, BATCH),
            discount=0.99 ** 5 * (rng.uniform(size=BATCH) > 0.2),
            next_obs=3.0 * rng.normal(size=(BATCH, OBS)))
        _, key = jax.random.split(jstate.rng)
        eps.append(_t(jax.random.normal(key, (N, BATCH, ACT),
                                        dtype=jnp.float64)))
        jb = jax.tree.map(lambda x: jax.device_put(jnp.asarray(x), rows), b)
        assert len(jb.obs.addressable_shards) == W
        jstate, jstats = update(jstate, jb)
        jax_out.append((_numpy_tree(jstats), _numpy_tree(jstate)))
        batches.append(p_dmpo.Transition(
            *(_t(x) for x in dataclasses.astuple(b))))

    sd = p_params.carry_train_state(plearner, carried).state_dict()
    ckpt_dir = tmp_path_factory.mktemp("cli")
    mt_cfg = TrainerConfig(
        unroll_length=4, replay_capacity=2048, min_replay_size=8,
        samples_per_insert=4.0, dmpo=DMPOConfig(batch_size=16, n_step=2))
    jobs = [
        ("split_update_worker", (plearner, sd, batches, eps)),
        ("iteration_worker", ()),
        ("multitask_worker", ({"walk_on_ball": 4, "walk_imitation": 4},
                              mt_cfg)),
        ("cli_worker", (["--test", "--device", "cpu", "--iterations", "1",
                         "--samples-per-insert", "4", "--ckpt-dir",
                         str(ckpt_dir)],)),
    ]
    ranks = dryrun.spawn("run_jobs", W, (jobs,), device="cpu")
    names = [name for name, _ in jobs]
    return {"jax": jax_out, "plearner": plearner, "carried": carried,
            "batches": batches, "eps": eps, "ckpt_dir": ckpt_dir,
            "ranks": [dict(zip(names, out)) for out in ranks]}


def test_split_update_equals_the_whole_batch(two_ranks):
    """Two updates, each rank on its half of the batch and of the normals:
    the parameters are bit for bit the same on both ranks, equal the
    one-process updates on the whole batches within TOL_SPLIT, and the
    JAX package's updates over the 2-device mesh within TOL_UPDATE; every
    stat reduced over the ranks equals the one-process stat."""
    plearner = two_ranks["plearner"]
    pstate = p_params.carry_train_state(plearner, two_ranks["carried"])
    ranks = [r["split_update_worker"] for r in two_ranks["ranks"]]
    assert ranks[0]["params"] == ranks[1]["params"]
    for name in ranks[0]["nets"]:
        for k, v in ranks[0]["nets"][name].items():
            assert torch.equal(v, ranks[1]["nets"][name][k]), (name, k)
    for step, (batch, e) in enumerate(zip(two_ranks["batches"],
                                          two_ranks["eps"])):
        want = plearner.update(pstate, batch, eps=e)
        got = ranks[0]["stats"][step]
        jstats = two_ranks["jax"][step][0]
        assert sorted(got) == sorted(want) == sorted(jstats)
        for k in want:
            close(f"update {step + 1} {k}", got[k], _np(want[k]), TOL_SPLIT)
            close(f"update {step + 1} {k} vs JAX", got[k], jstats[k],
                  TOL_UPDATE)
    assert ranks[0]["copies"] == (2, 1)
    jfinal = two_ranks["jax"][-1][1]
    for name, carry in (("policy", p_params.policy_state_dict),
                        ("target_policy", p_params.policy_state_dict),
                        ("critic", p_params.critic_state_dict),
                        ("target_critic", p_params.critic_state_dict)):
        one = getattr(pstate, name).state_dict()
        jw = carry(getattr(jfinal, name + "_params"))
        for k, v in ranks[0]["nets"][name].items():
            close(f"{name}.{k}", v, _np(one[k]), TOL_SPLIT)
            close(f"{name}.{k} vs JAX", v, jw[k], TOL_UPDATE)
    for k, v in ranks[0]["nets"]["dual_params"].items():
        close(k, v, _np(getattr(pstate.dual_params, k)), TOL_SPLIT)
        close(f"{k} vs JAX", v, getattr(jfinal.dual_params, k),
              TOL_UPDATE)


def test_dryrun_iteration(two_ranks):
    """The dry run's iteration on two ranks: one env each, the learner's
    3 updates (14 inserted x 1.0 / batch 4), finite metrics and the same
    parameters on both."""
    rows = [r["iteration_worker"] for r in two_ranks["ranks"]]
    assert [r["pid"] for r in rows] == [0, 1]
    assert rows[0]["params"] == rows[1]["params"]
    for row in rows:
        assert row["procs"] == W and row["envs"] == W
        assert row["learner_steps"] == 3
        assert row["solve_rows_launches"] == 0   # the CPU's plain version
        assert row["metrics"]["actor_steps"] == W * 7
        assert row["metrics"]["replay_size"] == W * 7
        for k, v in row["metrics"].items():
            assert np.isfinite(v), k
    assert rows[0]["metrics"] == rows[1]["metrics"]


def test_multitask_on_two_ranks(two_ranks):
    """One MultiTaskDMPOTrainer iteration over walk_on_ball and
    walk_imitation on two ranks (test_multitask_sharding_compiles): each
    rank steps 2 envs of each task into its half of each table, the
    round-robin updates leave the same parameters on both ranks, and
    the reduced metrics are finite and the same."""
    outs = [r["multitask_worker"] for r in two_ranks["ranks"]]
    assert outs[0]["params"] == outs[1]["params"]
    for out in outs:
        assert out["local_envs"] == {"walk_imitation": 2, "walk_on_ball": 2}
        assert out["sizes"] == {"walk_imitation": 8, "walk_on_ball": 8}
        assert out["steps"] == 2 * 4   # 4 rounds of one update per table
        assert np.isfinite(out["metrics"]["mean_reward"])
        assert np.isfinite(out["metrics"]["critic_loss"])
    assert outs[0]["metrics"] == outs[1]["metrics"]


def test_cli_on_two_ranks(two_ranks):
    """train_dmpo --test --device cpu on two ranks exits 0 on both, and
    rank 0 alone writes the CSV: one row, for the one iteration."""
    assert [r["cli_worker"] for r in two_ranks["ranks"]] == [0, 0]
    with open(two_ranks["ckpt_dir"] / "learner.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1
    assert rows[0]["iteration"] == "1" and rows[0]["actor_steps"] == "80"
    assert rows[0]["learner_steps"] == "10"
    assert np.isfinite(float(rows[0]["critic_loss"]))
