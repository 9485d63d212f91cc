"""The port's training loop on the CPU: the rollout against a hand loop of
the env and the policy, the trainer on walk_on_ball, the samples-per-insert
schedule and the min-replay gate on a toy env, checkpoints and the
command line. Port only: the env itself is held against the JAX package
by test_torch_env.py, one step at a time."""

import dataclasses
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from flybody_tpu_torch.agents import actors as A
from flybody_tpu_torch.agents.dmpo import DMPOConfig
from flybody_tpu_torch.agents.networks import PolicyNetwork, batch_concat
from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig
from flybody_tpu_torch.fly_envs import walk_on_ball
from flybody_tpu_torch.io import checkpoint as ckpt

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(policy_layers=(32, 32, 32), critic_layers=(64, 64, 32))


def _equal(name, got, want):
    assert got.shape == want.shape, (name, got.shape, want.shape)
    assert torch.equal(got, want), name


def test_rollout_matches_a_hand_loop():
    """Two chunks of make_rollout_fn(stochastic=False) against the env's
    own step / apply_autoreset and the policy's mode(), step by step; the
    episodes end inside the second chunk (time_limit 0.01 = 5 control
    steps), and the windows that start in the first chunk's last n-1 steps
    come out of the second chunk (the tail)."""
    B, U = 2, 3
    env = walk_on_ball(device="cpu", dtype=torch.float64, time_limit=0.01)
    cfg = A.RolloutConfig(unroll_length=U, n_step=3, discount=0.9)
    policy = PolicyNetwork(289, env.action_size, (32, 32, 32),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():    # actions of O(1), some beyond the clip
        policy.head.mean.weight.mul_(3e3)
    policy = policy.double()
    keys = sorted(env.reset(1).obs)
    rollout = A.make_rollout_fn(env, cfg, stochastic=False, obs_keys=keys)
    tail0 = A.init_rollout_tail(cfg, B, 289, env.action_size,
                                dtype=torch.float64)
    state = env.reset(B)
    chunks = []
    for _ in range(2):
        state, tail, tr, metrics = rollout(policy, state,
                                           tail if chunks else tail0, None)
        chunks.append((tr, metrics))

    lo, hi = (torch.as_tensor(x) for x in env.action_spec())
    hand = {k: [] for k in tail0}
    s = env.reset(B)
    with torch.no_grad():
        for _ in range(2 * U):
            obs = batch_concat(s.obs, keys=keys, num_batch_dims=1)
            a = policy(obs).mode()
            st = env.step(s, lo + (a.clamp(-1, 1) + 1) * 0.5 * (hi - lo))
            for k, v in (("obs", obs), ("action", a), ("reward", st.reward),
                         ("discount", st.discount), ("done", st.done),
                         ("obs_after",
                          batch_concat(st.obs, keys=keys, num_batch_dims=1)),
                         ("episode_return", st.metrics["episode_return"])):
                hand[k].append(v)
            s = env.apply_autoreset(st)
    hand = {k: torch.stack(v) for k, v in hand.items()}
    assert hand["done"][4].all() and not hand["done"][:4].any()
    assert (hand["action"].abs() > 1).any()

    want = A.nstep_from_trajectory(
        {k: torch.cat([tail0[k], hand[k]]) for k in hand}, cfg)
    for f in dataclasses.fields(want):
        got = torch.cat([getattr(tr, f.name) for tr, _ in chunks])
        _equal(f.name, got, getattr(want, f.name))
    for k in hand:
        _equal(f"tail {k}", tail[k], hand[k][-2:])
    for k in s.obs:
        _equal(f"final obs {k}", state.obs[k], s.obs[k])
    _equal("step_idx", state.step_idx, s.step_idx)
    m = chunks[1][1]
    assert int(m["episodes_done"]) == B
    ret = hand["episode_return"][4]
    assert torch.allclose(m["mean_episode_return"], ret.mean(), rtol=1e-12)
    assert float(m["obs_absmax"]) == float(hand["obs"][U:].abs().max())


def test_train_iteration_on_walk_on_ball():
    """Port only, on the CPU: two iterations are finite and train."""
    env = walk_on_ball(device="cpu", time_limit=0.05)
    cfg = TrainerConfig(num_envs=2, unroll_length=7, replay_capacity=64,
                        min_replay_size=8, samples_per_insert=2.0,
                        dmpo=DMPOConfig(batch_size=8, n_step=5,
                                        num_samples=4), **SMALL)
    trainer = DMPOTrainer(env, cfg)
    assert trainer.obs_size == 289 and trainer.updates_per_iter == 3
    loop = trainer.init(0)
    before = [p.clone() for p in loop.train.policy.parameters()]
    for it in (1, 2):
        loop, metrics = trainer.train_iteration(loop)
        assert metrics["learner_steps"] == 3 * it
        assert metrics["replay_size"] == 14 * it
        assert metrics["actor_steps"] == 14 * it
    for k, v in metrics.items():
        assert np.all(np.isfinite(np.asarray(v))), k
    assert any(not torch.equal(a, b) for a, b in
               zip(before, loop.train.policy.parameters()))
    assert loop.train.policy.mlp.linears[0].weight.dtype == torch.float32


@dataclasses.dataclass
class _ToyState:
    obs: dict
    reward: torch.Tensor
    done: torch.Tensor
    discount: torch.Tensor
    step_idx: torch.Tensor
    metrics: dict


class _ToyEnv:
    """Points on a line pushed by their actions; episodes of 3 steps."""
    device, dtype, action_size = torch.device("cpu"), torch.float64, 2

    def action_spec(self):
        return np.full(2, -1.0), np.full(2, 1.0)

    def reset(self, B, generator=None):
        z = torch.zeros(B, dtype=self.dtype)
        return _ToyState(obs={"x": torch.zeros(B, 3, dtype=self.dtype)},
                         reward=z, done=z.bool(), discount=z + 1,
                         step_idx=z.int(), metrics={"episode_return": z})

    def step(self, s, action):
        x = s.obs["x"] + action.sum(-1, keepdim=True)
        reward = -x[:, 0].abs()
        return _ToyState(obs={"x": x}, reward=reward,
                         done=s.step_idx + 1 >= 3, discount=reward * 0 + 1,
                         step_idx=s.step_idx + 1,
                         metrics={"episode_return":
                                  s.metrics["episode_return"] + reward})

    def apply_autoreset(self, s):
        fresh = self.reset(s.done.shape[0])
        d = s.done[:, None]
        return dataclasses.replace(
            s, obs={"x": torch.where(d, fresh.obs["x"], s.obs["x"])},
            step_idx=torch.where(s.done, fresh.step_idx, s.step_idx),
            metrics={"episode_return": torch.where(
                s.done, 0.0, s.metrics["episode_return"])})


@pytest.mark.parametrize("num_envs,unroll,spi,batch", [
    (32, 20, 32.0, 256),     # reference defaults ratio
    (4, 6, 2.0, 8),          # test-scale config
    (8, 10, 0.5, 64),        # sub-1 SPI floors at one update
])
def test_samples_per_insert_schedule(num_envs, unroll, spi, batch):
    """The trainer's updates per iteration realize the sample-to-insert
    setpoint (floored at one update per iteration)."""
    cfg = TrainerConfig(num_envs=num_envs, unroll_length=unroll,
                        samples_per_insert=spi,
                        dmpo=DMPOConfig(batch_size=batch), **SMALL)
    trainer = DMPOTrainer(_ToyEnv(), cfg)
    inserted = num_envs * unroll
    ratio = trainer.updates_per_iter * batch / inserted
    target = max(spi, batch / inserted)
    assert abs(ratio - target) <= batch / inserted, (ratio, target)


def test_min_replay_size_gates_learning():
    """No update runs before min_replay_size transitions exist; the gated
    iterations yield zero stats with the trained iterations' keys."""
    cfg = TrainerConfig(num_envs=2, unroll_length=4, replay_capacity=256,
                        min_replay_size=20,      # 3 iterations of 8 inserts
                        samples_per_insert=1.0,
                        dmpo=DMPOConfig(batch_size=4, n_step=2,
                                        num_samples=3), **SMALL)
    trainer = DMPOTrainer(_ToyEnv(), cfg)
    loop = trainer.init(0)
    runs = [trainer.train_iteration(loop)[1] for _ in range(4)]
    assert [m["learner_steps"] for m in runs] == [0, 0, 2, 4]
    assert [m["replay_size"] for m in runs] == [8, 16, 24, 32]
    assert set(runs[0]) == set(runs[3])
    assert float(runs[0]["critic_loss"]) == 0.0
    assert float(runs[3]["critic_loss"]) > 0.0
    assert int(runs[0]["episodes_done"]) == 2      # episodes of 3 steps


def test_checkpoint_round_trip(tmp_path):
    cfg = TrainerConfig(num_envs=2, unroll_length=4, replay_capacity=64,
                        min_replay_size=1, samples_per_insert=2.0,
                        dmpo=DMPOConfig(batch_size=4, n_step=2,
                                        num_samples=3), **SMALL)
    trainer = DMPOTrainer(_ToyEnv(), cfg)
    loop = trainer.init(0)
    trainer.train_iteration(loop)
    state = loop.train
    path = ckpt.save(str(tmp_path / "ck"), {"train": state,
                                            "actor_steps": 8}, step=3)
    assert ckpt.latest(str(tmp_path / "ck")) == path
    assert ckpt.latest(str(tmp_path / "none")) is None

    fresh = trainer.init(1).train
    assert not torch.equal(fresh.policy.head.mean.weight,
                           state.policy.head.mean.weight)
    out = ckpt.restore(path, {"train": fresh, "actor_steps": 0})
    assert out["actor_steps"] == 8 and out["train"] is fresh
    want, got = state.state_dict(), fresh.state_dict()
    for name in ("policy", "critic", "target_policy", "target_critic",
                 "dual_params"):
        for k, v in want[name].items():
            _equal(f"{name}.{k}", got[name][k], v)
    assert fresh.steps == state.steps == 4
    for opt in ("policy_opt", "critic_opt", "dual_opt"):
        for i, st in want[opt]["state"].items():
            for k, v in st.items():
                _equal(f"{opt}.{i}.{k}", got[opt]["state"][i][k], v)
    draws = [torch.randn(3, generator=s.generator) for s in (state, fresh)]
    _equal("generator", *draws)

    other = trainer.init(2).train
    ckpt.restore_policy_only(path, other)
    _equal("policy only", other.policy.head.mean.weight,
           state.policy.head.mean.weight)
    assert not torch.equal(other.critic.logits.weight,
                           state.critic.logits.weight)
    teacher = ckpt.restore_policy_params(path)
    _equal("policy params", teacher["head.mean.weight"],
           state.policy.head.mean.weight)

    wide = DMPOTrainer(_ToyEnv(), dataclasses.replace(
        cfg, policy_layers=(48, 32, 32))).init(0).train
    kept = wide.policy.head.mean.weight.clone()
    with pytest.raises(ValueError):
        ckpt.restore(path, {"train": wide, "actor_steps": 0})
    _equal("untouched on mismatch", wide.policy.head.mean.weight, kept)


def test_trainer_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from flybody_tpu_torch import train_dmpo
    # the trainer runs on its env's device, which the factory sets to cuda
    # unless told otherwise
    with pytest.raises(RuntimeError, match="CUDA"):
        DMPOTrainer(walk_on_ball(), TrainerConfig(**SMALL))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_dmpo.main(["--test"])
    trainer = DMPOTrainer(_ToyEnv(), TrainerConfig(**SMALL))
    loop = trainer.init(0)
    assert trainer.device == loop.generator.device == torch.device("cpu")
    assert loop.replay.storage["obs"].device == torch.device("cpu")
    # the vision networks read two eyes, which the toy env has not
    with pytest.raises(ValueError, match="left_eye"):
        DMPOTrainer(_ToyEnv(), TrainerConfig(network="vision"))
    assert train_dmpo.make_env("vision_guided_flight", "cpu").device == \
        torch.device("cpu")
    assert train_dmpo.make_env("rodent_escape_bowl", "cpu").device == \
        torch.device("cpu")
    assert train_dmpo.make_env("walk_humanoid", "cpu").device == \
        torch.device("cpu")
    with pytest.raises(ValueError, match="unknown task"):
        train_dmpo.make_env("walk_on_the_moon", "cpu")


class _TaskToyEnv(_ToyEnv):
    """The toy env with a task observation for the intention encoder."""

    def reset(self, B, generator=None):
        s = super().reset(B, generator)
        s.obs["task_input"] = torch.ones(B, 2, dtype=self.dtype)
        return s


# each intention flag's non-default value, read off the built trainer
_INTENTION_FLAG_CHECKS = {
    "--encoder-layers": ("256,256", lambda tr: (
        tr.cfg.encoder_layers, tr.policy.encoder.mlp.linears[1].out_features)
        == ((256, 256), 256)),
    "--decoder-layers": ("512,512", lambda tr: (
        tr.cfg.decoder_layers, len(tr.policy.decoder.mlp.linears))
        == ((512, 512), 2)),
    "--intention-size": ("30", lambda tr: (
        tr.policy.encoder.head.mean.out_features,
        tr.policy.decoder.mlp.linears[0].in_features) == (30, 30 + 3)),
    "--high-level-intention-size": ("8", lambda tr: (
        tr.cfg.high_level_intention_size,
        tr.policy.encoder.high_head.mean.out_features) == (8, 8)),
    "--intention-kl-weight": ("0.1", lambda tr: (
        tr.learner.cfg.intention_kl_weight == 0.1)),
}


@pytest.mark.parametrize("flag,value", [
    (f, v) for f, (v, _) in _INTENTION_FLAG_CHECKS.items()])
def test_cli_refuses_intention_flags(flag, value):
    """Flags that only the intention network reads raise with another
    network rather than being dropped; with --network intention each
    non-default value reaches the built trainer (its config or the
    network's shape)."""
    from flybody_tpu_torch import train_dmpo
    with pytest.raises(ValueError, match="--network intention"):
        train_dmpo.main(["--device", "cpu", flag, value])
    default = train_dmpo.INTENTION_FLAGS[flag[2:].replace("-", "_")]
    with pytest.raises(RuntimeError, match="sentinel"):
        with mock.patch("flybody_tpu_torch.train_dmpo.make_env",
                        side_effect=RuntimeError("sentinel")):
            train_dmpo.main(["--device", "cpu", flag, str(default)])
    built, real = [], train_dmpo.build_trainer
    with mock.patch.object(train_dmpo, "make_env",
                           return_value=_TaskToyEnv()), \
            mock.patch.object(train_dmpo, "build_trainer",
                              side_effect=lambda *a: built.append(real(*a))
                              or built[-1]):
        assert train_dmpo.main(["--device", "cpu", "--network", "intention",
                                "--iterations", "0", flag, value]) == 0
    trainer = built[0]
    assert trainer.task_obs_size == 2 and trainer.obs_keys[0] == "task_input"
    assert _INTENTION_FLAG_CHECKS[flag][1](trainer), flag


def test_cli_test_mode_on_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--test",
         "--device", "cpu", "--iterations", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=80" in line[0], res.stdout


def test_cli_walk_imitation_on_cpu():
    """The CLI trains walk_imitation in --test mode on the CPU: the
    trainer reads the env's observation width, and the first iteration's
    80 updates give a finite critic loss."""
    from flybody_tpu_torch.fly_envs import walk_imitation
    width = sum(v.shape[1] for v in walk_imitation(device="cpu").reset(
        1).obs.values())
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "walk_imitation", "--test", "--device", "cpu", "--iterations", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert f"task walk_imitation: {width} observation floats, 59 actions" \
        in res.stdout, res.stdout
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=80" in line[0], res.stdout
    loss = float(line[0].split("critic_loss=")[1].split()[0].rstrip(","))
    assert np.isfinite(loss) and loss != 0.0, line[0]


def _learner_line(stdout):
    line = [x for x in stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1, stdout
    return line[0]


def _stat(line, key):
    return float(line.split(f"{key}=")[1].split()[0].rstrip(","))


def test_cli_intention_on_walk_imitation():
    """--network intention on walk_imitation in --test mode on the CPU:
    the encoder reads the ref_* task keys, and the first iteration trains
    with a finite latent KL."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "walk_imitation", "--network", "intention", "--intention-kl-weight",
         "1e-4", "--test", "--device", "cpu", "--iterations", "1",
         "--samples-per-insert", "4"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "network intention" in res.stdout, res.stdout
    line = _learner_line(res.stdout)
    assert "learner_steps=10" in line, line
    kl = _stat(line, "intention_kl")
    assert np.isfinite(kl) and kl > 0, line


def test_cli_transfer_restores_and_freezes_the_decoder(tmp_path):
    """--transfer-ckpt: the decoder comes from a donor checkpoint written
    here and stays as restored through an iteration of updates, while the
    encoder trains."""
    from flybody_tpu_torch.fly_envs import walk_imitation
    donor = DMPOTrainer(walk_imitation(device="cpu"), TrainerConfig(
        network="intention")).init(7).train
    path = ckpt.save(str(tmp_path / "donor"), {"train": donor})
    run = tmp_path / "run"
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "walk_imitation", "--network", "intention", "--transfer-ckpt", path,
         "--test", "--device", "cpu", "--iterations", "1",
         "--samples-per-insert", "4", "--ckpt-dir", str(run),
         "--ckpt-minutes", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "transfer: decoder restored" in res.stdout, res.stdout
    assert "learner_steps=10" in _learner_line(res.stdout)
    got = ckpt.restore_policy_params(ckpt.latest(str(run)))
    want = donor.policy.state_dict()
    decoder = [k for k in want if k.startswith("decoder.")]
    assert decoder
    for k in decoder:
        _equal(k, got[k], want[k])
    assert not torch.equal(got["encoder.head.mean.weight"],
                           want["encoder.head.mean.weight"])
