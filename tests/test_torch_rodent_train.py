"""The rodent tasks through the port's training CLI on the CPU: the
two-touch task in --test mode and the reference config two_taps in its
--test cut (8 envs, unroll 10, batch 32, one iteration), and every rodent
config of the four ported tasks building its trainer and resetting its
envs. (two_tasks trains in test_torch_rodent_multitask.py.)"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from flybody_tpu_torch import train_dmpo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*argv):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", *argv,
         "--test", "--device", "cpu", "--iterations", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    lines = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(lines) == 1, res.stdout
    loss = float(lines[0].split("critic_loss=")[1].split()[0].rstrip(","))
    assert np.isfinite(loss) and loss != 0.0, lines[0]
    return res.stdout, lines[0]


@pytest.mark.parametrize("argv", [
    ("--task", "rodent_two_touch"),
    ("--config", "configs/train_config_two_taps.yaml")],
    ids=["task", "two_taps"])
def test_cli_two_touch(argv):
    """rodent_two_touch trains one --test iteration: 165 observation
    floats (the rat's 162 and the egocentric target), 38 actions, 80
    updates with a finite critic loss."""
    out, line = _cli(*argv)
    assert "task rodent_two_touch: 165 observation floats, 38 actions" \
        in out, out
    assert "learner_steps=80" in line, line


@pytest.mark.parametrize("config", ["two_taps", "bowl", "gaps", "maze",
                                    "two_tasks", "generalist"])
def test_rodent_configs_build(config, monkeypatch):
    """Every reference config of the four ported rodent tasks builds its
    trainer on the CPU (--test sizes, no iteration); each env is the
    config's task at 8 envs."""
    built = []
    orig = train_dmpo.build_trainer

    def keep(args, cfg):
        built.append(orig(args, cfg))
        return built[-1]

    monkeypatch.setattr(train_dmpo, "build_trainer", keep)
    assert train_dmpo.main([
        "--config", os.path.join(ROOT, f"configs/train_config_{config}.yaml"),
        "--test", "--device", "cpu", "--iterations", "0"]) == 0
    trainer = built[0]
    names = getattr(trainer, "names", None) or (trainer.env.task.__class__
                                                .__name__,)
    assert trainer.action_size == 38 and len(names) >= 1, names


def test_unported_rodent_tasks_name_their_item():
    """Every rodent task is ported, the rat's egocentric camera too: each
    factory with use_vision=True observes a (B, 32, 32) camera in
    [0, 255] (nothing is left unported to name)."""
    from flybody_tpu_torch import rodent_envs
    for task in ("rodent_two_touch", "rodent_escape_bowl",
                 "rodent_run_gaps", "rodent_maze_forage"):
        env = getattr(rodent_envs, task)(device="cpu", use_vision=True)
        cam = env.reset(2, torch.Generator().manual_seed(0)).obs[
            "egocentric_camera"]
        assert cam.shape == (2, 32, 32), task
        assert bool(((cam >= 0) & (cam <= 255)).all()), task
