"""Each cell's run, with the card's look skipped and the timed path broken
underneath, comes out not ``correct``; the same run unbroken comes out
``correct``. On the CPU at a size a test run holds (the program's plain
versions), against the cells' own limits."""

import copy
import dataclasses
import time

import pytest

from benchmark import drivers, faults, harness

SIM = "fly_walk_imitation.sim4096"
TRAIN = "fly_walk_imitation.train"
SEED = 11


def _run(cell, hook=None, envs=None):
    kw = {"envs": envs} if envs else {}
    return drivers.run_cell(cell, SEED, 0.0, False, "cpu", time.time(),
                            hook=hook, **kw)


def _small_train():
    cell = harness.resolve(TRAIN)
    cfg = copy.deepcopy(cell.config)
    cfg["train"].update(num_envs=2, unroll_length=5, batch_size=8,
                        replay_capacity=64, min_replay_size=10,
                        policy_layers=[16, 16], critic_layers=[16, 16])
    return dataclasses.replace(cell, config=cfg)


def test_sim_sound_run_is_correct():
    res = _run(harness.resolve(SIM), envs=4)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_sim_fault_is_not_correct(kind):
    B = 4
    res = _run(harness.resolve(SIM), hook=faults.sim(kind), envs=B)
    assert not res["correct"], res["checks"]


def test_train_sound_run_is_correct():
    res = _run(_small_train())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_train_fault_is_not_correct(kind):
    res = _run(_small_train(), hook=faults.train(kind))
    assert not res["correct"], res["checks"]
