"""The control of each cell on the card: the plain reference computed in
the nearest precision below the configuration's (float32 with TF32 on;
the configuration states float32 with TF32 off) takes the program's
place, and fails the cell's limits; the program stays inside them.

The sim cells run at their own 4096 envs: at 256 envs the rat's control
failed no limit on one seed of three, so a smaller size does not hold
the control. The training cell keeps its networks, batch and envs and
holds a ring of 100,000 items. ``python3 -m benchmark.calibrate``
gives the same readings on more seeds (PERF.md)."""

import copy
import dataclasses

import pytest
import torch

from benchmark import calibrate, drivers, harness

pytestmark = pytest.mark.cuda

SIM = ["fly_walk_imitation.sim4096", "rat_two_touch.sim4096"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's kernels run only "
                    "there")
    return "cuda"


def _fails(numbers, limits) -> bool:
    return any(numbers[k] > v for k, v in limits.items())


@pytest.mark.parametrize("workload", SIM)
def test_sim_control_fails(card, workload):
    cell = harness.resolve(workload)
    limits = drivers.load_limits(workload)
    ref = drivers.reference_env(cell, card)
    prog = drivers.program_env(cell.config, card)
    for n in calibrate.readings(cell, [101, 102, 103], prog, ref, None):
        assert not _fails(n, limits), n
    low = drivers.reference_env(cell, card, dtype=torch.float32)
    for n in calibrate.readings(cell, [104, 105, 106], low, ref, True):
        assert _fails(n, limits), n


def test_train_control_fails(card):
    cell = harness.resolve("fly_walk_imitation.train")
    cfg = copy.deepcopy(cell.config)
    cfg["train"]["replay_capacity"] = 100_000
    cell = dataclasses.replace(cell, config=cfg)
    limits = drivers.load_limits("fly_walk_imitation.train")
    prog, ctl = calibrate.train_readings(cell, [101, 102], {101, 102})
    for n in prog:
        assert not _fails(n, limits), n
    for c in ctl:
        assert _fails(c, limits), c
