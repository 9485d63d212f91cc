"""graph_substeps_pct.sim's reader (no card needed): it resolves in the three
sim cells and not in the training cell, returns nothing without a trace,
off the sim driver or without the program's counters, and reads the share
of the substeps a CUDA graph's replay ran from them."""

import pytest
import torch

from benchmark import harness
from flybody_tpu_torch.utils import telemetry

METRIC = "graph_substeps_pct.sim"
SIM_CELLS = ("fly_walk_imitation.sim4096", "rat_two_touch.sim4096",
             "vision_flight.sim4096")


def _reader():
    return harness.load_module(harness.metric_path(harness.ROOT, METRIC),
                               METRIC)


@pytest.mark.parametrize("cell", SIM_CELLS)
def test_reported_in_the_sim_cells(cell):
    assert METRIC in harness.resolve(cell).readers


def test_not_reported_in_the_training_cell():
    assert METRIC not in harness.resolve("fly_walk_imitation.train").readers


def _counted(counts: dict):
    """The registry after a profiled stretch that counted ``counts``."""
    telemetry.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for k, v in counts.items():
            telemetry.count(k, v)


def test_nothing_without_its_counters():
    read = _reader().read
    telemetry.clear()
    assert read({"driver": "sim", "trace": object()}) is None
    _counted({"solver.rows": 10})
    assert read({"driver": "sim", "trace": object()}) is None
    telemetry.clear()


def test_nothing_without_a_trace_or_off_the_sim_driver():
    read = _reader().read
    _counted({"physics.substeps": 10, "physics.graph_substeps": 10})
    assert read({"driver": "sim"}) is None
    assert read({"driver": "train", "trace": object()}) is None
    telemetry.clear()


@pytest.mark.parametrize("graph, want", [(10, 100.0), (0, 0.0)])
def test_reads_the_replayed_share(graph, want):
    _counted({"physics.substeps": 10,
              "physics.graph_substeps": graph})
    assert _reader().read({"driver": "sim", "trace": object()}) == want
    telemetry.clear()
