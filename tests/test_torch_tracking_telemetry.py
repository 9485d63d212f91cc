"""The tracking task's spans and counters (``tasks/tracking.py`` over
``utils/telemetry.py``) on the CPU, in walk_humanoid at B=4: a traced
control step records ``tracking.reset``, ``tracking.observe`` and
``tracking.reward`` and both counters; nothing is counted with the
profiler off; the step's outputs are the same bit for bit either way; and
the benchmark's tracking readers on that trace and on hand-built ones."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark import trace as btrace
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.utils import telemetry as tm

torch.set_num_threads(2)

B = 4
SPANS = ("tracking.reset", "tracking.observe", "tracking.reward")
READERS = ("tracking_launches_per_step.sim", "tracking_host_ms_per_step.sim",
           "tracking_device_ms_per_step.sim")


def _reader(name):
    return harness.load_module(harness.metric_path(harness.ROOT, name),
                               name)


def _leaves(x, name="state"):
    """[(path, tensor)] of every tensor leaf of an EnvState."""
    if dataclasses.is_dataclass(x):
        return [p for f in dataclasses.fields(x)
                for p in _leaves(getattr(x, f.name), f"{name}.{f.name}")]
    if isinstance(x, dict):
        return [p for k, v in x.items() for p in _leaves(v, f"{name}.{k}")]
    if isinstance(x, (tuple, list)):
        return [p for i, v in enumerate(x) for p in _leaves(v, f"{name}.{i}")]
    return [(name, x)] if torch.is_tensor(x) else []


@pytest.fixture(scope="module")
def humanoid():
    """walk_humanoid at B=4, float32, a state one step in, an action, and
    the next step taken untraced and traced from the same generator
    state."""
    env = rodent_envs.walk_humanoid(device="cpu")
    gen = torch.Generator().manual_seed(3)
    lo, hi = (torch.as_tensor(x, dtype=torch.float32)
              for x in env.action_spec())
    u = torch.rand((B, lo.shape[0]),
                   generator=torch.Generator().manual_seed(4))
    action = lo + (hi - lo) * u
    state = env.autoreset_step(env.reset(B, gen), action)
    rng = gen.get_state()
    tm.clear()
    plain = env.autoreset_step(state, action)
    off = tm.counters()
    gen.set_state(rng)
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    traced = env.autoreset_step(state, action)
    t = btrace.finish(prof, 1.0)
    counts = tm.counters()
    tm.clear()
    return dict(plain=plain, traced=traced, off=off, counts=counts, trace=t)


def test_traced_step_records_the_tracking_spans(humanoid):
    """One span of each name at least: the reward once, the observations
    twice (the step's and the auto-reset's fresh batch), the reset once;
    no tracking span inside another."""
    spans = sorted((a, b, n) for a, b, n in humanoid["trace"].ops
                   if n.startswith("tracking."))
    names = [n for _, _, n in spans]
    assert {n: names.count(n) for n in SPANS} == {
        "tracking.reset": 1, "tracking.observe": 2, "tracking.reward": 1}
    for (a0, b0, _), (a1, _, _) in zip(spans[:-1], spans[1:]):
        assert b0 <= a1


def test_traced_step_counts_frames_and_terminations(humanoid):
    c = humanoid["counts"]
    assert c["tracking.ref_frames"] == 2 * B * 5
    assert "tracking.terminated" in c
    assert 0 <= c["tracking.terminated"] <= B
    # no CUDA device, so no span is timed
    assert not any(k.endswith(".device_ms") for k in c)


def test_nothing_counted_with_the_profiler_off(humanoid):
    assert not any(k.startswith("tracking.") for k in humanoid["off"])
    assert humanoid["off"] == {}


def test_outputs_bit_identical_with_and_without_the_profiler(humanoid):
    plain, traced = _leaves(humanoid["plain"]), _leaves(humanoid["traced"])
    assert [n for n, _ in plain] == [n for n, _ in traced]
    for (n, a), (_, b) in zip(plain, traced):
        assert torch.equal(a, b), n


def test_tracking_readers_on_the_traced_step(humanoid):
    """On the CPU the step has spans and no launch calls or device
    events: the launch reader reads 0, the host reader the spans' union,
    the device reader nothing."""
    t = humanoid["trace"]
    ctx = {"driver": "sim", "trace": t}
    launches, host, device = (_reader(n) for n in READERS)
    assert launches.read(ctx) == 0.0
    union = sum(b - a for a, b, n in t.ops if n.startswith("tracking."))
    assert host.read(ctx) == pytest.approx(union / 1e6)
    assert host.read(ctx) > 0
    assert device.read(ctx) is None


def test_tracking_readers_on_hand_built_traces():
    ops = [(0, 100, "tracking.observe"), (10, 11, "cudaLaunchKernel"),
           (20, 21, "cudaMemcpyAsync"), (30, 31, "aten::add"),
           (150, 151, "cudaLaunchKernel"),
           (200, 300, "tracking.reward"), (250, 251, "cuLaunchKernel"),
           (260, 280, "tracking.reward"), (270, 271, "cudaLaunchKernel"),
           (400, 450, "tracking.reset"), (420, 421, "cudaMemsetAsync"),
           (500, 600, "physics.kinematics"), (510, 511, "cudaLaunchKernel")]
    t = btrace.Trace([], [], 1.0, sorted(ops))
    launches, host, device = (_reader(n) for n in READERS)
    sim = {"driver": "sim", "trace": t}
    assert launches.read(sim) == 5.0
    # the nested reward span counts once: 100 + 100 + 50 ns
    assert host.read(sim) == pytest.approx(250 / 1e6)
    empty = btrace.Trace([], [], 1.0, [(5, 6, "cudaLaunchKernel"),
                                       (0, 9, "physics.collision")])
    for r in (launches, host, device):
        assert r.read({"driver": "sim", "trace": empty}) is None
        assert r.read({"driver": "sim"}) is None
        assert r.read({"driver": "train", "trace": t}) is None
