"""The port's spans and counters (``utils/telemetry.py``) and the
benchmark's readers of them, on the CPU: the off state, the stage and env
spans of one traced fly step, the agents' spans of one training
iteration, the counters against hand counts, the eye render's span and
counters in a traced vision step, the readers on hand-built traces, and
``profile_step``'s tables. The tests marked ``cuda`` trace one
fly step on the card and skip without one:

    python -m pytest -p no:cacheprovider tests/test_torch_telemetry.py -m cuda
"""

import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark import trace as btrace
from flybody_tpu_torch import profile_step as PS
from flybody_tpu_torch.agents.dmpo import DMPOConfig
from flybody_tpu_torch.agents.train import DMPOTrainer, TrainerConfig
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.tasks import vision_flight as VF
from flybody_tpu_torch.tasks import walk_imitation as WI
from flybody_tpu_torch.utils import telemetry as tm

from test_torch_train import SMALL, _ToyEnv

torch.set_num_threads(2)

B = 2
POSITION_VELOCITY = ("kinematics", "com_pos", "tendon", "crb", "collision",
                     "transmission", "com_vel", "passive", "rne")
LATER = ("act_dynamics", "actuation", "acceleration", "solve", "sensor",
         "euler")
AGENT_SPANS = ("actor.rollout", "actor.policy", "actor.nstep",
               "replay.insert", "replay.sample", "learner.update",
               "learner.losses", "learner.backward", "learner.optim")


def _program_spans(prof) -> list:
    """[(start ns, end ns, name)] of the program's spans in a stopped
    profiler's host timeline."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().split(".")[0] in
                  ("physics", "env", "actor", "replay", "learner"))


def _within(span, name, spans):
    """True when a span named ``name`` other than ``span`` holds it."""
    a, b, _ = span
    return any(x <= a and b <= y and (x, y) != (a, b)
               for x, y, n in spans if n == name)


def _reader(name):
    return harness.load_module(harness.metric_path(harness.ROOT, name),
                               name)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


@pytest.fixture(scope="module")
def fly():
    """One fly env at B=2, float32, and a state one step in."""
    env = WI.make_walk_imitation("cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    lo, hi = env.action_spec()
    action = torch.as_tensor(lo + 0.3 * (hi - lo), dtype=torch.float32)
    action = action[None].expand(B, -1)
    state = env.autoreset_step(env.reset(B, gen), action)
    return env, state, action


@pytest.fixture(scope="module")
def traced(fly):
    """One autoreset_step under a CPU profiler, each substep's sol_f kept
    by a wrapper of ``forward.step``, and the counters it left."""
    env, state, action = fly
    sol_f = []
    step = F.step

    def keep(*a, **kw):
        d = step(*a, **kw)
        sol_f.append(d.sol_f.clone())
        return d

    rng = state.rng.get_state()
    tm.clear()
    F.step = keep
    try:
        out, prof = _profiled(lambda: env.autoreset_step(state, action))
    finally:
        F.step = step
    counts = tm.counters()
    tm.clear()
    return dict(out=out, prof=prof, spans=_program_spans(prof),
                sol_f=sol_f, counts=counts, rng=rng)


@pytest.fixture(scope="module")
def training():
    """One training iteration on the toy env under a CPU profiler."""
    cfg = TrainerConfig(num_envs=2, unroll_length=4, replay_capacity=64,
                        min_replay_size=1, samples_per_insert=2.0,
                        dmpo=DMPOConfig(batch_size=4, n_step=2,
                                        num_samples=3), **SMALL)
    trainer = DMPOTrainer(_ToyEnv(), cfg)
    loop = trainer.init(0)
    _, prof = _profiled(lambda: trainer.train_iteration(loop))
    tm.clear()
    return trainer, _program_spans(prof)


def test_off_is_a_shared_noop():
    """With no profiler running a span is the one shared no-op, and a
    counter leaves the registry empty."""
    assert tm.span("physics.solve") is tm.span("env.step")
    with tm.span("physics.solve"):
        pass
    tm.clear()
    tm.count("solver.rows", 7)
    tm.count("env.done", torch.ones(3, dtype=torch.bool))
    assert tm.counters() == {}


def test_on_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]):
        on = tm.span("physics.solve")
        tm.clear()
        tm.count("solver.rows", 7)
        tm.count("solver.rows", 5)
        tm.count("solver.rows_used", torch.tensor([[0.0, 2.0], [1.0, 0.0]]))
        tm.count("solver.rows_used", torch.tensor([0.0, -3.0]))
    assert isinstance(on, torch.profiler.record_function)
    assert tm.counters() == {"solver.rows": 12.0, "solver.rows_used": 3.0}
    tm.clear()
    assert tm.counters() == {}


def test_spanned_keeps_the_function():
    @tm.spanned("physics.solve")
    def f(x, y=1):
        """doc"""
        return x + y

    assert f(1, y=2) == 3 and f.__name__ == "f" and f.__doc__ == "doc"
    _, prof = _profiled(lambda: f(1))
    assert [n for _, _, n in _program_spans(prof)] == ["physics.solve"]


def test_stage_and_env_spans(fly, traced):
    """Each stage span runs once a substep; the reset adds one of each
    position and velocity stage; the env's spans nest them; each
    collision holds one ``physics.ccd`` span per ccd class."""
    env = fly[0]
    spans = traced["spans"]
    n = collections.Counter(n for _, _, n in spans)
    want = {f"physics.{s}": env.n_substeps + 1 for s in POSITION_VELOCITY}
    want.update({f"physics.{s}": env.n_substeps for s in LATER})
    want["physics.ccd"] = (env.n_substeps + 1) * len(env.model.ccd_classes)
    want.update({"env.step": 1, "env.autoreset": 1, "env.reset": 1,
                 "env.task": 2})
    assert dict(n) == want
    for e in spans:
        inside = {m for m in ("env.step", "env.reset", "env.autoreset",
                              "env.task") if _within(e, m, spans)}
        if e[2].startswith("physics."):
            assert inside in ({"env.step"},
                              {"env.reset", "env.autoreset"}), e
            assert (e[2] != "physics.ccd"
                    or _within(e, "physics.collision", spans)), e
        elif e[2] == "env.task":
            assert inside == {"env.step"}
        elif e[2] == "env.reset":
            assert inside == {"env.autoreset"}
        else:
            assert not inside, e


def test_spans_change_no_number(fly, traced):
    """The traced step and the same step untraced agree bit for bit."""
    env, state, action = fly
    rng = state.rng.get_state()
    state.rng.set_state(traced["rng"])
    try:
        plain = env.autoreset_step(state, action)
    finally:
        state.rng.set_state(rng)
    out = traced["out"]
    for f in ("qpos", "qvel", "act", "sol_f", "qacc"):
        assert torch.equal(getattr(out.data, f), getattr(plain.data, f)), f
    for k in out.obs:
        assert torch.equal(out.obs[k], plain.obs[k]), k
    assert torch.equal(out.reward, plain.reward)


def test_agent_spans(training):
    trainer, spans = training
    n = collections.Counter(n for _, _, n in spans)
    u = trainer.updates_per_iter
    assert dict(n) == {
        "actor.rollout": 1, "actor.policy": trainer.cfg.unroll_length,
        "actor.nstep": 1, "replay.insert": 1, "replay.sample": u,
        "learner.update": u, "learner.losses": u, "learner.backward": u,
        "learner.optim": u}
    for e in spans:
        if e[2] in ("actor.policy", "actor.nstep"):
            assert _within(e, "actor.rollout", spans)
        if e[2].startswith("learner.") and e[2] != "learner.update":
            assert _within(e, "learner.update", spans)


def test_no_span_is_a_benchmark_span(traced, training):
    names = {n for _, _, n in traced["spans"] + training[1]}
    assert set(AGENT_SPANS) <= names and len(names) == 29
    assert not names & set(btrace.SPANS)


def test_counters_equal_hand_counts(fly, traced):
    env = fly[0]
    c, sol_f = traced["counts"], traced["sol_f"]
    assert len(sol_f) == env.n_substeps
    R = sol_f[0].shape[0]
    assert R == 176 and all(f.shape == (R, B) for f in sol_f)
    used = sum(int(torch.count_nonzero(f)) for f in sol_f)
    assert 0 < used < env.n_substeps * R * B
    lanes = env.model.ccd_budget * B
    assert lanes == 96 * B
    assert c == {"solver.rows": float(env.n_substeps * R * B),
                 "solver.rows_used": float(used),
                 "ccd.lanes": float((env.n_substeps + 1) * lanes),
                 "env.reset_built": float(B),
                 "env.done": float(traced["out"].done.sum())}


def test_counters_with_a_forced_done(fly):
    env, state, _ = fly
    forced = state.replace(done=torch.tensor([True, False]))
    rng = state.rng.get_state()
    tm.clear()
    try:
        _profiled(lambda: env.apply_autoreset(forced))
    finally:
        state.rng.set_state(rng)
    assert tm.counters() == {"env.reset_built": float(B), "env.done": 1.0,
                             "ccd.lanes": float(env.model.ccd_budget * B)}
    tm.clear()


def test_render_span_and_counters():
    """A traced vision_guided_flight step renders both eyes twice (the
    step's observations and the auto-reset's fresh batch), each render in
    one ``render.eyes`` span with its counters: the rays, the march's 48
    samples and the 14 primitives each eye casts; no device time on the
    CPU. Untraced, nothing is counted."""
    env = VF.make_vision_flight("cpu", dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    lo, hi = env.action_spec()
    action = torch.as_tensor(lo + 0.3 * (hi - lo), dtype=torch.float32)
    action = action[None].expand(B, -1)
    state = env.reset(B, gen)
    tm.clear()
    _, prof = _profiled(lambda: env.autoreset_step(state, action))
    c = tm.counters()
    tm.clear()
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(("render.", "env.")))
    renders = [e for e in spans if e[2] == "render.eyes"]
    assert len(renders) == 2
    assert [_within(e, "env.task", spans) for e in renders] == [True, False]
    assert _within(renders[1], "env.reset", spans)
    assert [len(g) for g in env.task.eye_geoms] == [14, 14]
    assert {k: v for k, v in c.items() if k.startswith("render.")} == {
        "render.rays": 2.0 * B * 32 * 32 * 2,
        "render.march_samples": 2.0 * 48,
        "render.primitives": 2.0 * 28}
    env.autoreset_step(state, action)
    assert tm.counters() == {}


def test_timed_span_off_the_card():
    """A span given a device is the shared no-op with no profiler, and a
    plain range without CUDA; only a CUDA device keeps timing events."""
    assert tm.span("render.eyes", device="cpu") is tm.span("env.step")
    with profile(activities=[ProfilerActivity.CPU]):
        on = tm.span("render.eyes", device="cpu")
        with on:
            pass
    assert isinstance(on, torch.profiler.record_function)
    assert tm.counters() == {}


def _trace(ops):
    return btrace.Trace([], [], 1.0, sorted(ops))


def test_launch_readers_on_a_hand_built_trace():
    ops = [(0, 100, "physics.kinematics"), (10, 11, "cudaLaunchKernel"),
           (20, 21, "cudaMemcpyAsync"), (30, 31, "aten::add"),
           (40, 41, "cudaDeviceSynchronize"), (150, 151, "cudaLaunchKernel"),
           (200, 300, "physics.kinematics"), (250, 251, "cuLaunchKernel"),
           (300, 301, "cudaLaunchKernel"),
           (400, 500, "physics.collision"), (400, 401, "cudaMemsetAsync"),
           (420, 421, "cudaLaunchKernelExC"), (430, 431, "cuLaunchKernelEx"),
           (440, 441, "cudaMemcpy"),
           (600, 700, "learner.update"), (610, 611, "cudaLaunchKernel"),
           (800, 900, "learner.update"), (810, 811, "cudaLaunchKernel"),
           (820, 821, "cudaLaunchKernel")]
    t = _trace(ops)
    sim, train = {"driver": "sim", "trace": t}, {"driver": "train",
                                                  "trace": t}
    kin = _reader("kinematics_launches_per_step.sim")
    col = _reader("collision_launches_per_step.sim")
    lrn = _reader("learner_launches_per_update.train")
    assert kin.read(sim) == 3.0
    assert col.read(sim) == 4.0
    assert lrn.read(train) == 1.5
    assert kin.read(train) is None and col.read(train) is None
    assert lrn.read(sim) is None
    empty = _trace([(5, 6, "cudaLaunchKernel")])
    for r, d in ((kin, "sim"), (col, "sim"), (lrn, "train")):
        assert r.read({"driver": d, "trace": empty}) is None
        assert r.read({"driver": d}) is None


def test_ccd_launch_reader_on_a_hand_built_trace():
    """ccd_launches_per_step.sim counts the launch calls that start inside
    a ``physics.ccd`` range (nested in ``physics.collision``), and reads
    nothing where the span is absent or the cell trains."""
    ops = [(0, 1000, "physics.collision"), (10, 11, "cudaLaunchKernel"),
           (100, 200, "physics.ccd"), (120, 121, "cudaLaunchKernel"),
           (150, 151, "aten::empty"), (199, 200, "cudaMemsetAsync"),
           (200, 201, "cudaLaunchKernel"), (300, 400, "physics.ccd"),
           (350, 351, "cuLaunchKernel"), (600, 601, "cudaMemcpyAsync"),
           (2000, 2100, "physics.ccd"), (2050, 2051, "cudaLaunchKernelExC"),
           (3000, 3001, "cudaLaunchKernel")]
    t = _trace(ops)
    ccd = _reader("ccd_launches_per_step.sim")
    col = _reader("collision_launches_per_step.sim")
    assert ccd.read({"driver": "sim", "trace": t}) == 4.0
    assert col.read({"driver": "sim", "trace": t}) == 6.0
    assert ccd.read({"driver": "train", "trace": t}) is None
    assert ccd.read({"driver": "sim"}) is None
    bare = _trace([o for o in ops if o[2] != "physics.ccd"])
    assert ccd.read({"driver": "sim", "trace": bare}) is None
    assert col.read({"driver": "sim", "trace": bare}) == 6.0


class _Event:
    """A stand-in for a CUDA timing event pair's start: ``elapsed_time``
    in ms to any end."""

    def __init__(self, ms=0.0):
        self.ms = ms

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_render_readers():
    """render_launches_per_step.sim counts the launch calls that start in
    a ``render.eyes`` range; render_roofline_pct.sim is the least time of
    the counted render over its timed device time; each reads nothing
    where the span or the counters are absent or the cell trains."""
    from benchmark import render_work, work
    launches = _reader("render_launches_per_step.sim")
    roof = _reader("render_roofline_pct.sim")
    ops = [(0, 100, "env.task"), (10, 50, "render.eyes"),
           (11, 12, "cudaLaunchKernel"), (20, 21, "cudaEventRecord"),
           (49, 50, "cudaMemsetAsync"), (60, 61, "cudaLaunchKernel"),
           (200, 300, "render.eyes"), (250, 251, "cuLaunchKernel")]
    t = _trace(ops)
    eyes = {"height": 4, "width": 4}
    ctx = {"driver": "sim", "trace": t, "B": 3, "config": {"eyes": eyes}}
    assert launches.read(ctx) == 3.0
    assert launches.read({"driver": "sim", "trace": _trace(ops[:1])}) is None
    assert launches.read({"driver": "train", "trace": t}) is None
    tm.clear()
    assert roof.read(ctx) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tm.count("render.rays", 3 * 16 * 2)
        tm.count("render.primitives", 5 + 6)
    assert roof.read(ctx) is None               # no device time: no share
    tm._events["render.eyes"].append((_Event(1.0), _Event(3.5)))
    assert tm.counters()["render.eyes.device_ms"] == 2.5
    flops = render_work.render_flops(96, 3 * 16 * 11)
    assert flops == 96 * render_work.SAMPLE_FLOPS + 528 * 24
    want = 100.0 * work.bound_s(flops, 4.0 * 96) / 2.5e-3
    assert roof.read(ctx) == pytest.approx(want, rel=1e-12)
    assert roof.read({**ctx, "config": {}}) is None
    assert roof.read({**ctx, "driver": "train"}) is None
    tm.clear()
    assert tm.counters() == {}


def test_counter_readers():
    used, reset = (_reader("solve_rows_used_pct.sim"),
                   _reader("reset_useful_pct.sim"))
    ctx = {"driver": "sim", "trace": _trace([])}
    tm.clear()
    assert used.read(ctx) is None and reset.read(ctx) is None
    with profile(activities=[ProfilerActivity.CPU]):
        tm.count("solver.rows", 8)
        tm.count("solver.rows_used", torch.tensor([1.0, 0.0, 2.0, 0.0]))
        tm.count("solver.rows", 8)
        tm.count("solver.rows_used", torch.tensor([0.0, 0.0, 5.0, 0.0]))
        tm.count("env.reset_built", 4)
        tm.count("env.done", torch.tensor([False, True, False, False]))
    assert used.read(ctx) == 100.0 * 3 / 16
    assert reset.read(ctx) == 25.0
    assert used.read(ctx) == 100.0 * 3 / 16      # reading clears nothing
    for r in (used, reset):
        assert r.read({"driver": "train", "trace": ctx["trace"]}) is None
        assert r.read({"driver": "sim"}) is None
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tm.count("env.reset_built", 1)          # a deterministic start
        tm.count("env.done", torch.tensor([True, True, False]))
    assert reset.read(ctx) == 100.0
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        tm.count("env.reset_built", 0)
    assert reset.read(ctx) == 100.0
    tm.clear()


def test_profile_step_tables(fly, traced):
    """profile_step's tables: the 15 stages and the ccd span inside
    collision in each kind of substep, the env's spans; no device time on
    the CPU."""
    env = fly[0]
    spans, ops = PS.timeline(traced["prof"])
    assert ops == [] and spans == [s for s in traced["spans"]
                                   if s[2].startswith(("physics.", "env."))]
    tables = PS.substep_tables(spans, ops, env.model.col_refresh)
    stages = {f"physics.{s}" for s in POSITION_VELOCITY + LATER + ("ccd",)}
    assert set(tables) == {"fresh", "update"}
    for t in tables.values():
        assert set(t) == stages
        assert all(v[0] > 0 and v[1] == 0 and v[2] == 0 for v in t.values())
    rows = PS.span_rows(spans, ops, "env.")
    assert set(rows) == {"env.step", "env.task", "env.reset",
                         "env.autoreset"}
    assert rows["env.step"][0] > rows["env.task"][0] > 0


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    env = WI.make_walk_imitation("cuda", dtype=torch.float32)
    gen = torch.Generator("cuda").manual_seed(0)
    lo, hi = env.action_spec()
    action = torch.as_tensor(lo + 0.3 * (hi - lo), dtype=torch.float32,
                             device="cuda")[None].expand(64, -1)
    state = env.autoreset_step(env.reset(64, gen), action)
    torch.cuda.synchronize()
    _, t = btrace.profile(lambda: env.autoreset_step(state, action))
    return t


@pytest.mark.cuda
def test_launch_calls_match_the_device_trace(card):
    """The launch calls inside env.step and env.autoreset number the
    device operations of the step."""
    k = _reader("kinematics_launches_per_step.sim")
    step, _ = k.launches_in(card, "env.step")
    reset, _ = k.launches_in(card, "env.autoreset")
    assert card.launches() > 1000
    assert abs(step + reset - card.launches()) <= 1e-3 * card.launches()


@pytest.mark.cuda
def test_no_device_interval_bears_a_span_name(card):
    spans = {n for _, _, n in card.ops if n.split(".")[0] in
             ("physics", "env")}
    assert len(spans) == 20
    assert not {n for _, _, n in card.device} & spans


@pytest.mark.cuda
def test_timed_span_on_the_card():
    """A span given the card, under a profiler, keeps its CUDA events; the
    counters read their interval, which holds the span's kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    x = torch.ones(1 << 24, device="cuda")
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        with tm.span("render.eyes", device=x.device):
            for _ in range(50):
                x = x * 1.0001
    c = tm.counters()
    tm.clear()
    assert set(c) == {"render.eyes.device_ms"}
    # 50 passes reading and writing 67 MB: 6.7 GB, 2.0 ms at the card's
    # peak bandwidth, so more in practice
    assert c["render.eyes.device_ms"] > 1.5
