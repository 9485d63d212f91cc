"""The substep loop of a control step (``envs/substeps.py``): eager on the
CPU, one CUDA graph's replay on the card. JAX-free, so a GPU machine
without JAX can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_substep_graph.py

On the CPU the loop function gives what the loop inside ``FlyEnv.step``
gave before it was factored out, bit for bit, and the graph never
engages. The tests marked ``cuda`` hold the graph's control steps to the
eager loop's on the three benchmark configurations at 64 envs, check that
a kept state is not written by the next replay, that a warmed step makes
no host sync, and that a device trace of the replays holds every hand
kernel the eager loop launches, as often; they skip without a card."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from flybody_tpu_torch import fly_envs, rodent_envs
from flybody_tpu_torch import profile_step
from flybody_tpu_torch.envs import substeps
from flybody_tpu_torch.ops import ccd_kernel as CK
from flybody_tpu_torch.ops import kinematics_kernel as KK
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.utils import telemetry as tm

CONFIGS = {
    "walk_imitation": fly_envs.walk_imitation,
    "rodent_two_touch": rodent_envs.rodent_two_touch,
    "vision_flight": fly_envs.vision_guided_flight,
}
CPU_B = 4
CARD_B = 64
CARD_STEPS = 5
_CPU_ENVS: dict = {}


def cpu_env(name):
    if name not in _CPU_ENVS:
        torch.set_num_threads(2)
        _CPU_ENVS[name] = CONFIGS[name](device="cpu", dtype=torch.float32)
    return _CPU_ENVS[name]


def actions(env, k, B, device="cpu"):
    lo, hi = env.action_spec()
    rng = np.random.RandomState(k)
    return torch.as_tensor(lo + (hi - lo) * rng.rand(B, len(lo)),
                           dtype=env.dtype, device=device)


def inline_loop(m, data, n_substeps):
    """The substep loop as ``FlyEnv.step`` held it inline: (final Data,
    mean sensordata, each substep's sol_f)."""
    r = int(m.col_refresh or 1)
    sensors, sol_f = [], []
    for k in range(n_substeps):
        data = F.step(m, data, col_update=(r > 1 and k % r != 0))
        sensors.append(data.sensordata)
        sol_f.append(data.sol_f)
    return data, torch.stack(sensors).mean(dim=0), sol_f


def assert_same(got, want, what=""):
    a, b = substeps.leaves(got), substeps.leaves(want)
    assert len(a) == len(b), what
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        assert torch.equal(x, y), (what, i)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_loop_function_is_the_inline_loop(name):
    """Four control steps at 4 envs: from each step's input, ``run`` gives
    every Data field, the sensor mean and each substep's sol_f that the
    inline loop gives, bit for bit."""
    env = cpu_env(name)
    m, n = env.model, env.n_substeps
    state = env.reset(CPU_B, torch.Generator().manual_seed(0))
    for k in range(4):
        a = actions(env, k, CPU_B)
        data, _ = env.task.before_step(m, state.data, state.task_state, a)
        want = inline_loop(m, data, n)
        got = substeps.run(m, data, n)
        assert len(got[2]) == n
        assert_same(got[0], want[0], f"step {k} data")
        assert torch.equal(got[1], want[1])
        for x, y in zip(got[2], want[2]):
            assert torch.equal(x, y)
        state = env.autoreset_step(state, a)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_never_engages_on_cpu(name):
    """On CPU tensors the loop runs eager: ``engages`` is False, no graph
    is kept, and over a profiled control step ``physics.substeps`` counts
    the step's substeps and ``physics.graph_substeps`` reads 0, beside
    B1's row counters."""
    env = cpu_env(name)
    state = env.reset(CPU_B, torch.Generator().manual_seed(1))
    a = actions(env, 0, CPU_B)
    data, _ = env.task.before_step(env.model, state.data, state.task_state,
                                   a)
    assert not substeps.engages(env.model, data)
    tm.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        env.step(state, a)
    c = tm.counters()
    tm.clear()
    assert c["physics.substeps"] == env.n_substeps
    assert c.get("physics.graph_substeps", 0.0) == 0.0
    R = state.data.sol_f.shape[0]
    assert c["solver.rows"] == env.n_substeps * R * CPU_B
    assert 0 < c["solver.rows_used"] <= c["solver.rows"]
    assert not env._graphs._graphs


@pytest.mark.parametrize("name", ["walk_imitation", "rodent_two_touch"])
def test_touch_sensors_equal_isin(name):
    """Each touch sensor reads the selected normal forces on its body's
    analytic contact slots: what ``torch.isin`` over those slots gives,
    bit for bit (the sensors gather from a mask over the candidate slots
    instead: ``isin`` waits for the device)."""
    from flybody_tpu_torch.physics import collision as COL
    from flybody_tpu_torch.physics import sensors as S
    from flybody_tpu_torch.physics import types as T
    env = cpu_env(name)
    m = env.model
    state = env.reset(CPU_B, torch.Generator().manual_seed(5))
    for k in range(2):
        state = env.autoreset_step(state, actions(env, k, CPU_B))
    d = S.sensor(m, state.data)
    lay = COL.slot_layout(m)
    n = 0
    for st, b, a in zip(np.asarray(m.sensor_type), np.asarray(m.sensor_objid),
                        np.asarray(m.sensor_adr)):
        if st != T.SENS_TOUCH:
            continue
        b = int(m.site_bodyid[b])
        slots = torch.as_tensor(
            np.flatnonzero((lay.b1 == b) | (lay.b2 == b)))
        mask = torch.isin(d.warm_sel.long(), slots).to(d.qpos.dtype)
        want = torch.clamp(torch.sum(d.warm_f[:, 0] * mask, dim=0), min=0.0)
        assert torch.equal(d.sensordata[a], want)
        n += int(bool(mask.any()))
    assert n > 0


def test_leaves_round_trip():
    """``rebuild`` puts back every tensor ``leaves`` takes out, the
    contact's nested fields included, in the same order."""
    env = cpu_env("walk_imitation")
    d = env.reset(CPU_B, torch.Generator().manual_seed(2)).data
    ts = substeps.leaves(d)
    assert len(ts) > len(dataclasses.fields(d))
    back = substeps.rebuild(d, iter([t + 1 for t in ts]))
    for x, y in zip(substeps.leaves(back), ts):
        assert torch.equal(x, y + 1)
    assert torch.equal(back.contact.frame, d.contact.frame + 1)


@pytest.mark.parametrize("col_refresh, n, block", [
    (10, 10, 10), (10, 20, 10), (4, 4, 4), (3, 6, 3), (1, 10, 10),
    (4, 6, 6)])
def test_graph_holds_one_block_or_the_whole_schedule(col_refresh, n, block):
    """A graph holds one col_refresh block where col_refresh > 1 divides
    the substeps, else the whole schedule (a block of one substep would
    copy the state once a substep)."""
    model = types.SimpleNamespace(col_refresh=col_refresh,
                                  opt=types.SimpleNamespace(timestep=None))
    assert substeps._Graph(model, n).block == block


class _Kernel:
    """A device event of a trace, as ``kineto_results.events()`` gives it."""

    def __init__(self, name, device_type=torch.autograd.DeviceType.CUDA):
        self._name, self._type = name, device_type

    def name(self):
        return self._name

    def device_type(self):
        return self._type


def test_hand_launches_reads_the_kernels_names():
    """``hand_launches`` maps each hand kernel's device name (as a card's
    trace spells it) to its wrapper and counts every event; other kernels
    and host events with a kernel's name count nothing."""
    ns = "void (anonymous namespace)::"
    names = {
        f"{ns}solve_rows_kernel<5>(float const*, int)": ("solve_rows", 3),
        f"{ns}solve_rows_kernel<6>(float const*, int)": ("solve_rows", 2),
        f"{ns}apgd_kernel<6>(float const*)": ("apgd_iterate", 1),
        f"{ns}upsolve_yd_kernel<true>(float const*)":
            ("upsolve_build_yd", 4),
        f"{ns}upsolve_yd_kernel<false>(float const*)": ("upsolve_yd", 1),
        f"{ns}admm_kernel(float const*, float const*)": ("admm_iterate", 2),
        f"{ns}ccd_kernel<false, true>({ns[5:]}Args)":
            ("ccd_narrowphase", 7),
        f"{ns}kin_kernel<float>({ns[5:]}Args<float>)": ("kinematics", 11),
        "void at::native::vectorized_elementwise_kernel<4>(int)": (None, 9),
    }
    events = [_Kernel(k) for k, (_, n) in names.items() for _ in range(n)]
    events.append(_Kernel(next(iter(names)), torch.autograd.DeviceType.CPU))
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    want = dict.fromkeys(profile_step.HAND_WRAPPERS.values(), 0)
    for wrapper, n in names.values():
        if wrapper:
            want[wrapper] += n
    assert profile_step.hand_launches(prof) == want
    by_name = profile_step.hand_kernels(prof)
    assert by_name[f"{ns}solve_rows_kernel<5>(float const*, int)"] == 3
    assert len(by_name) == len(names) - 1


def test_unrecorded_drops_what_is_counted_inside():
    """Counters made inside ``tm.unrecorded()`` (a capture's) are dropped;
    those before it stay."""
    tm.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tm.count("a", 2)
        tm.count("t", torch.ones(3))
        with tm.unrecorded():
            tm.count("a", 5)
            tm.count("b", 1)
            tm.count("t", torch.ones(4))
        assert tm.recording()
    assert not tm.recording()
    c = tm.counters()
    tm.clear()
    assert c == {"a": 2.0, "t": 3.0}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


_CARD_ENVS: dict = {}


def card_env(name, card):
    if name not in _CARD_ENVS:
        _CARD_ENVS[name] = CONFIGS[name](device=card, dtype=torch.float32)
    return _CARD_ENVS[name]


def eager_step(env, state, a, monkeypatch):
    """``env.step`` with the graph kept off."""
    with monkeypatch.context() as mp:
        mp.setattr(substeps, "engages", lambda m, d: False)
        return env.step(state, a)


def named_leaves(x, path="") -> list:
    """[(path, tensor)] of an EnvState: dataclasses, dicts, tuples."""
    if isinstance(x, torch.Tensor):
        return [(path, x)]
    if dataclasses.is_dataclass(x):
        x = {f.name: getattr(x, f.name) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in named_leaves(x[k],
                                                          f"{path}.{k}")]
    if isinstance(x, (tuple, list)):
        return [t for i, k in enumerate(x)
                for t in named_leaves(k, f"{path}[{i}]")]
    return []


def field_misfit(got, want) -> tuple:
    """(the largest distance of any tensor of ``got`` from ``want``'s over
    that tensor's largest magnitude, its path, the tensors not equal bit
    for bit, NaN equal to NaN where both have one); an integer or boolean
    tensor that differs counts 1."""
    worst, where, unequal = 0.0, "", 0
    a, b = named_leaves(got), named_leaves(want)
    assert [n for n, _ in a] == [n for n, _ in b]
    for (n, x), (_, y) in zip(a, b):
        if x.dtype == y.dtype and x.shape == y.shape and (
                torch.equal(x, y) or x.is_floating_point() and torch.allclose(
                    x, y, rtol=0.0, atol=0.0, equal_nan=True)):
            continue
        unequal += 1
        if not x.is_floating_point():
            e = 1.0
        else:
            scale = float(y.abs().max())
            e = float((x - y).abs().max()) / (scale if scale > 0 else 1.0)
        if e > worst:
            worst, where = e, n
    return worst, where, unequal


def steps_against_eager(env, card, seed, monkeypatch) -> list:
    """Five control steps through ``FlyEnv.step`` (the first captures the
    graph, the other four replay it, ``physics.graph_substeps`` says so),
    each beside two eager steps from the same state and draws: per step
    (graph vs eager, eager vs eager), each a ``field_misfit``."""
    gen = torch.Generator(card).manual_seed(seed)
    state = env.reset(CARD_B, gen)
    out = []
    for k in range(CARD_STEPS):
        a = actions(env, k, CARD_B, card)
        rng = gen.get_state()
        want = eager_step(env, state, a, monkeypatch)
        gen.set_state(rng)
        again = eager_step(env, state, a, monkeypatch)
        gen.set_state(rng)
        tm.clear()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            got = env.step(state, a)
        c = tm.counters()
        tm.clear()
        assert c["physics.graph_substeps"] == (env.n_substeps if k else 0)
        out.append((field_misfit(got, want), field_misfit(again, want)))
        state = env.apply_autoreset(got)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_graph_matches_eager_on_card(card, name, monkeypatch):
    """With deterministic algorithms on (the scatter-adds sort instead of
    adding atomically), five control steps through the graph equal the
    eager loop's bit for bit, as two eager runs equal each other. With
    them off, the atomics' order moves the last bits and the contact
    selection amplifies them within a step, in two eager runs as in the
    graph against eager: printed, not held."""
    env = card_env(name, card)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = steps_against_eager(env, card, 3, monkeypatch)
    finally:
        torch.use_deterministic_algorithms(False)
    free = steps_against_eager(env, card, 3, monkeypatch)
    print(f"{name}: per step (graph vs eager, eager vs eager), each "
          f"(misfit, where, tensors not bit-equal); deterministic {det}; "
          f"atomic {free}")
    assert all(e[2] == 0 for e, _ in det), det
    assert all(e[2] == 0 for _, e in det), det


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_kept_state_is_not_written_by_a_replay_on_card(card, name):
    """The state step k returns is unchanged after step k+1 replays the
    graph, and no tensor a step returns shares memory with the graph's
    buffers."""
    env = card_env(name, card)
    gen = torch.Generator(card).manual_seed(4)
    state = env.reset(CARD_B, gen)
    for k in range(2):
        state = env.autoreset_step(state, actions(env, k, CARD_B, card))
    kept = env.step(state, actions(env, 2, CARD_B, card))
    snap = [t.clone() for _, t in named_leaves(kept)]
    nxt = env.step(env.apply_autoreset(kept), actions(env, 3, CARD_B, card))
    torch.cuda.synchronize()
    for (n, t), s in zip(named_leaves(kept), snap):
        assert torch.equal(t, s), n
    buffers = {t.untyped_storage().data_ptr()
               for g in env._graphs._graphs.values()
               for t in g.inputs + g.written + g.sensors + g.sol_f}
    for st in (kept, nxt):
        for n, t in named_leaves(st):
            assert t.untyped_storage().data_ptr() not in buffers, n


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_warm_step_makes_no_host_sync_on_card(card, name):
    """A warmed control step raises nothing with CUDA's sync debug mode
    set to error."""
    env = card_env(name, card)
    gen = torch.Generator(card).manual_seed(5)
    state = env.reset(CARD_B, gen)
    for k in range(2):
        state = env.autoreset_step(state, actions(env, k, CARD_B, card))
    a = actions(env, 2, CARD_B, card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        env.step(state, a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CONFIGS))
def test_replays_count_their_launches_on_card(card, name, monkeypatch):
    """A device trace of N control steps replayed holds each hand kernel
    (by its device name) N times as often as that of one eager step: no
    kernel of the loop is left out of the graph. A replay calls no
    kernel wrapper, so their ``.launches`` (host calls) stay as they
    were."""
    env = card_env(name, card)
    gen = torch.Generator(card).manual_seed(6)
    state = env.reset(CARD_B, gen)
    state = env.autoreset_step(state, actions(env, 0, CARD_B, card))
    a = actions(env, 1, CARD_B, card)

    def traced(step, n):
        with profile_step.launch_trace() as prof:
            for _ in range(n):
                step()
        tm.clear()
        return profile_step.hand_kernels(prof)

    once = traced(lambda: eager_step(env, state, a, monkeypatch), 1)
    assert sum(once.values()) > 0
    calls = [w.launches for w in (SK.solve_rows, CK.narrowphase,
                                  KK.kinematics)]
    N = 3
    got = traced(lambda: env.step(state, a), N)
    assert got == {k: N * v for k, v in once.items()}
    assert calls == [w.launches for w in (SK.solve_rows, CK.narrowphase,
                                          KK.kinematics)]
