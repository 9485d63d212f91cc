"""The convex narrowphase's wrapper (``ops/ccd_kernel.py``) and its CUDA
kernel (``csrc/ccd_narrowphase.cu``), on lanes taken from real fly and rat
states. JAX-free, so a GPU machine without JAX can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_ccd_kernel.py

On the CPU the wrapper is the plain version (``physics/ccd.py``) bit for
bit and never builds or loads the library; the tests marked ``cuda`` hold
the kernel against the plain version on the card and skip without one."""

import math

import pytest
import torch

from flybody_tpu_torch import rodent_envs as RE
from flybody_tpu_torch.envs import substeps
from flybody_tpu_torch.ops import ccd_kernel as CK
from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.physics import ccd
from flybody_tpu_torch.tasks import walk_imitation as WI
from flybody_tpu_torch.utils import telemetry as tm

MODELS = {
    "fly": lambda dev: WI.make_walk_imitation(dev, dtype=torch.float32),
    "rat": lambda dev: RE.rodent_two_touch(device=dev),
}
# the (axis1_flat, axis2_flat) pairs of each model's classes, in order
FLAGS = {"fly": [(False, False), (False, True), (True, False), (True, True)],
         "rat": [(False, False), (True, False)]}
U0 = ("none", "zero", "warm", "nonfinite")


class _Recorder:
    """Stands in for ``ccd_kernel.narrowphase`` while a step runs: keeps
    each call's (args, kwargs) and calls through. ``launches`` reads and
    writes the wrapped function's own count, which that function adds to
    by its module name."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def _calls(model: str, device: str, B: int) -> list:
    """The narrowphase calls of one control step after a reset, as
    [(args, kwargs)], on a ``model`` env of B envs on ``device``: the
    fresh substep's calls come first, one per class in class order."""
    env = MODELS[model](device)
    gen = torch.Generator(device).manual_seed(0)
    lo, hi = env.action_spec()
    action = torch.as_tensor(lo + 0.3 * (hi - lo), dtype=torch.float32,
                             device=device)[None].expand(B, -1)
    state = env.reset(B, gen)
    rec = _Recorder(CK.narrowphase)
    CK.narrowphase = rec
    # the eager loop on the card too: a CUDA graph's capture would call
    # the wrapper a second time, and its replays not at all
    engages = substeps.engages
    substeps.engages = lambda m, d: False
    try:
        env.autoreset_step(state, action)
    finally:
        CK.narrowphase = rec.fn
        substeps.engages = engages
    return rec.calls


@pytest.fixture(scope="module")
def cpu_lanes():
    return {m: _calls(m, "cpu", 2) for m in MODELS}


def _u0(kind: str, args, iters: int):
    """A warm start of each kind for the lanes ``args``: None, zeros
    (every lane reseeds), the plain version's own normals (a real warm
    start), and those with a NaN, an inf and a tiny lane."""
    if kind == "none":
        return None
    if kind == "zero":
        return torch.zeros_like(args[0])
    warm = ccd.narrowphase(*args, iters=iters)[2].clone()
    if kind == "nonfinite":
        warm[0, 0, 0] = float("nan")
        warm[1, :, -1] = float("inf")
        warm[2, :, 0] = 1e-3
    return warm


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("kind", U0)
@pytest.mark.parametrize("iters", [8, 5])
@pytest.mark.parametrize("model,cls", [("fly", k) for k in range(4)]
                         + [("rat", k) for k in range(2)])
def test_cpu_wrapper_is_the_plain_version(cpu_lanes, model, cls, iters,
                                          kind):
    """On CPU tensors the wrapper returns what ``ccd.narrowphase`` does,
    bit for bit, with and without nu, at the fresh and the update
    substep's iterations, for every class's flag pair."""
    args, _ = cpu_lanes[model][cls]
    assert (args[2][3], args[5][3]) == FLAGS[model][cls]
    u0 = _u0(kind, args, iters)
    n0 = CK.narrowphase.launches
    for with_nu in (True, False):
        got = CK.narrowphase(*args, iters=iters, u0=u0, with_nu=with_nu)
        want = ccd.narrowphase(*args, iters=iters, u0=u0, with_nu=with_nu)
        _same(got, want)
    assert CK.narrowphase.launches == n0


def test_cpu_classes_cover_the_flag_pairs(cpu_lanes):
    """A control step runs each class once a substep and once in the
    reset (fly: 4 classes x 11, rat: 2 x 21), each substep's calls in
    class order, at the fresh (8: one substep in 10, and the reset) or
    the update substep's (5) PGD iterations."""
    fresh = [8] + [5] * 9
    iters = {"fly": fresh + [8], "rat": fresh * 2 + [8]}
    for model, flags in FLAGS.items():
        calls = cpu_lanes[model]
        n = len(flags)
        assert [(a[2][3], a[5][3]) for a, _ in calls] == flags * (
            len(calls) // n)
        assert [kw["iters"] for _, kw in calls[::n]] == iters[model]
    assert (len(cpu_lanes["fly"]), len(cpu_lanes["rat"])) == (44, 42)


def test_cpu_never_builds_or_loads(cpu_lanes, monkeypatch):
    """A machine without CUDA runs the plain version: the wrapper asks
    cuda_build for nothing."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path touched the CUDA library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build_all", refuse)
    # earlier tests of the same pytest run on a card may have loaded it
    monkeypatch.setattr(cuda_build, "_loaded", {})
    args, kw = cpu_lanes["fly"][4]
    CK.narrowphase(*args, **kw)
    assert CK.SOURCE not in cuda_build._loaded


def _refusal_cases():
    def bad_dtype(a):
        a[0] = a[0].double()

    def bad_r(a):
        a[1] = a[1][:, 0]

    def bad_ell(a):
        a[2] = (a[2][0][:, :2],) + tuple(a[2][1:])

    def bad_device(a):
        a[4] = a[4].to("meta")

    return {"dtype": (bad_dtype, TypeError, "float32"),
            "R_shape": (bad_r, ValueError, "has shape"),
            "ell_shape": (bad_ell, ValueError, "has shape"),
            "device": (bad_device, ValueError, "expected")}


@pytest.mark.parametrize("case", list(_refusal_cases()))
def test_checks_refuse_like_solve_rows(cpu_lanes, case):
    """What the kernel does not take is refused on the terms of
    ``solve_rows``' checks (``check_args``): a dtype, a shape or a device
    other than p1's; strides are free."""
    fix, exc, match = _refusal_cases()[case]
    args, kw = cpu_lanes["fly"][7]
    a = list(args)
    fix(a)
    with pytest.raises(exc, match=match):
        CK.check_inputs(*a, kw["u0"])


def test_checks_broadcast_params_and_no_kernel_elsewhere(cpu_lanes):
    """A param of one env broadcasts over B as in the plain version; a
    tensor on neither the CPU nor a CUDA device is refused by the
    wrapper."""
    args, kw = cpu_lanes["rat"][3]
    a = list(args)
    ell, seg, r, flat = a[2]
    a[2] = (ell[..., :1], seg[..., :1], r[..., :1], flat)
    xs = CK.check_inputs(*a, kw["u0"])
    assert xs[2].shape == ell.shape and xs[2].stride()[-1] == 0
    assert len(xs) == len(CK.NAMES)
    assert len(CK.check_inputs(*args, None)) == len(CK.NAMES) - 1
    strided = torch.empty_like(args[0].transpose(1, 2)).transpose(1, 2)
    assert not strided.is_contiguous()
    assert CK.check_inputs(strided, *args[1:], None)[0] is strided
    meta = [x.to("meta") if torch.is_tensor(x) else x for x in args]
    with pytest.raises(ValueError, match="no kernel"):
        CK.narrowphase(*meta, iters=8)


def test_work_counts():
    """narrowphase_work: more iterations and flat axes cost more; the
    bytes are 45 words a (lane, env)."""
    w = [CK.narrowphase_work(24, 4096, it, a1, a2)
         for it in (5, 8) for a1, a2 in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert all(w[i]["flops"] < w[i + 4]["flops"] for i in range(4))
    assert w[1]["flops"] == w[2]["flops"] < w[3]["flops"]
    assert w[0]["bytes"] == 4 * 45 * 24 * 4096


# ---- on the card ---------------------------------------------------------

# Each of the kernel's answers checked in float64 by the plain code at the
# answer's own direction, (lane, env) by (lane, env), as chip_smoke.py
# holds it (its CCD_* constants, where the readings behind them are):
# at most max(TIE_LANES, TIE_SHARE x pairs) pairs, whose selects a
# rounding tipped, may misfit by over TOL_GAP or TOL_POS.
TOL_GAP = 1e-5
TOL_POS = 3e-4
TIE_LANES = 6
TIE_SHARE = 1e-5


@pytest.fixture(scope="module")
def card_lanes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return {(m, B): _calls(m, "cuda", B) for m in MODELS
            for B in (1, 7, 4097)}


def _lane_err(got, want, args):
    """Per (lane, env) error of (dist, pos, u) against ``want``:
    dist and pos over the pair's scale (its radii and centre distance),
    u as it is, the largest of them."""
    p1, _, (e1, s1, r1, _), p2, _, (e2, s2, r2, _) = args
    scale = (e1.amax(dim=1) + s1[:, 0] + r1[:, 0] + e2.amax(dim=1)
             + s2[:, 0] + r2[:, 0] + (p1 - p2).norm(dim=1)).double()
    d = (got[0].double() - want[0].double()).abs() / scale
    p = (got[1].double() - want[1].double()).abs().amax(dim=1) / scale
    u = (got[2].double() - want[2].double()).abs().amax(dim=1)
    return torch.maximum(torch.maximum(d, p), u).reshape(-1)


def _misfit(args64, dist64, out):
    """(gap, pos) misfit of a narrowphase answer ``out`` per (lane, env),
    in float64 by the plain code at the answer's own direction u: the gap
    misfit is the largest of |dist - the support gap at u|, how much worse
    u's gap is than the float64 run's ``dist64`` and ||u| - 1|, the pos
    misfit |pos - the refined witnesses at u|; lengths over the lane's
    magnitude (centres' distance from the origin, radii, half-axes,
    segment halves). On flat contacts u itself is ill-conditioned: the
    gap barely moves over a range of directions."""
    p1, R1, (e1, s1, r1, _), p2, R2, (e2, s2, r2, _) = args64
    dist, pos, u = (x.double() for x in out[:3])
    norm = u.norm(dim=1)
    u = u / norm[:, None]
    pair = ccd._Pair(p1, R1, (e1, s1), p2, R2, (e2, s2))
    sa, sb = pair.sup(u)
    d_at = -pair.f(u, sa, sb) - (r1 + r2)[:, 0]
    x1, x2 = ccd._refine_witnesses(u, sa, sb, p1, R1, (e1, s1), p2, R2,
                                   (e2, s2))
    pos_at = 0.5 * ((x1 + r1 * u) + (x2 - r2 * u))
    mag = (torch.maximum(p1.norm(dim=1), p2.norm(dim=1)) + e1.amax(dim=1)
           + s1[:, 0] + r1[:, 0] + e2.amax(dim=1) + s2[:, 0] + r2[:, 0])
    gap = torch.stack([(dist - d_at).abs(), (dist64 - d_at).clamp_min(0),
                       (norm - 1).abs() * mag]).amax(dim=0) / mag
    return gap, (pos - pos_at).abs().amax(dim=1) / mag


def _q(x, q):
    return torch.quantile(x, q).item()


@pytest.mark.parametrize("model", list(MODELS))
def test_misfit_tells_broken_answers(cpu_lanes, model):
    """The card's lane-by-lane check on the CPU: the plain float32
    version's answers fit within TOL_GAP and TOL_POS everywhere, while an
    answer without the witness refinement, or after one PGD iteration,
    misfits in more pairs than the check lets pass."""
    fits, broken = 0, {"refine": 0, "iters": 0}
    total = 0
    for args, kw in cpu_lanes[model]:
        a64 = [x.double() if torch.is_tensor(x) else x for x in args]
        a64[2] = tuple(x.double() if torch.is_tensor(x) else x
                       for x in args[2])
        a64[5] = tuple(x.double() if torch.is_tensor(x) else x
                       for x in args[5])
        u064 = None if kw.get("u0") is None else kw["u0"].double()
        d64 = ccd.narrowphase(*a64, **dict(kw, u0=u064))[0]
        for key, out in (
                ("fits", ccd.narrowphase(*args, **kw)),
                ("refine", ccd.narrowphase(*args, **dict(kw, refine=False))),
                ("iters", ccd.narrowphase(*args, **dict(kw, iters=1)))):
            gap, pos = _misfit(a64, d64, out)
            n = int(((gap > TOL_GAP) | (pos > TOL_POS)).sum())
            if key == "fits":
                fits += n
                total += gap.numel()
            else:
                broken[key] += n
    assert fits == 0
    cap = max(TIE_LANES, math.ceil(TIE_SHARE * total))
    assert min(broken.values()) > cap, broken


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 4097])
@pytest.mark.parametrize("model", list(MODELS))
def test_kernel_matches_plain_on_card(card_lanes, model, B):
    """Every call of a control step (fresh and update substeps, every
    class): the kernel against the plain version in float32 on the same
    tensors, and both against the plain version in float64. The kernel
    sums in another order and fuses multiply-adds, so it stands as far
    from float64 as float32 does: in median and 99th percentile over
    every lane (2x, plus 1e-7, a float32 ulp of a unit vector), and lane
    by lane its answer fits its inputs in float64 (see TOL_GAP). The
    multiplicity equals the plain version's wherever the two plain
    versions agree on it."""
    calls = card_lanes[(model, B)]
    n0 = CK.narrowphase.launches
    ek, ep, over, nu_bad, total = [], [], 0, 0, 0
    for args, kw in calls:
        got = CK.narrowphase(*args, **kw)
        want = ccd.narrowphase(*args, **kw)
        a64 = [x.double() if torch.is_tensor(x) else x for x in args]
        a64[2] = tuple(x.double() if torch.is_tensor(x) else x
                       for x in args[2])
        a64[5] = tuple(x.double() if torch.is_tensor(x) else x
                       for x in args[5])
        u064 = None if kw.get("u0") is None else kw["u0"].double()
        ref = ccd.narrowphase(*a64, **dict(kw, u0=u064))
        assert all(g.shape == w.shape and g.dtype == torch.float32
                   for g, w in zip(got, want))
        e_k, e_p = _lane_err(got, ref, args), _lane_err(want, ref, args)
        gap, pos = _misfit(a64, ref[0], got)
        over += int(((gap > TOL_GAP) | (pos > TOL_POS)).sum())
        nu_bad += int(((got[3] != want[3]) & (want[3] == ref[3])).sum())
        total += e_k.numel()
        ek.append(e_k)
        ep.append(e_p)
    torch.cuda.synchronize()
    assert CK.narrowphase.launches == n0 + len(calls)
    ek, ep = torch.cat(ek), torch.cat(ep)
    assert bool(torch.isfinite(ek).all())
    assert nu_bad == 0
    assert over <= max(TIE_LANES, math.ceil(TIE_SHARE * total)), over
    for q in (0.5, 0.99):
        assert _q(ek, q) <= 2 * _q(ep, q) + 1e-7, (q, _q(ek, q), _q(ep, q))


@pytest.mark.cuda
def test_nan_lane_stays_in_place_on_card(card_lanes):
    """A NaN in one (lane, env)'s input gives the plain version's NaNs
    there and leaves every other (lane, env) bit for bit as it was."""
    args, kw = card_lanes[("fly", 7)][7]
    clean = CK.narrowphase(*args, **kw)
    a = list(args)
    a[0] = args[0].clone()
    a[0][3, 1, 4] = float("nan")
    got = CK.narrowphase(*a, **kw)
    want = ccd.narrowphase(*a, **kw)
    for g, w, c in zip(got, want, clean):
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        rest = torch.ones_like(g, dtype=torch.bool)
        rest[3, ..., 4] = False
        assert torch.equal(g[rest], c[rest])
    assert bool(torch.isnan(got[0][3, 4]))


@pytest.mark.cuda
def test_kernel_refuses_float64_on_card(card_lanes):
    args, kw = card_lanes[("rat", 7)][2]
    a = list(args)
    a[1] = args[1].double()
    n0 = CK.narrowphase.launches
    with pytest.raises(TypeError, match="float32"):
        CK.narrowphase(*a, **kw)
    assert CK.narrowphase.launches == n0


@pytest.mark.cuda
def test_kernel_info_on_card():
    """No instance spills to local memory at 128 or 256 threads a
    block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    for ax1 in (False, True):
        for ax2 in (False, True):
            for threads in (128, 256):
                info = CK.kernel_info(ax1, ax2, threads)
                assert info["local_bytes"] == 0, (ax1, ax2, threads, info)
                assert info["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_every_lane_goes_through_the_kernel_on_card():
    """A fly step on the card launches the kernel on every narrowphase
    call, and under a profiler counts every lane: the main path never
    takes the plain version there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    from torch.profiler import ProfilerActivity, profile
    tm.clear()
    n0 = CK.narrowphase.launches
    with profile(activities=[ProfilerActivity.CPU]):
        calls = _calls("fly", "cuda", 64)
    c = tm.counters()
    tm.clear()
    # the env's reset, then the step's 10 substeps and its reset
    assert CK.narrowphase.launches - n0 == 48
    assert c["ccd.lanes"] == 96.0 * 64 * 12
    assert len(calls) == 44
