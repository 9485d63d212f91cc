"""Forward kinematics' wrapper (``ops/kinematics_kernel.py``) and its CUDA
kernel (``csrc/kinematics.cu``), on random states of the fly, the rat,
vision flight, the humanoid and walk_on_ball. JAX-free, so a GPU machine
without JAX can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kinematics_kernel.py

On the CPU the wrapper is the plain version (``physics/kinematics.py``)
bit for bit and never builds or loads the library; the tests marked
``cuda`` hold the kernel against the plain version in float64 on the card
and skip without one."""

import numpy as np
import pytest
import torch

from flybody_tpu_torch import fly_envs as FE
from flybody_tpu_torch import rodent_envs as RE
from flybody_tpu_torch.inverse_kinematics import qpos_from_site_xpos
from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops import kinematics_kernel as KK
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.utils import telemetry as tm

MODELS = {
    "walk_imitation": lambda dev: FE.walk_imitation(device=dev).model,
    "rodent_two_touch": lambda dev: RE.rodent_two_touch(device=dev).model,
    "vision_flight": lambda dev: FE.vision_guided_flight(device=dev).model,
    "humanoid": lambda dev: RE.walk_humanoid(device=dev).model,
    "walk_on_ball": lambda dev: FE.walk_on_ball(device=dev).model,
}


def _with_slide(m):
    """``m`` with its fourth hinge made a slide joint (no committed model
    has one)."""
    jt = np.array(m.jnt_type)
    jt[np.nonzero(jt == T.HINGE)[0][3]] = T.SLIDE
    return m.replace(jnt_type=jt)


def _qpos(m, B: int, seed: int = 0) -> torch.Tensor:
    """(nq, B) float64 on the CPU: qpos0 moved by up to 1 rad or unit on
    every coordinate, each free joint's quaternion and each ball's drawn
    whole with a norm of 0.5 to 2 (not normalised)."""
    rng = np.random.default_rng(seed)
    q = np.asarray(m.qpos0.double().cpu())[:, None] + rng.uniform(
        -1, 1, (m.nq, B))
    for j, t in enumerate(np.asarray(m.jnt_type)):
        a = int(m.jnt_qposadr[j])
        if t in (T.FREE, T.BALL):
            a += 3 if t == T.FREE else 0
            v = rng.normal(size=(4, B))
            q[a:a + 4] = v / np.linalg.norm(v, axis=0) * rng.uniform(
                0.5, 2.0, B)
    return torch.as_tensor(q)


def _data(m, qpos):
    return io_mj.make_data(m, qpos.shape[1], dtype=qpos.dtype).replace(
        qpos=qpos.to(m.device))


@pytest.fixture(scope="module")
def cpu_models():
    return {k: mk("cpu") for k, mk in MODELS.items()}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(MODELS) + ["slide"])
def test_cpu_wrapper_is_the_plain_version(cpu_models, name, dtype):
    """On CPU tensors the wrapper returns what ``K.kinematics`` does, bit
    for bit, and launches nothing."""
    m = (_with_slide(cpu_models["walk_on_ball"]) if name == "slide"
         else cpu_models[name]).to(dtype=dtype)
    d = _data(m, _qpos(m, 5).to(dtype))
    n0 = KK.kinematics.launches
    got, want = KK.kinematics(m, d), K.kinematics(m, d)
    for k in KK.OUTPUTS:
        torch.testing.assert_close(getattr(got, k), getattr(want, k),
                                   rtol=0, atol=0)
    assert got.qpos is d.qpos
    assert KK.kinematics.launches == n0


def test_cpu_never_builds_or_loads(cpu_models, monkeypatch):
    """A machine without CUDA runs the plain version: the wrapper asks
    cuda_build for nothing."""
    def refuse(*a, **kw):
        raise AssertionError("the CPU path touched the CUDA library")

    monkeypatch.setattr(cuda_build, "load", refuse)
    monkeypatch.setattr(cuda_build, "build_all", refuse)
    # earlier tests of the same pytest run on a card may have loaded it
    monkeypatch.setattr(cuda_build, "_loaded", {})
    m = cpu_models["walk_imitation"]
    KK.kinematics(m, _data(m, _qpos(m, 2).float()))
    assert KK.SOURCE not in cuda_build._loaded


def test_bodies_are_counted(cpu_models):
    """Under a profiler each call counts nbody x B ``kinematics.bodies``,
    on the CPU path too."""
    from torch.profiler import ProfilerActivity, profile
    m = cpu_models["rodent_two_touch"]
    d = _data(m, _qpos(m, 3).float())
    tm.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        KK.kinematics(m, d)
        KK.kinematics(m, d)
    c = tm.counters()
    tm.clear()
    assert c["kinematics.bodies"] == 2 * m.nbody * 3


def test_forward_step_calls_the_wrapper_once(cpu_models, monkeypatch):
    """``physics.forward.step`` computes the kinematics through the
    wrapper, once a substep."""
    calls = []

    def spy(m, d):
        calls.append(d.qpos.shape)
        return K.kinematics(m, d)

    monkeypatch.setattr(KK, "kinematics", spy)
    m = cpu_models["walk_on_ball"]
    d = F.step(m, _data(m, m.qpos0[:, None].repeat(1, 2)))
    F.step(m, d)
    assert calls == [(m.nq, 2)] * 2


def test_tables_follow_the_kernels_layout(cpu_models):
    """The int and float tables hold the model's tables in the order
    ``kin_launch`` reads them, the local rotations as ``bquat.to_mat``
    of the model's quaternions, in the dtype asked for; built once."""
    from flybody_tpu_torch.math import bquat as bq
    m = cpu_models["walk_imitation"]
    itab, ftab = KK.tables(m, torch.float64)
    assert KK.tables(m, torch.float64)[1] is ftab
    assert itab.dtype == torch.int32 and ftab.dtype == torch.float64
    ints = [m.body_parentid, m.body_jntadr, m.body_jntnum, m.jnt_type,
            m.jnt_qposadr, m.geom_bodyid, m.site_bodyid]
    assert np.array_equal(itab.numpy(), np.concatenate(
        [np.asarray(x).reshape(-1) for x in ints]))
    mats = {q: bq.to_mat(getattr(m, q)[..., None])[..., 0]
            for q in ("body_iquat", "geom_quat", "site_quat")}
    parts = [m.body_pos, m.body_quat, m.body_ipos, mats["body_iquat"],
             m.jnt_pos, m.jnt_axis, m.qpos0, m.geom_pos, mats["geom_quat"],
             m.site_pos, mats["site_quat"]]
    assert torch.equal(ftab, torch.cat([x.reshape(-1).double()
                                        for x in parts]))


@pytest.mark.parametrize("B", [1, 5, 128])
def test_outputs_keep_the_plain_layout(cpu_models, B):
    """The kernel's outputs are allocated in the plain version's shapes
    and strides (its einsum products laid out (n, 3, B, 3)), so the
    stages after kinematics run the same ops on either path."""
    for m in cpu_models.values():
        want = K.kinematics(m, _data(m, _qpos(m, B).float()))
        got = KK.outputs(m, B, torch.float32, "cpu")
        for k in KK.OUTPUTS:
            w = getattr(want, k)
            assert (got[k].shape, got[k].stride()) == (w.shape, w.stride())


def test_refuses_what_the_kernel_does_not_take(cpu_models):
    """A body whose parent comes after it, a joint no body owns, a
    misshapen or integer qpos, and a device with no kernel are refused;
    a strided qpos is taken."""
    m = cpu_models["walk_on_ball"]
    parent = np.array(m.body_parentid)
    parent[3] = 5
    with pytest.raises(ValueError, match="parent"):
        KK.tables(m.replace(body_parentid=parent), torch.float32)
    num = np.array(m.body_jntnum)
    num[np.nonzero(num)[0][-1]] -= 1
    with pytest.raises(ValueError, match="joint ranges"):
        KK.tables(m.replace(body_jntnum=num), torch.float32)
    q = _qpos(m, 4).float()
    KK.check_qpos(m, q.t().contiguous().t())
    with pytest.raises(ValueError, match="shape"):
        KK.check_qpos(m, q[1:])
    with pytest.raises(TypeError, match="float32"):
        KK.check_qpos(m, q.long())
    KK.check_qpos(m, q)
    meta = _data(m, q).replace(qpos=q.to("meta"))
    with pytest.raises(ValueError, match="no kernel"):
        KK.kinematics(m, meta)


def test_work_counts():
    """kinematics_work: the bytes are qpos read and every output written
    once; a hinge costs more than a slide and a free joint nothing."""
    w = KK.kinematics_work(68, 103, 77, 15, 109, 4096)
    assert w["bytes"] == 4.0 * 4096 * (109 + 68 * 28 + 103 * 6 + 92 * 12)
    assert w["bytes"] / 3.35e12 > w["flops"] / 67e12
    types = [T.FREE, T.BALL, T.SLIDE, T.HINGE]
    per = [KK.kinematics_work(2, 1, 0, 0, 7, 1, jnt_type=[t])["flops"]
           for t in types]
    assert per[0] < per[2] < per[1] < per[3]
    assert KK.kinematics_work(2, 1, 0, 0, 7, 1)["flops"] == per[3]


# ---- on the card ---------------------------------------------------------

# The kernel in float32 stands as far from the plain version in float64 as
# the plain version in float32 does: per output, its largest error over
# every entry at most F32_RATIO times the plain float32 version's, plus
# F32_SLACK float32 ulps of the output's scale (the two round in another
# order: nvcc fuses multiply-adds). In float64 both are the same
# arithmetic: F64_ULPS float64 ulps of the output's scale.
F32_RATIO = 2.0
F32_SLACK = 8 * 2.0 ** -23
F64_ULPS = 64 * 2.0 ** -52
CARD_B = 4097


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda")


def _hold(m_cpu, card, dtype, B=CARD_B):
    """The kernel on ``m_cpu``'s model on the card in ``dtype`` against
    the plain version there and the plain version in float64 on the CPU
    (the truth), on random states of B envs."""
    q64 = _qpos(m_cpu, B, seed=B)
    truth = K.kinematics(m_cpu.to(dtype=torch.float64),
                         _data(m_cpu.to(dtype=torch.float64), q64))
    m = m_cpu.to(device=card, dtype=dtype)
    d = _data(m, q64.to(dtype))
    n0 = KK.kinematics.launches
    got = KK.kinematics(m, d)
    plain = K.kinematics(m, d)
    torch.cuda.synchronize()
    assert KK.kinematics.launches == n0 + 1
    for k in KK.OUTPUTS:
        g, p, t = (getattr(x, k) for x in (got, plain, truth))
        assert g.dtype == dtype
        assert (g.shape, g.stride()) == (p.shape, p.stride())
        scale = max(t.abs().max().item(), 1.0)
        e_k = (g.double().cpu() - t).abs().max().item()
        e_p = (p.double().cpu() - t).abs().max().item()
        if dtype == torch.float64:
            assert e_k <= F64_ULPS * scale, (k, e_k)
        else:
            assert e_k <= F32_RATIO * e_p + F32_SLACK * scale, (k, e_k, e_p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", list(MODELS) + ["slide"])
def test_kernel_matches_plain_on_card(cpu_models, card, name, dtype):
    """Every output of the kernel on 4097 random states (not a multiple of
    128; free-joint and ball quaternions not normalised) of each model,
    and of walk_on_ball with a slide joint."""
    m = (_with_slide(cpu_models["walk_on_ball"]) if name == "slide"
         else cpu_models[name])
    _hold(m, card, dtype)


@pytest.mark.cuda
def test_kernel_reads_strided_qpos_on_card(cpu_models, card):
    """A transposed qpos (as a tracking task's reset hands it over) and a
    slice of a wider batch give what their contiguous copy gives, bit for
    bit."""
    m = cpu_models["rodent_two_touch"].to(device=card)
    wide = _qpos(m, 300).float().to(card)
    for q in (wide.t().contiguous().t(), wide[:, 7:271]):
        assert not q.is_contiguous()
        got = KK.kinematics(m, _data(m, q))
        want = KK.kinematics(m, _data(m, q.contiguous()))
        for k in KK.OUTPUTS:
            assert torch.equal(getattr(got, k), getattr(want, k)), k


@pytest.mark.cuda
def test_one_launch_per_step_on_card(cpu_models, card):
    """A substep (``physics.forward.step``) launches the kernel exactly
    once; on the card the plain version is never taken."""
    m = cpu_models["walk_imitation"].to(device=card)
    d = F.step(m, _data(m, m.qpos0[:, None].repeat(1, 64)))
    for _ in range(3):
        n0 = KK.kinematics.launches
        d = F.step(m, d)
        assert KK.kinematics.launches == n0 + 1
    torch.cuda.synchronize()
    assert bool(torch.isfinite(d.qpos).all())


@pytest.mark.cuda
def test_kernel_info_on_card(card):
    """The float32 instance, the main path's, uses no local memory at 128
    threads a block. The float64 one keeps only the 40-byte stack frame of
    the double sine and cosine's argument reduction (taken for large
    angles; ptxas reports no spill stores)."""
    for dtype, local in ((torch.float32, 0), (torch.float64, 40)):
        info = KK.kernel_info(dtype)
        assert info["local_bytes"] <= local, (dtype, info)
        assert info["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_ik_differentiates_on_card(cpu_models, card):
    """``inverse_kinematics.qpos_from_site_xpos`` still differentiates
    the plain kinematics on CUDA tensors: 20 steps on the card in float64
    equal the same steps on the CPU, and the site error falls."""
    out = {}
    for dev in ("cpu", card):
        m = cpu_models["humanoid"].to(device=dev, dtype=torch.float64)
        d = K.kinematics(m, io_mj.make_data(m, 3))
        sites = np.arange(4)
        target = d.site_xpos[sites] + 0.05
        n0 = KK.kinematics.launches
        res = qpos_from_site_xpos(m, d, sites, target, np.arange(7, m.nq),
                                  lr=0.05, beta=0.5, max_steps=20)
        assert KK.kinematics.launches == n0
        assert res.site_error.item() < 0.05 * target.numel() ** 0.5
        out[str(dev)] = res.qpos.cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-9,
                               atol=1e-9)
