"""The port's CUDA kernels on the card, and the wrappers' refusal to fall
back anywhere else. JAX-free, so a GPU machine without JAX can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py imports JAX).
The tests marked ``cuda`` skip where no CUDA device is present."""

import os
import shutil

import numpy as np
import pytest
import torch

from flybody_tpu_torch.ops import admm_kernel as AK
from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.ops import tree_ldl as TL

KW = dict(kl=32, kc=40, iterations=20, noslip_iterations=3, power_iters=4)
ROW_ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
            "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr")
UP_ARGS = ROW_ARGS[7:]
APGD_ARGS = ("rreg", "active", "mu", "f0", "v0")
ADMM_KW = dict(kl=40, kc=62, iterations=20)     # wob-admm: 226 rows


def _problem(device, dtype, B=8):
    p = SK.random_rows_problem(B=B, seed=1)
    tree = TL.build_tree_meta(p["parent"])
    ld, dinv = TL.factor(tree, torch.as_tensor(p["Ms"], device=device).to(
        dtype))
    args = {k: torch.as_tensor(p[k], device=device).to(
        torch.int32 if p[k].dtype == np.int32 else dtype)
        for k in ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd",
                  "qacc_smooth", "qvel", "kcoef", "bcoef", "posr", "rreg",
                  "active", "mu", "f0", "v0")}
    args.update(ld=ld, dinv=dinv)
    return tree, args


def _admm_problem(device, dtype, B=8, seed=2):
    """W = (A_s + rho I)^-1 of a random unit-diagonal SPD A_s, and the
    rest of admm_iterate's inputs, at wob-admm's layout."""
    rng = np.random.RandomState(seed)
    rows = ADMM_KW["kl"] + 3 * ADMM_KW["kc"]
    G = rng.randn(B, rows, 2 * rows) / np.sqrt(2 * rows)
    A = G @ G.transpose(0, 2, 1)
    dg = 1.0 / np.sqrt(np.einsum("bii->bi", A))
    A = A * dg[:, :, None] * dg[:, None, :]
    W = np.linalg.inv(A + 10.0 * np.eye(rows)).transpose(1, 2, 0)
    p = dict(W=W, b=rng.randn(rows, B), z0=rng.randn(rows, B),
             mu=rng.rand(ADMM_KW["kc"], B) * 0.8 + 0.2,
             active=(rng.rand(rows, B) > 0.2).astype(np.float64))
    return {k: torch.as_tensor(v, device=device).to(dtype)
            for k, v in p.items()}


def _stage_calls(tree, a):
    """(wrapper, call) of the three stage kernels on _problem's inputs."""
    jt = SK.build_jt_reference(*(a[k] for k in ROW_ARGS[:7])).contiguous()
    yd, b = (x.contiguous() for x in SK.upsolve_build_yd_reference(
        tree, *(a[k] for k in ROW_ARGS)))
    return [
        (SK.upsolve_build_yd, lambda f: f(tree, *(a[k] for k in ROW_ARGS))),
        (SK.upsolve_yd, lambda f: f(tree, jt, *(a[k] for k in UP_ARGS))),
        (SK.apgd_iterate,
         lambda f: f(yd, b, *(a[k] for k in APGD_ARGS), **KW)),
    ]


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused by every wrapper; nothing falls back to the plain version."""
    tree, args = _problem("meta", torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        SK.solve_rows(tree, **args, **KW)
    for fn, call in _stage_calls(tree, args):
        with pytest.raises(ValueError, match="no kernel"):
            call(fn)
    with pytest.raises(ValueError, match="no kernel"):
        AK.admm_iterate(*_admm_problem("meta", torch.float32).values(),
                        **ADMM_KW)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes the library path of every
    source, so a stale library is never loaded (on a copy of csrc/)."""
    in_tree = cuda_build.lib_path("solve_rows")
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    before = cuda_build.lib_path("solve_rows")
    assert before == in_tree
    (csrc / "shared.cuh").write_text("// a header\n")
    added = cuda_build.lib_path("solve_rows")
    (csrc / "shared.cuh").write_text("// an edited header\n")
    edited = cuda_build.lib_path("solve_rows")
    assert len({before, added, edited}) == 3


def test_build_needs_nvcc():
    """Without the CUDA toolkit the build raises instead of skipping."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_all(["solve_rows"])


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (float32, B=256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float32, B=256)
    n0 = SK.solve_rows.launches
    got = SK.solve_rows(tree, **args, **KW)
    want = SK.solve_rows_reference(tree, **args, **KW)
    torch.cuda.synchronize()
    assert SK.solve_rows.launches == n0 + 1
    # float32, other summation order: see chip_smoke.py's tolerances
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-3


@pytest.mark.cuda
def test_kernel_refuses_float64_on_card():
    """The kernel takes float32 only; float64 CUDA tensors raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float64)
    n0 = SK.solve_rows.launches
    with pytest.raises(TypeError, match="float32"):
        SK.solve_rows(tree, **args, **KW)
    assert SK.solve_rows.launches == n0


def _max_rel(g, w):
    return ((g - w).abs().max() / w.abs().max()).item()


@pytest.mark.cuda
def test_stage_kernels_match_plain_on_card():
    """upsolve_build_yd, upsolve_yd and apgd_iterate against their plain
    versions (float32, B=256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float32, B=256)
    plain = {SK.upsolve_build_yd: SK.upsolve_build_yd_reference,
             SK.upsolve_yd: SK.upsolve_yd_reference,
             SK.apgd_iterate: SK.apgd_iterate_reference}
    for fn, call in _stage_calls(tree, args):
        n0 = fn.launches
        got = call(fn)
        want = call(plain[fn])
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        # float32, other summation order: see chip_smoke.py's tolerances
        for g, w in zip(got, want):
            assert _max_rel(g, w) < 1e-3


@pytest.mark.cuda
def test_admm_kernel_matches_plain_on_card():
    """admm_iterate against its plain version (float32, B=256, 226
    rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    a = _admm_problem("cuda", torch.float32, B=256)
    n0 = AK.admm_iterate.launches
    got = AK.admm_iterate(*a.values(), **ADMM_KW)
    want = AK.admm_iterate_reference(*a.values(), **ADMM_KW)
    torch.cuda.synchronize()
    assert AK.admm_iterate.launches == n0 + 1
    # The plain version takes the kernel's roundings in the kernel's
    # order, so every env is held on its own scale, as chip_smoke.py
    # holds it: see TOL_ADMM_ENV there.
    err = (got - want).abs().amax(dim=0)
    assert bool((err <= 1e-4 * want.abs().amax(dim=0)).all())


@pytest.mark.cuda
def test_new_kernels_refuse_float64_on_card():
    """The kernels take float32 only; float64 CUDA tensors raise and
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float64)
    for fn, call in _stage_calls(tree, args):
        n0 = fn.launches
        with pytest.raises(TypeError, match="float32"):
            call(fn)
        assert fn.launches == n0
    n0 = AK.admm_iterate.launches
    with pytest.raises(TypeError, match="float32"):
        AK.admm_iterate(*_admm_problem("cuda", torch.float64).values(),
                        **ADMM_KW)
    assert AK.admm_iterate.launches == n0
