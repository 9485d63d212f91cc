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

from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.ops import tree_ldl as TL

KW = dict(kl=32, kc=40, iterations=20, noslip_iterations=3, power_iters=4)


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


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused; nothing falls back to the plain version."""
    tree, args = _problem("meta", torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        SK.solve_rows(tree, **args, **KW)


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
