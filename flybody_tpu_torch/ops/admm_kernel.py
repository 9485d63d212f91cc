"""Over-relaxed ADMM iterations of the dense-dual solver: a CUDA kernel and
its plain PyTorch version.

The dense ADMM solver (physics/solver_dense.py) iterates

    f = W (b + rho (z - u));  fr = alpha f + (1-alpha) z
    z = proj_K(fr + u);       u = u + fr - z

with W = (A_scaled + rho I)^-1 per env. The kernel
(``csrc/admm_iterate.cu``) keeps one env's W in shared memory for all
iterations, so W is read from device memory once per substep instead of
once per iteration. W is carried in bfloat16 and so is each iteration's
rhs (round to nearest even); products are summed in float32 (iterates stay
float32). The plain version rounds at the same two places and sums in the
kernel's order, and the kernel rounds every other step as the plain
version's separate PyTorch ops do (no fused multiply-adds outside the
matvec), so on float32 inputs the two agree bit for bit unless the card
rounds an operation otherwise.

Layout: batch-minor (rows, rows, B) like the rest of the engine. The
feasible set is [kl nonneg rows | kc elliptic cones, each three
interleaved rows (fn, ft1, ft2)]; rows past kl + 3 kc are not projected.
All rows are multiplied by the active mask.

``admm_iterate`` takes CUDA tensors to the kernel and CPU tensors to
``admm_iterate_reference``; ``admm_iterate.launches`` counts kernel
launches.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops.solver_kernels import check_args, on_cpu


def project(z, active, mu, kl: int, kc: int):
    """proj_K of z (rows, B): nonneg head, interleaved elliptic cones,
    the rest passed through; times active. mu (kc, B)."""
    B = z.shape[-1]
    lim = torch.clamp(z[:kl], min=0.0)
    zc = z[kl:kl + 3 * kc].reshape(kc, 3, B)
    fn, ft1, ft2 = zc[:, 0], zc[:, 1], zc[:, 2]
    t = torch.sqrt(ft1 * ft1 + ft2 * ft2) + 1e-20
    inside = t <= mu * fn
    zero = mu * t <= -fn
    fn_m = (fn + mu * t) / (1.0 + mu * mu)
    one, nil = torch.ones_like(fn), torch.zeros_like(fn)
    sc = torch.where(inside, one, torch.where(zero, nil, mu * fn_m / t))
    fn_new = torch.where(inside, fn, torch.where(zero, nil, fn_m))
    cones = torch.stack([fn_new, ft1 * sc, ft2 * sc],
                        dim=1).reshape(3 * kc, B)
    return torch.cat([lim, cones, z[kl + 3 * kc:]], dim=0) * active


def admm_iterate_reference(W, b, z0, mu, active, *, kl: int, kc: int,
                           iterations: int = 20, rho: float = 10.0,
                           alpha: float = 1.9):
    """Plain PyTorch version of ``admm_iterate``: the same bf16 W and rhs,
    and the products summed in float32 in the kernel's order, s = 0, 1,
    ..., rows - 1. A product of two bf16 values is exact in float32, so
    each step rounds once, as the kernel's fmaf does: on float32 inputs
    the two take the same roundings in the same order. A bf16 rhs entry
    is one rounding boundary away from another value 2^-8 off, so any
    other order of the sums moves z by up to ~1e-2 of its scale after 20
    iterations on stiff states."""
    f32 = torch.float32
    Wb = W.to(torch.bfloat16).to(f32)
    z = project(z0, active, mu, kl, kc)
    u = torch.zeros_like(z)
    for _ in range(iterations):
        rhs = (b + rho * (z - u)).to(torch.bfloat16).to(f32)
        f = torch.zeros_like(rhs)
        for s in range(rhs.shape[0]):
            f.addcmul_(Wb[:, s], rhs[s])
        fr = alpha * f.to(z.dtype) + (1.0 - alpha) * z
        z_new = project(fr + u, active, mu, kl, kc)
        u = u + fr - z_new
        z = z_new
    return z


def admm_work(rows: int, B: int, iterations: int) -> float:
    """Floating-point operations of one ``admm_iterate`` call: the W rhs
    product, 2 rows^2 per iteration (the elementwise updates and the
    projection, ~20 rows per iteration, are left out)."""
    return float(2 * rows * rows * iterations) * B


def word_stride(rows: int) -> int:
    """32-bit words between two rows of W (bf16) in shared memory: at
    least ceil(rows / 2), odd so that a warp's 32 rows hit 32 banks."""
    return ((rows + 1) // 2) | 1


def smem_bytes(rows: int) -> int:
    """Dynamic shared memory of one block: W, then the rhs and the
    projection's row vector."""
    return 4 * (rows * word_stride(rows) + 2 * rows)


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _launcher():
    fn = cuda_build.load("admm_iterate").admm_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 6 + [_I] * 5 + [_F] * 3 + [_I] * 2 + [_P])
        fn.restype = ctypes.c_int
    return fn


def admm_iterate(W, b, z0, mu, active, *, kl: int, kc: int,
                 iterations: int = 20, rho: float = 10.0,
                 alpha: float = 1.9):
    """Run the ADMM iterations: W (rows, rows, B) scaled-space inverse
    operator, b/z0/active (rows, B), mu (kc, B); rows >= kl + 3 kc, row
    layout [kl limit rows | 3 kc interleaved cone rows | rest]. Returns
    z (rows, B).

    CPU tensors go to ``admm_iterate_reference``. CUDA tensors launch the
    kernel (float32 inputs; W in any strides, cast once to an env-major
    bf16 copy) or raise."""
    rows, _, B = W.shape
    if kl + 3 * kc > rows:
        raise ValueError(f"admm_iterate: kl + 3 kc = {kl + 3 * kc} > rows "
                         f"= {rows}")
    if on_cpu("admm_iterate", W):
        return admm_iterate_reference(W, b, z0, mu, active, kl=kl, kc=kc,
                                      iterations=iterations, rho=rho,
                                      alpha=alpha)
    dev = W.device
    f32 = torch.float32
    if W.dtype != f32:
        raise TypeError(f"admm_iterate: W is {W.dtype}, the kernel takes "
                        f"{f32}")
    check_args("admm_iterate", [
        ("b", b, (rows, B), f32), ("z0", z0, (rows, B), f32),
        ("mu", mu, (max(kc, 1), B), f32),
        ("active", active, (rows, B), f32)], dev)
    if rows > 1024:
        raise ValueError(f"admm_iterate: rows={rows}, the kernel takes at "
                         "most 1024 (one thread per row)")
    smem = smem_bytes(rows)
    Wb = W.permute(2, 0, 1).to(torch.bfloat16).contiguous()   # (B, rows, rows)
    z = torch.empty((rows, B), dtype=f32, device=dev)
    err = _launcher()(Wb.data_ptr(), b.data_ptr(), z0.data_ptr(),
                      mu.data_ptr(), active.data_ptr(), z.data_ptr(), rows,
                      B, kl, kc, iterations, float(rho), float(alpha),
                      1.0 - float(alpha), word_stride(rows), smem,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = cuda_build.error_string(err, "admm_iterate")
        raise RuntimeError(f"admm_iterate kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    admm_iterate.launches += 1
    return z


admm_iterate.launches = 0
