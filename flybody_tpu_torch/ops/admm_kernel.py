"""Over-relaxed ADMM iterations of the dense-dual solver: a CUDA kernel and
its plain PyTorch version.

The dense ADMM solver (physics/solver_dense.py) iterates

    f = W (b + rho (z - u));  fr = alpha f + (1-alpha) z
    z = proj_K(fr + u);       u = u + fr - z

with W = (A_scaled + rho I)^-1 per env. The kernel
(``csrc/admm_iterate.cu``) reads one env's float32 W in place, rounds it
to bf16 and keeps it in shared memory for all iterations, so W is read
from device memory once per substep instead of once per iteration. W is
carried in bfloat16 and so is each iteration's rhs (round to nearest
even); products are summed in float32 (iterates stay float32). The plain
version rounds at the same two places and sums in the kernel's order, and
the kernel rounds every other step as the plain version's separate
PyTorch ops do (no fused multiply-adds outside the matvec), so on float32
inputs the two agree bit for bit unless the card rounds an operation
otherwise.

Layout: W is (rows, rows, B) like the rest of the engine, and the kernel
takes it as ``solver_dense.inverse_operator`` returns it, a view whose
``permute(2, 0, 1)`` is contiguous (``check_w_layout``). The
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
    and the products summed in float32 in the kernel's order: product s
    into accumulator s % 4, s = 0, 1, ..., rows - 1, then
    f = (a0 + a1) + (a2 + a3). A product of two bf16 values is exact in
    float32, so each step rounds once, as the kernel's fmaf does: on
    float32 inputs the two take the same roundings in the same order. A
    bf16 rhs entry is one rounding boundary away from another value 2^-8
    off, so any other order of the sums moves z by up to ~1e-2 of its
    scale after 20 iterations on stiff states."""
    f32 = torch.float32
    Wb = W.to(torch.bfloat16).to(f32)
    z = project(z0, active, mu, kl, kc)
    u = torch.zeros_like(z)
    for _ in range(iterations):
        rhs = (b + rho * (z - u)).to(torch.bfloat16).to(f32)
        acc = torch.zeros((4,) + rhs.shape, dtype=f32, device=rhs.device)
        for s in range(rhs.shape[0]):
            acc[s % 4].addcmul_(Wb[:, s], rhs[s])
        f = (acc[0] + acc[1]) + (acc[2] + acc[3])
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


MAX_ROWS = 256   # one thread per row, 256 threads (solver_dense's limit too)


def chunk_stride(rows: int) -> int:
    """16-byte chunks (8 bf16) between two rows of W in shared memory: at
    least ceil(rows / 8), odd so that 8 threads' 16-byte loads, one row
    each, hit 8 different chunk columns."""
    return ((rows + 7) // 8) | 1


def smem_bytes(rows: int) -> int:
    """Dynamic shared memory of one block: W in bf16, then the rhs (a
    whole number of chunks) and the projection's row vector."""
    cw = chunk_stride(rows)
    return 16 * rows * cw + 4 * (8 * cw + rows)


def check_w_layout(W: torch.Tensor) -> None:
    """Raise unless W (rows, rows, B) is laid out as
    ``solver_dense.inverse_operator`` gives it: W.permute(2, 0, 1)
    contiguous, each env's rows x rows block in one piece (the kernel
    reads it in place and makes no copy)."""
    if W.dim() != 3 or W.shape[0] != W.shape[1]:
        raise ValueError(f"admm_iterate: W has shape {tuple(W.shape)}, "
                         "expected (rows, rows, B)")
    if not W.permute(2, 0, 1).is_contiguous():
        raise ValueError(f"admm_iterate: W has strides {W.stride()}; the "
                         "kernel takes the env-major layout of "
                         "solver_dense.inverse_operator (W.permute(2, 0, 1) "
                         "contiguous)")


def kernel_info(rows: int) -> dict:
    """Registers, shared memory and resident blocks per SM of the kernel
    at ``rows`` rows (``cuda_build.kernel_info``)."""
    return cuda_build.kernel_info("admm_iterate", 0, -(-rows // 32) * 32,
                                  smem_bytes(rows))


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _launcher():
    fn = cuda_build.load("admm_iterate").admm_launch
    if fn.argtypes is None:
        fn.argtypes = ([_P] * 6 + [_I] * 5 + [_F] * 3 + [_I] * 3 + [_P])
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
    kernel (float32; W in the layout of ``solver_dense.inverse_operator``,
    read in place and rounded to bf16 by the kernel, see
    ``check_w_layout``) or raise."""
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
    check_w_layout(W)
    check_args("admm_iterate", [
        ("b", b, (rows, B), f32), ("z0", z0, (rows, B), f32),
        ("mu", mu, (max(kc, 1), B), f32),
        ("active", active, (rows, B), f32)], dev)
    if rows > MAX_ROWS:   # then W takes at most 137 kB of shared memory
        raise ValueError(f"admm_iterate: rows={rows}; the kernel takes at "
                         f"most {MAX_ROWS} rows (one thread per row)")
    smem = smem_bytes(rows)
    vec = int(rows % 2 == 0 and W.data_ptr() % 16 == 0)
    z = torch.empty((rows, B), dtype=f32, device=dev)
    err = _launcher()(W.data_ptr(), b.data_ptr(), z0.data_ptr(),
                      mu.data_ptr(), active.data_ptr(), z.data_ptr(), rows,
                      B, kl, kc, iterations, float(rho), float(alpha),
                      1.0 - float(alpha), chunk_stride(rows), vec, smem,
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = cuda_build.error_string(err, "admm_iterate")
        raise RuntimeError(f"admm_iterate kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    admm_iterate.launches += 1
    return z


admm_iterate.launches = 0
