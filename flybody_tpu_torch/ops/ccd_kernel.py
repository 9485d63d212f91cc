"""The exact convex narrowphase as one CUDA kernel, and its plain version.

    dist, pos, u[, nu] = narrowphase(p1, R1, param1, p2, R2, param2,
                                     iters, refine, u0, with_nu)

takes and returns what ``physics/ccd.py::narrowphase`` does, in the same
batch-minor layout: p (N, 3, B), R (N, 3, 3, B), param = (ell (N, 3, B|1),
seg (N, 1, B|1), radius (N, 1, B|1), axis_flat) per geom, u0 (N, 3, B) or
None; dist (N, B), pos and u (N, 3, B), nu (N, B).

CPU tensors run ``physics/ccd.py::narrowphase`` itself, the plain version,
unchanged. CUDA float32 tensors launch ``csrc/ccd_narrowphase.cu``: one
thread per (lane, env) runs the lane's whole support minimisation, witness
refinement and manifold multiplicity in registers, so one call is one
launch in place of the eager version's ~2,000. The inputs are read through
their strides (the collision stage's views need no copy); anything else
(another device, float64 on the card, a wrong shape) raises.

Each call runs in the span ``physics.ccd`` and counts ``ccd.lanes`` (N B)
(``utils/telemetry.py``); ``narrowphase.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import torch

from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops.solver_kernels import on_cpu
from flybody_tpu_torch.physics import ccd
from flybody_tpu_torch.utils import telemetry as tm

SOURCE = "ccd_narrowphase"
THREADS = 128              # csrc THREADS: one thread per env, a lane a row
NAMES = ("p1", "R1", "ell1", "seg1", "r1", "p2", "R2", "ell2", "seg2", "r2",
         "u0")

# Float operations per thread of the kernel's pieces (a multiply, an add,
# a division or a square root counts one; compares and selects none):
# sup = two supports (R^T u, the ellipsoid-segment core, R s + p) and f;
# a PGD run is (fixed, per iteration), free and on a great circle; the
# Newton polish is two steps (tangent frame, two Hessian quadratics, the
# 2x2 solve, one sup); refine the two support sets and 6 x 2 clamps.
_SUP = 120
_PGD = {False: (431, 169), True: (486, 191)}
_CROSS_POLES = 259
_NEWTON = 848
_SETUP = 23
_REFINE = 354
_OUT = 20
_NU = 25
_WORDS = 2 * (3 + 9 + 3 + 1 + 1) + 3 + (1 + 3 + 3 + 1)


def narrowphase_work(N: int, B: int, iters: int, ax1: bool, ax2: bool,
                     refine: bool = True, with_nu: bool = True) -> dict:
    """Float operations and bytes of one call: {"flops", "bytes"}; the
    bytes read each input word and write each output word once (a warm
    start included)."""
    fixed, per = _PGD[False]
    ops = _SETUP + fixed + per * iters + _NEWTON + _OUT
    for flat in (ax1, ax2):
        if flat:
            fixed, per = _PGD[True]
            ops += fixed + per * iters + 2 * _SUP
    if ax1 and ax2:
        ops += _CROSS_POLES
    ops += _REFINE * bool(refine) + _NU * bool(with_nu)
    return {"flops": float(ops) * N * B, "bytes": 4.0 * _WORDS * N * B}


def _launcher():
    fn = cuda_build.load(SOURCE).ccd_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _strides(x: torch.Tensor) -> list:
    """(lane, i, j, env) element strides of a (N, k, B) or (N, 3, 3, B)
    tensor."""
    s = list(x.stride())
    return s if x.dim() == 4 else [s[0], s[1], 0, s[2]]


def check_inputs(p1, R1, param1, p2, R2, param2, u0) -> list:
    """The kernel's inputs in ``NAMES`` order, a param whose env dimension
    is 1 broadcast over B; raises unless each is float32 on p1's device
    at its shape, and every offset fits the kernel's 32-bit indices."""
    if p1.dim() != 3:
        raise ValueError(f"ccd narrowphase: p1 has shape {tuple(p1.shape)}, "
                         f"expected (N, 3, B)")
    N, _, B = p1.shape
    shapes = ((N, 3, B), (N, 3, 3, B), (N, 3, B), (N, 1, B), (N, 1, B))
    xs = [p1, R1, *param1[:3], p2, R2, *param2[:3]]
    full = list(shapes) * 2
    if u0 is not None:
        xs.append(u0)
        full.append((N, 3, B))
    for k, (x, shape) in enumerate(zip(xs, full)):
        if (x.dim() == len(shape) and x.shape[-1] == 1 and B != 1
                and tuple(x.shape[:-1]) == shape[:-1]):
            xs[k] = x.expand(shape)
    # solve_rows' checks (solver_kernels.check_args) but for contiguity:
    # the kernel reads every input through its strides
    for k, (x, shape) in enumerate(zip(xs, full)):
        if x.device != p1.device:
            raise ValueError(f"ccd narrowphase: {NAMES[k]} on {x.device}, "
                             f"expected {p1.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"ccd narrowphase: {NAMES[k]} is {x.dtype}, "
                            f"the kernel takes torch.float32")
        if tuple(x.shape) != shape:
            raise ValueError(f"ccd narrowphase: {NAMES[k]} has shape "
                             f"{tuple(x.shape)}, expected {shape}")
        if sum((n - 1) * s for n, s in zip(x.shape, x.stride())) >= 2 ** 31:
            raise ValueError(f"ccd narrowphase: {NAMES[k]} spans more than "
                             f"2^31 elements")
    return xs


@tm.spanned("physics.ccd")
def narrowphase(p1, R1, param1, p2, R2, param2, iters: int = 32,
                refine: bool = True, u0=None, with_nu: bool = False):
    """``physics/ccd.py::narrowphase`` on CPU tensors; the kernel on CUDA
    float32 tensors. Returns (dist, pos, u) and with ``with_nu`` also nu."""
    tm.count("ccd.lanes", p1.numel() // 3)
    if on_cpu("ccd narrowphase", p1):
        return ccd.narrowphase(p1, R1, param1, p2, R2, param2, iters=iters,
                               refine=refine, u0=u0, with_nu=with_nu)
    xs = check_inputs(p1, R1, param1, p2, R2, param2, u0)
    N, _, B = p1.shape
    dev = p1.device
    out = [torch.empty((N, B), dtype=torch.float32, device=dev),
           torch.empty((N, 3, B), dtype=torch.float32, device=dev),
           torch.empty((N, 3, B), dtype=torch.float32, device=dev)]
    if with_nu:
        out.append(torch.empty((N, B), dtype=torch.float32, device=dev))
    ptrs = [x.data_ptr() for x in xs] + [None] * (len(NAMES) - len(xs))
    strides = [s for x in xs for s in _strides(x)]
    strides += [0] * (4 * len(NAMES) - len(strides))
    outs = [o.data_ptr() for o in out] + [None] * (4 - len(out))
    err = _launcher()(
        (ctypes.c_void_p * len(NAMES))(*ptrs),
        (ctypes.c_int * len(strides))(*strides),
        (ctypes.c_void_p * 4)(*outs), N, B, int(iters), int(bool(param1[3])),
        int(bool(param2[3])), int(bool(refine)),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ccd narrowphase kernel launch failed: CUDA "
                           f"error {err} "
                           f"({cuda_build.error_string(err, SOURCE)})")
    narrowphase.launches += 1
    return tuple(out)


narrowphase.launches = 0


def kernel_info(ax1: bool, ax2: bool, threads: int = THREADS) -> dict:
    """Registers, shared memory, resident blocks and warps per SM and local
    (spill) bytes per thread of the instance for the flags (ax1, ax2)
    (``cuda_build.kernel_info``)."""
    info = cuda_build.kernel_info(SOURCE, 2 * bool(ax1) + bool(ax2),
                                  threads, 0)
    return dict(info, warps_per_sm=info["blocks_per_sm"] * threads // 32)
