"""Forward kinematics as one CUDA kernel, and its plain version.

    d = kinematics(m, d)

returns what ``physics/kinematics.py::kinematics`` does: ``d`` with the
body frames (xpos, xquat, xmat, xipos, ximat), the joints' xanchor and
xaxis, and the geom and site frames of ``d.qpos``, in the port's
batch-minor layout and with its strides: ximat, geom_xmat and site_xmat
come as the plain version's einsum leaves them, (n, 3, B, 3) in memory
seen as (n, 3, 3, B), so every stage after runs the same ops on either
path.

CPU tensors run ``physics/kinematics.py::kinematics`` itself, the plain
version, unchanged. CUDA float32 and float64 tensors launch
``csrc/kinematics.cu``: one thread per env walks the whole body tree in
index order, so one call is one launch in place of the eager version's
3,000-8,000. ``qpos`` is read through its strides (a tracking task's
reset hands over a transposed batch). Anything else (another device or
dtype, a model whose bodies do not come after their parents) raises. The
model's
static tables go to the device once per model and dtype (``tables``,
through ``Model.plan``). The kernel has no backward: code that
differentiates through the kinematics (``inverse_kinematics.py``) calls
the plain version itself.

Each call counts ``kinematics.bodies`` (nbody B, on either path;
``utils/telemetry.py``); ``kinematics.launches`` counts the launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops.solver_kernels import on_cpu
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.utils import telemetry as tm

SOURCE = "kinematics"
THREADS = 128              # csrc THREADS: one thread per env
INSTANCE = {torch.float32: 0, torch.float64: 1}
OUTPUTS = ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor", "xaxis",
           "geom_xpos", "geom_xmat", "site_xpos", "site_xmat")

# Float operations of the kernel's pieces (a multiply, an add, a division,
# a square root, a sine or a cosine counts one): a body's frame from its
# parent's (rotate 30, add 3, mult 28), a joint by type (the anchor and
# axis 63, then a hinge's angle, axis_angle and mult 35, a ball's mult 28,
# a slide's shift 7, the new position 33), the normalisation (12), the
# outputs of a body (to_mat 39, xipos 33, ximat 45) and of a geom or site
# (its position 33, to_mat 39, the product 45).
_FRAME = 61
_JOINT = {T.FREE: 0, T.BALL: 63 + 28 + 33, T.SLIDE: 63 + 7,
          T.HINGE: 63 + 35 + 33}
_NORM = 12
_BODY_OUT = 117
_PLACE = 117


def kinematics_work(nbody: int, njnt: int, ngeom: int, nsite: int, nq: int,
                    B: int, jnt_type=None) -> dict:
    """Float operations and bytes of one float32 call: {"flops",
    "bytes"}. The bytes read qpos and write every output word once (the
    tables are a few kB); the operations count each joint by ``jnt_type``
    or, without it, as a hinge (the costliest)."""
    joints = (njnt * _JOINT[T.HINGE] if jnt_type is None
              else sum(_JOINT[int(t)] for t in jnt_type))
    ops = ((nbody - 1) * (_FRAME + _NORM) + joints + nbody * _BODY_OUT
           + (ngeom + nsite) * _PLACE)
    words = nq + nbody * (3 + 4 + 9 + 3 + 9) + njnt * 6 + (ngeom + nsite) * 12
    return {"flops": float(ops) * B, "bytes": 4.0 * words * B}


def _check_order(m: Model) -> None:
    """Raises unless every body comes after its parent and each joint
    belongs to exactly one body's range: the kernel walks the bodies in
    index order and writes each joint once."""
    parent = np.asarray(m.body_parentid)
    late = np.nonzero(parent[1:] >= np.arange(1, m.nbody))[0]
    if len(late):
        i = int(late[0]) + 1
        raise ValueError(f"kinematics kernel: body {i}'s parent "
                         f"{int(parent[i])} does not come before it")
    adr, num = np.asarray(m.body_jntadr), np.asarray(m.body_jntnum)
    owned = np.concatenate([np.arange(a, a + n) for a, n in zip(adr, num)
                            if n > 0] or [np.zeros(0, np.int64)])
    if not np.array_equal(np.sort(owned), np.arange(m.njnt)):
        raise ValueError("kinematics kernel: the bodies' joint ranges do "
                         "not cover each joint once")


def tables(m: Model, dtype: torch.dtype) -> tuple:
    """(int32 table, float table in ``dtype``) on the model's device, in
    the order ``csrc/kinematics.cu``'s ``kin_launch`` reads them; the local
    rotation matrices are ``bquat.to_mat`` of the model's quaternions, as
    the plain version computes them. Built once per model and dtype."""
    def build(m):
        _check_order(m)
        ints = np.concatenate([
            np.asarray(x, dtype=np.int64).reshape(-1) for x in (
                m.body_parentid, m.body_jntadr, m.body_jntnum, m.jnt_type,
                m.jnt_qposadr, m.geom_bodyid, m.site_bodyid)])

        def mat(q):
            return bq.to_mat(q[..., None])[..., 0]

        floats = torch.cat([x.reshape(-1).to(dtype) for x in (
            m.body_pos, m.body_quat, m.body_ipos, mat(m.body_iquat),
            m.jnt_pos, m.jnt_axis, m.qpos0, m.geom_pos, mat(m.geom_quat),
            m.site_pos, mat(m.site_quat))])
        return (torch.as_tensor(ints.astype(np.int32), device=m.device),
                floats.contiguous())
    return m.plan(f"kinematics_kernel.{dtype}", build)


def _launcher():
    fn = cuda_build.load(SOURCE).kin_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p]
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] * 3
                       + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def check_qpos(m: Model, qpos: torch.Tensor) -> None:
    """Raises unless ``qpos`` is an (nq, B) float32 or float64 tensor on
    the model's device."""
    if qpos.device != m.device:
        raise ValueError(f"kinematics kernel: qpos on {qpos.device}, the "
                         f"model on {m.device}")
    if qpos.dtype not in INSTANCE:
        raise TypeError(f"kinematics kernel: qpos is {qpos.dtype}, the "
                        f"kernel takes torch.float32 or torch.float64")
    if qpos.dim() != 2 or qpos.shape[0] != m.nq:
        raise ValueError(f"kinematics kernel: qpos has shape "
                         f"{tuple(qpos.shape)}, expected ({m.nq}, B)")


# each output's entity count and components; the three products of
# bquat.matmat (an einsum in the plain version) come laid out (n, 3, B, 3)
_SHAPES = {"xpos": ("nbody", 3), "xquat": ("nbody", 4),
           "xmat": ("nbody", 3, 3), "xipos": ("nbody", 3),
           "ximat": ("nbody", 3, 3), "xanchor": ("njnt", 3),
           "xaxis": ("njnt", 3), "geom_xpos": ("ngeom", 3),
           "geom_xmat": ("ngeom", 3, 3), "site_xpos": ("nsite", 3),
           "site_xmat": ("nsite", 3, 3)}
_MATMAT = ("ximat", "geom_xmat", "site_xmat")


def outputs(m: Model, B: int, dtype: torch.dtype, device) -> dict:
    """{name: empty output} in the plain version's shapes and strides."""
    out = {}
    for k in OUTPUTS:
        count, *comp = _SHAPES[k]
        n = getattr(m, count)
        if k in _MATMAT:
            out[k] = torch.empty((n, 3, B, 3), dtype=dtype,
                                 device=device).transpose(2, 3)
        else:
            out[k] = torch.empty((n, *comp, B), dtype=dtype, device=device)
    return out


def kinematics(m: Model, d: Data) -> Data:
    """``physics/kinematics.py::kinematics`` on CPU tensors; the kernel on
    CUDA float32 and float64 tensors."""
    qpos = d.qpos
    B = qpos.shape[-1]
    tm.count("kinematics.bodies", m.nbody * B)
    if on_cpu("kinematics", qpos):
        return K.kinematics(m, d)
    check_qpos(m, qpos)
    itab, ftab = tables(m, qpos.dtype)
    out = outputs(m, B, qpos.dtype, qpos.device)
    err = _launcher()(
        INSTANCE[qpos.dtype], qpos.data_ptr(), *qpos.stride(),
        itab.data_ptr(), ftab.data_ptr(),
        (ctypes.c_void_p * len(OUTPUTS))(*[out[k].data_ptr()
                                           for k in OUTPUTS]),
        m.nbody, m.njnt, m.ngeom, m.nsite, m.nq, B,
        torch.cuda.current_stream(qpos.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"kinematics kernel launch failed: CUDA error "
                           f"{err} ({cuda_build.error_string(err, SOURCE)})")
    kinematics.launches += 1
    return d.replace(**out)


kinematics.launches = 0


def kernel_info(dtype: torch.dtype = torch.float32,
                threads: int = THREADS) -> dict:
    """Registers, shared memory, resident blocks and warps per SM and local
    (spill) bytes per thread of the instance for ``dtype``
    (``cuda_build.kernel_info``)."""
    info = cuda_build.kernel_info(SOURCE, INSTANCE[dtype], threads, 0)
    return dict(info, warps_per_sm=info["blocks_per_sm"] * threads // 32)
