"""The fused dual contact solve ``solve_rows``: a CUDA kernel and its plain
PyTorch version.

A = J M^-1 J^T = Yd^T Yd with Yd = D^{-1/2} L^{-T} J^T from the sparse
kinematic-tree LDL^T factor (ops/tree_ldl). One call builds J^T from the
compact row form, runs the triangular up-solve, the APGD loop with its
noslip pass, and the two output tree sweeps:

    f, v, qfrc, dqacc = solve_rows(tree, d6, u6, ...)
    qacc = qacc_smooth + dqacc

Row layout (static): [ kl nonneg rows (limits + condim-1 contacts, padded)
| kc cone NORMAL rows | kc cone TANGENT-1 rows | kc cone TANGENT-2 rows ].

``solve_rows`` takes CUDA tensors to the kernel in ``csrc/solve_rows.cu``
and CPU tensors to ``solve_rows_reference``; nothing else chooses between
them. ``solve_rows.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops import tree_ldl as TL


# --------------------------------------------------------------------------
# Plain PyTorch version
# --------------------------------------------------------------------------


def build_jt_reference(d6, u6, b1, b2, lim_sign, lim_dadr, maskd):
    """Dense J^T from the compact row form.

    J[r, v] = (sum_c d6[v,c] u6[r,c]) * (maskd[b2_r, v] - maskd[b1_r, v])
              + lim_sign[r] * [v == lim_dadr[r]]
    d6 (nv, 6, B); u6 (R, 6, B); b1/b2/lim_dadr (R, B) int32;
    lim_sign (R, B); maskd (nbody, nv) -> jt (nv, R, B)."""
    nbody, nv = maskd.shape
    maskd = maskd.to(d6.dtype)
    # mdiff[v, r, B] = maskd[b2[r, B], v] - maskd[b1[r, B], v]: a gather
    mdiff = (maskd.t()[:, b2.long()] - maskd.t()[:, b1.long()])
    dots = torch.einsum("vcB,rcB->vrB", d6, u6)
    iota_v = torch.arange(nv, device=d6.device)[:, None, None]
    lim = (iota_v == lim_dadr[None].long()).to(d6.dtype) * lim_sign[None]
    return dots * mdiff + lim


def upsolve_yd_reference(tree, jt, ld, dinv, qacc_smooth, qvel, kcoef,
                         bcoef, posr):
    """Yd = D^{-1/2} L^{-T} J^T and b = -bcoef (J qvel) - kcoef posr
    - J qacc_smooth."""
    velj = torch.einsum("vrB,vB->rB", jt, qvel)
    aj = torch.einsum("vrB,vB->rB", jt, qacc_smooth)
    b = -bcoef * velj - kcoef * posr - aj
    t = tree.on(jt.device)
    x = jt.clone()
    for ii, ee, jj in t["up"]:
        x.index_add_(0, jj, -ld[ee][:, None] * x[ii])
    yd = x * torch.sqrt(dinv)[:, None, :]
    return yd, b


def _rsum(x):
    """Sum over rows (dim 0), keeping it: (R, B) -> (1, B)."""
    return torch.sum(x, dim=0, keepdim=True)


def _apgd_math(yd, b, rreg, act, mu, f0, v0, *, kl, kc, iterations,
               noslip_iterations, power_iters):
    """APGD + noslip on A = Yd^T Yd + diag(rreg). yd (nv, R, B), vectors
    (R, B), mu (kc, B); v0 = warm power-iteration start. Returns
    (f (R, B), ystar = Yd f (nv, B), v (R, B))."""
    n0, n1, n2 = kl, kl + kc, kl + 2 * kc

    def mv_y(f):                     # Yd f -> (nv, B)
        return torch.einsum("vrB,rB->vB", yd, f)

    def mv_a(f):                     # Yd^T Yd f -> (R, B)
        return torch.einsum("vrB,vB->rB", yd, mv_y(f))

    diag_a = torch.sum(yd * yd, dim=0)               # (R, B)
    # cone-uniform Jacobi scaling (normal row's diag across the cone)
    dn = diag_a[n0:n1] + rreg[n0:n1]
    dcone = torch.cat([diag_a[:kl] + rreg[:kl], dn, dn, dn], dim=0)
    s = 1.0 / torch.sqrt(torch.clamp(dcone, min=1e-12))
    bs = s * b
    s2r = s * s * rreg

    def mv_as(z):
        return s * mv_a(s * z) + s2r * z

    def proj(z, tangent_only=False, fn_frozen=None):
        head = z[:kl] if tangent_only else torch.clamp(z[:kl], min=0.0)
        fn = fn_frozen if tangent_only else z[n0:n1]
        t1 = z[n1:n2]
        t2 = z[n2:]
        t = torch.sqrt(t1 * t1 + t2 * t2) + 1e-20
        if tangent_only:
            cap = torch.clamp(mu * fn, min=0.0)
            sc = torch.clamp(cap / t, max=1.0)
            fn_new = fn
        else:
            inside = t <= mu * fn
            zero = mu * t <= -fn
            fn_m = (fn + mu * t) / (1.0 + mu * mu)
            fn_new = torch.where(inside, fn,
                                 torch.where(zero, torch.zeros_like(fn),
                                             fn_m))
            sc = torch.where(inside, torch.ones_like(fn),
                             torch.where(zero, torch.zeros_like(fn),
                                         mu * fn_m / t))
        return torch.cat([head, fn_new, t1 * sc, t2 * sc], dim=0) * act

    # Lipschitz of As over active rows: power iteration warm-started from
    # the previous substep's eigenvector, blended with the active
    # indicator so every active row's mode is in the start vector
    nrm0 = torch.sqrt(_rsum(v0 * v0)) + 1e-30
    v = (v0 / nrm0 + act / torch.sqrt(
        torch.clamp(_rsum(act), min=1.0))) * act
    L = torch.ones_like(b[:1])
    for _ in range(power_iters):
        nrm = torch.sqrt(_rsum(v * v)) + 1e-30
        v = mv_as(v / nrm) * act
        L = torch.sqrt(_rsum(v * v)) + 1e-30
    inv_l = 1.0 / torch.clamp(1.5 * L, min=1.0)
    v_out = v / torch.sqrt(_rsum(v * v) + 1e-30)

    z = proj(f0 / torch.clamp(s, min=1e-30))
    zp = z
    kk = torch.zeros_like(b[:1])
    for _ in range(iterations):
        beta = kk / (kk + 3.0)
        y = z + beta * (z - zp)
        g = mv_as(y) - bs
        z_new = proj(y - inv_l * g)
        restart = _rsum(g * (z_new - z)) > 0
        kk = torch.where(restart, torch.zeros_like(kk), kk + 1.0)
        zp, z = z, z_new

    # noslip: tangentials with R = 0, normals frozen
    if noslip_iterations > 0 and kc > 0:
        fn_frozen = z[n0:n1]
        pns = 1.0 / torch.clamp(dcone * s * s, min=1e-30)
        for _ in range(2 * noslip_iterations):
            g = s * mv_a(s * z) - bs                  # no R
            step = z - inv_l * pns * g
            step = torch.cat([z[:kl], fn_frozen, step[n1:]], dim=0)
            z = proj(step, tangent_only=True, fn_frozen=fn_frozen)

    f = s * z
    return f, mv_y(f), v_out


def solve_rows_reference(tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd,
                         ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr,
                         rreg, active, mu, f0, v0=None, *, kl: int, kc: int,
                         iterations: int, noslip_iterations: int = 0,
                         power_iters: int = 4):
    """Plain PyTorch version of ``solve_rows``: J build, up-solve, APGD,
    then ``tree_ldl.mul_lt`` and ``tree_ldl.solve_down`` for the outputs."""
    if v0 is None:
        v0 = active
    maskd = torch.as_tensor(maskd, device=d6.device)
    jt = build_jt_reference(d6, u6, b1, b2, lim_sign, lim_dadr, maskd)
    yd, bvec = upsolve_yd_reference(tree, jt, ld, dinv, qacc_smooth, qvel,
                                    kcoef, bcoef, posr)
    f, ystar, v = _apgd_math(yd, bvec, rreg, active, mu, f0, v0,
                             kl=kl, kc=kc, iterations=iterations,
                             noslip_iterations=noslip_iterations,
                             power_iters=power_iters)
    sqrt_d = 1.0 / torch.sqrt(torch.clamp(dinv, min=1e-30))
    qfrc = TL.mul_lt(tree, ld, ystar * sqrt_d)
    dqacc = TL.solve_down(tree, ld, ystar * torch.sqrt(dinv))
    return f, v, qfrc, dqacc


def solve_rows_work(nv: int, R: int, B: int, n_up: int, n_down: int,
                    iterations: int, noslip_iterations: int,
                    power_iters: int) -> float:
    """Floating-point operations of one ``solve_rows`` call (the loop
    counts are fixed, so this is exact for any data): J build 15 nv R,
    rhs 4 nv R, up-solve 2 n_up R, D^{-1/2} scaling + diag 3 nv R, one
    Yd^T Yd application 4 nv R per power / APGD / noslip iteration, the
    final Yd f 2 nv R and the two output sweeps 2 (n_up + n_down)."""
    napply = power_iters + iterations + 2 * noslip_iterations
    per_env = (nv * R * (15 + 4 + 3 + 2 + 4 * napply) + 2 * n_up * R
               + 2 * (n_up + n_down))
    return float(per_env) * B


def random_rows_problem(B: int, seed: int = 0, nv: int = 105,
                        nbody: int = 69, kl: int = 32, kc: int = 40) -> dict:
    """Random compact-row inputs at the walk_on_ball shapes, built as the
    JAX package's tools/check_solve_rows.py builds them (numpy, seeded).

    Returns numpy arrays keyed by ``solve_rows`` argument name, plus
    ``parent`` (the dof tree) and ``Ms`` (a compressed SPD tree matrix,
    (nM, B)) that the caller factors into ``ld``/``dinv``."""
    rng = np.random.RandomState(seed)
    parent = np.full(nv, -1, np.int32)
    for i in range(1, nv):
        parent[i] = i - 1 if i % 7 else max(0, i - 7)
    tree = TL.build_tree_meta(parent)
    R = kl + 3 * kc
    M = np.eye(nv) * 3.0
    for i in range(nv):
        j = parent[i]
        if j >= 0:
            M[i, j] = M[j, i] = 0.4
    Ms = np.broadcast_to(M[tree.entry_i, tree.entry_j][:, None],
                         (tree.nM, B)).copy()
    maskd = (rng.rand(nbody, nv) < 0.25).astype(np.float64)
    rn = lambda *s: rng.randn(*s)
    out = dict(parent=parent, Ms=Ms, maskd=maskd)
    out["d6"] = rn(nv, 6, B)
    out["u6"] = rn(R, 6, B)
    out["b1"] = rng.randint(0, nbody, (R, B)).astype(np.int32)
    out["b2"] = rng.randint(0, nbody, (R, B)).astype(np.int32)
    out["lim_sign"] = rn(R, B) * (np.arange(R)[:, None] < 24)
    out["lim_dadr"] = np.where(np.arange(R)[:, None] < 24,
                               rng.randint(0, nv, (R, B)), -1
                               ).astype(np.int32)
    out["qacc_smooth"] = rn(nv, B)
    out["qvel"] = rn(nv, B)
    out["kcoef"] = np.abs(rn(R, B))
    out["bcoef"] = np.abs(rn(R, B))
    out["posr"] = rn(R, B)
    out["rreg"] = np.abs(rn(R, B)) * 0.1 + 0.01
    act = (rng.rand(R, B) > 0.4).astype(np.float64)
    out["active"] = np.where(np.arange(R)[:, None] % 9 == 0, 0.0, act)
    out["mu"] = np.abs(rn(kc, B)) * 0.5 + 0.3
    out["f0"] = np.zeros((R, B))
    out["v0"] = out["active"].copy()
    return out


# --------------------------------------------------------------------------
# CUDA kernel wrapper
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCHER_ARGS = ([_P] * 19          # inputs
                  + [_P] * 4         # outputs f, v, qfrc, dqacc
                  + [_P, _P]         # up / down triplet tables
                  + [_I] * 13        # sizes and iteration counts
                  + [_P])            # stream


def _lib():
    lib = cuda_build.load("solve_rows")
    fn = lib.solve_rows_launch
    if fn.argtypes is None:
        fn.argtypes = _LAUNCHER_ARGS
        fn.restype = ctypes.c_int
    return fn


def _triplets(tree, device):
    """Up/down triplet tables (n, 3) int32 on ``device`` (cached)."""
    key = ("sk_trip", str(device))
    t = tree._dev.get(key)
    if t is None:
        t = (torch.as_tensor(TL.flat_up(tree), device=device).contiguous(),
             torch.as_tensor(TL.flat_down(tree), device=device).contiguous())
        tree._dev[key] = t
    return t


def _check(name, x, shape, dtype, device):
    if x.device != device:
        raise ValueError(f"solve_rows: {name} on {x.device}, expected "
                         f"{device}")
    if x.dtype != dtype:
        raise TypeError(f"solve_rows: {name} is {x.dtype}, the kernel "
                        f"takes {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"solve_rows: {name} has shape {tuple(x.shape)}, "
                         f"expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"solve_rows: {name} is not contiguous")


def smem_bytes(nv: int, R: int, nM: int, threads: int) -> int:
    """Dynamic shared memory of one block, in bytes. Mirrors the kernel's
    carve-up: Yd with an odd row stride, ld, d6 (6 nv), four dof vectors,
    three row vectors and the reduction scratch."""
    stride = R | 1
    return 4 * (nv * stride + nM + 10 * nv + 3 * threads + 64)


def block_threads(nv: int, R: int) -> int:
    return -(-max(nv, R) // 32) * 32


def solve_rows(tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd,
               ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr,
               rreg, active, mu, f0, v0=None, *, kl: int, kc: int,
               iterations: int, noslip_iterations: int = 0,
               power_iters: int = 4):
    """One-call dual solve: (f (R, B), v (R, B), qfrc (nv, B),
    dqacc (nv, B)) with qacc = qacc_smooth + dqacc.

    CPU tensors go to ``solve_rows_reference``. CUDA tensors launch the
    kernel (float32, contiguous, batch-minor as given) or raise."""
    if v0 is None:
        v0 = active
    if d6.device.type == "cpu":
        return solve_rows_reference(
            tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
            qacc_smooth, qvel, kcoef, bcoef, posr, rreg, active, mu, f0,
            v0, kl=kl, kc=kc, iterations=iterations,
            noslip_iterations=noslip_iterations, power_iters=power_iters)
    if d6.device.type != "cuda":
        raise ValueError(f"solve_rows: no kernel for device {d6.device}")

    nv = d6.shape[0]
    R, _, B = u6.shape
    nbody = maskd.shape[0]
    nM = ld.shape[0]
    if R != kl + 3 * kc:
        raise ValueError(f"solve_rows: R={R} != kl + 3 kc = {kl + 3 * kc}")
    dev = d6.device
    f32, i32 = torch.float32, torch.int32
    checks = (
        ("d6", d6, (nv, 6, B), f32), ("u6", u6, (R, 6, B), f32),
        ("b1", b1, (R, B), i32), ("b2", b2, (R, B), i32),
        ("lim_sign", lim_sign, (R, B), f32),
        ("lim_dadr", lim_dadr, (R, B), i32),
        ("maskd", maskd, (nbody, nv), f32), ("ld", ld, (nM, B), f32),
        ("dinv", dinv, (nv, B), f32), ("qacc_smooth", qacc_smooth, (nv, B),
                                       f32),
        ("qvel", qvel, (nv, B), f32), ("kcoef", kcoef, (R, B), f32),
        ("bcoef", bcoef, (R, B), f32), ("posr", posr, (R, B), f32),
        ("rreg", rreg, (R, B), f32), ("active", active, (R, B), f32),
        ("mu", mu, (max(kc, 1), B), f32), ("f0", f0, (R, B), f32),
        ("v0", v0, (R, B), f32),
    )
    for name, x, shape, dtype in checks:
        _check(name, x, shape, dtype, dev)
    up, down = _triplets(tree, dev)
    threads = block_threads(nv, R)
    smem = smem_bytes(nv, R, nM, threads)
    f = torch.empty((R, B), dtype=f32, device=dev)
    v = torch.empty((R, B), dtype=f32, device=dev)
    qfrc = torch.empty((nv, B), dtype=f32, device=dev)
    dqacc = torch.empty((nv, B), dtype=f32, device=dev)
    ins = [x for _, x, _, _ in checks]
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(*[x.data_ptr() for x in ins],
                 f.data_ptr(), v.data_ptr(), qfrc.data_ptr(),
                 dqacc.data_ptr(), up.data_ptr(), down.data_ptr(),
                 nv, R, B, nbody, nM, kl, kc, up.shape[0], down.shape[0],
                 iterations, noslip_iterations, power_iters, smem, stream)
    if err != 0:
        raise RuntimeError(f"solve_rows kernel launch failed: CUDA error "
                           f"{err} ({cuda_build.error_string(err)})")
    solve_rows.launches += 1
    return f, v, qfrc, dqacc


solve_rows.launches = 0
