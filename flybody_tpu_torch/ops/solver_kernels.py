"""The fused dual contact solve ``solve_rows`` and its three stage
kernels: CUDA kernels and their plain PyTorch versions.

A = J M^-1 J^T = Yd^T Yd with Yd = D^{-1/2} L^{-T} J^T from the sparse
kinematic-tree LDL^T factor (ops/tree_ldl). One ``solve_rows`` call builds
J^T from the compact row form, runs the triangular up-solve, the APGD loop
with its noslip pass, and the two output tree sweeps:

    f, v, qfrc, dqacc = solve_rows(tree, d6, u6, ...)
    qacc = qacc_smooth + dqacc

The stage split of the same solve (``solver_fused.solve_fused(_stage=)``)
materializes Yd in device memory between two kernels:

    yd, b = upsolve_build_yd(tree, d6, u6, ...)     # J build + up-solve
    yd, b = upsolve_yd(tree, jt, ...)               # up-solve of a given J^T
    f, ystar, v = apgd_iterate(yd, b, rreg, ...)    # APGD + noslip, Yd f

Row layout (static): [ kl nonneg rows (limits + condim-1 contacts, padded)
| kc cone NORMAL rows | kc cone TANGENT-1 rows | kc cone TANGENT-2 rows ].

Each wrapper takes CUDA tensors to its kernel in ``csrc/solve_rows.cu``
and CPU tensors to its ``*_reference``; nothing else chooses between them.
Each wrapper's ``.launches`` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import weakref

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


def upsolve_build_yd_reference(tree, d6, u6, b1, b2, lim_sign, lim_dadr,
                               maskd, ld, dinv, qacc_smooth, qvel, kcoef,
                               bcoef, posr):
    """Plain PyTorch version of ``upsolve_build_yd``: the J build, then
    ``upsolve_yd_reference``."""
    maskd = torch.as_tensor(maskd, device=d6.device)
    jt = build_jt_reference(d6, u6, b1, b2, lim_sign, lim_dadr, maskd)
    return upsolve_yd_reference(tree, jt, ld, dinv, qacc_smooth, qvel,
                                kcoef, bcoef, posr)


def apgd_iterate_reference(yd, b, rreg, active, mu, f0, v0=None, *,
                           kl: int, kc: int, iterations: int,
                           noslip_iterations: int = 0,
                           power_iters: int = 4):
    """Plain PyTorch version of ``apgd_iterate``."""
    if v0 is None:
        v0 = active
    return _apgd_math(yd, b, rreg, active, mu, f0, v0, kl=kl, kc=kc,
                      iterations=iterations,
                      noslip_iterations=noslip_iterations,
                      power_iters=power_iters)


def solve_rows_reference(tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd,
                         ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr,
                         rreg, active, mu, f0, v0=None, *, kl: int, kc: int,
                         iterations: int, noslip_iterations: int = 0,
                         power_iters: int = 4):
    """Plain PyTorch version of ``solve_rows``: J build, up-solve, APGD,
    then ``tree_ldl.mul_lt`` and ``tree_ldl.solve_down`` for the outputs."""
    if v0 is None:
        v0 = active
    yd, bvec = upsolve_build_yd_reference(
        tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
        qacc_smooth, qvel, kcoef, bcoef, posr)
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


def upsolve_yd_work(nv: int, R: int, B: int, n_up: int,
                    build: bool) -> float:
    """Floating-point operations of one ``upsolve_build_yd`` (build=True:
    J build 15 nv R) or ``upsolve_yd`` call: rhs 4 nv R, up-solve
    2 n_up R, D^{-1/2} scaling nv R."""
    per_env = nv * R * ((15 if build else 0) + 4 + 1) + 2 * n_up * R
    return float(per_env) * B


def apgd_iterate_work(nv: int, R: int, B: int, iterations: int,
                      noslip_iterations: int, power_iters: int) -> float:
    """Floating-point operations of one ``apgd_iterate`` call: diag 2 nv R,
    one Yd^T Yd application 4 nv R per power / APGD / noslip iteration and
    the output Yd f 2 nv R."""
    napply = power_iters + iterations + 2 * noslip_iterations
    return float(nv * R * (2 + 4 * napply + 2)) * B


def random_rows_problem(B: int, seed: int = 0, nv: int = 105,
                        nbody: int = 69, kl: int = 32, kc: int = 40,
                        parent=None) -> dict:
    """Random compact-row inputs at the walk_on_ball shapes, built as the
    JAX package's tools/check_solve_rows.py builds them (numpy, seeded).
    ``parent`` (a model's dof_parentid) replaces the built-in dof tree and
    sets nv.

    Returns numpy arrays keyed by ``solve_rows`` argument name, plus
    ``parent`` (the dof tree) and ``Ms`` (a compressed SPD tree matrix,
    (nM, B)) that the caller factors into ``ld``/``dinv``."""
    rng = np.random.RandomState(seed)
    if parent is None:
        parent = np.full(nv, -1, np.int32)
        for i in range(1, nv):
            parent[i] = i - 1 if i % 7 else max(0, i - 7)
    parent = np.asarray(parent, np.int32)
    nv = len(parent)
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
# CUDA kernel wrappers
# --------------------------------------------------------------------------

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "solve_rows_launch": ([_P] * 19          # inputs (maskd as bits)
                          + [_P] * 4         # outputs f, v, qfrc, dqacc
                          + [_P]             # the packed tables
                          + [_I] * 14        # sizes and iteration counts
                          + [_P]),           # stream
    "upsolve_launch": ([_I] + [_P] * 15      # build flag, inputs
                       + [_P] * 2            # outputs yd, b
                       + [_P]                # the packed tables
                       + [_I] * 6            # sizes
                       + [_P]),              # stream
    "apgd_launch": ([_P] * 7 + [_P] * 3      # inputs, outputs f, ystar, v
                    + [_I] * 9 + [_P]),      # sizes and counts, stream
}

# The kernels' shape limits (csrc/solve_rows.cu): 256 threads per env, Yd
# held in registers as 8 warps x 14 dofs by 32 lanes x CPL columns, in two
# instances: CPL 5 takes R <= 160 rows, CPL 6 R <= 192. A launch takes the
# narrower instance that holds R. Within them shared memory stays under
# 227 kB per block (a chain of 112 dofs at 192 rows).
THREADS = 256
MAX_NV = 112
CPL_NARROW, CPL_WIDE = 5, 6
MAX_R_NARROW = 32 * CPL_NARROW
MAX_R = 32 * CPL_WIDE


def tile_cpl(R: int) -> int:
    """Columns per lane of the kernel instance that takes R rows."""
    return CPL_NARROW if R <= MAX_R_NARROW else CPL_WIDE


def _launcher(name: str):
    fn = getattr(cuda_build.load("solve_rows"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _launch(who: str, name: str, *args) -> None:
    err = _launcher(name)(*args)
    if err != 0:
        raise RuntimeError(f"{who} kernel launch failed: CUDA error {err} "
                           f"({cuda_build.error_string(err, 'solve_rows')})")


def _pack(i, e, j):
    """One int32 word per triplet: i | j << 7 | e << 14 (dofs < 128)."""
    return (np.asarray(i, np.int64) | (np.asarray(j, np.int64) << 7)
            | (np.asarray(e, np.int64) << 14)).astype(np.int32)


def pack_tables(tree) -> dict:
    """The tree tables of the kernels, as one int32 array ``tab``:

    cptr  (nv + 1) and cidx (n_up): the up-sweep triplets (i, e, j) of
          ``flat_up``, packed and grouped by j, in up-sweep order within
          a group (the up-sweep pulled into each j, and L^T x for qfrc);
    dn    the down-sweep triplets in ``flat_down`` order, packed;
    sptr  (nseg + 1): where each dof's run of dn starts (one run per dof
          with ancestors, in dn's order);
    lptr  (nlev + 1): which runs belong to each depth level.

    Also the counts n_up, n_down, nseg, nlev and n_tab = len(tab)."""
    nv = tree.nv
    if nv > MAX_NV:
        raise ValueError(f"pack_tables: nv={nv} > {MAX_NV}")
    up, dn = TL.flat_up(tree), TL.flat_down(tree)
    pu = _pack(up[:, 0], up[:, 1], up[:, 2])
    order = np.argsort(up[:, 2], kind="stable")
    cptr = np.concatenate([[0], np.cumsum(np.bincount(up[:, 2],
                                                      minlength=nv))])
    pd = _pack(dn[:, 0], dn[:, 1], dn[:, 2])
    starts = np.flatnonzero(np.r_[True, dn[1:, 0] != dn[:-1, 0]]) \
        if len(dn) else np.zeros(0, np.int64)
    sptr = np.r_[starts, len(dn)]
    level_end = np.cumsum([len(t[0]) for t in tree.solve_down])
    lptr = np.r_[0, np.searchsorted(starts, level_end)]
    tab = np.concatenate([cptr, pu[order], pd, sptr, lptr]
                         ).astype(np.int32)
    return dict(tab=tab, n_up=len(up), n_down=len(dn), nseg=len(starts),
                nlev=len(tree.solve_down), n_tab=len(tab))


def _tables(tree, device):
    """``pack_tables`` with ``tab`` on ``device`` (cached on the tree)."""
    key = ("sk_tab", str(device))
    t = tree._dev.get(key)
    if t is None:
        t = pack_tables(tree)
        t["tab"] = torch.as_tensor(t["tab"], device=device).contiguous()
        tree._dev[key] = t
    return t


def mask_bits(maskd: torch.Tensor) -> torch.Tensor:
    """(nbody, nv) 0/1 body-dof mask -> (nbody, 4) int32, bit v % 32 of
    word v // 32 set where maskd[body, v] is 1. Raises on any other value
    (the kernels take the mask as bits)."""
    nbody, nv = maskd.shape
    if nv > MAX_NV:
        raise ValueError(f"mask_bits: nv={nv} > {MAX_NV}")
    if not bool(((maskd == 0) | (maskd == 1)).all()):
        raise ValueError("maskd must hold only 0 and 1: the kernels take "
                         "the body-dof mask as bits")
    bits = torch.zeros((nbody, 128), dtype=torch.int64,
                       device=maskd.device)
    bits[:, :nv] = (maskd == 1).long()
    words = (bits.reshape(nbody, 4, 32)
             << torch.arange(32, device=maskd.device)).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32,
                       words).to(torch.int32).contiguous()


_mask_cache: dict = {}


def _mask_bits_cached(maskd: torch.Tensor) -> torch.Tensor:
    """``mask_bits`` of a model's constant mask, packed (and checked, one
    host sync) once per tensor and version."""
    hit = _mask_cache.get(id(maskd))
    if hit is not None and hit[0]() is maskd and hit[1] == maskd._version:
        return hit[2]
    bits = mask_bits(maskd)
    if len(_mask_cache) > 64:
        _mask_cache.clear()
    _mask_cache[id(maskd)] = (weakref.ref(maskd), maskd._version, bits)
    return bits


def check_args(who: str, checks, device) -> None:
    """Raise unless every (name, tensor, shape, dtype) of ``checks`` lies
    on ``device``, has that dtype and shape, and is contiguous."""
    for name, x, shape, dtype in checks:
        if x.device != device:
            raise ValueError(f"{who}: {name} on {x.device}, expected "
                             f"{device}")
        if x.dtype != dtype:
            raise TypeError(f"{who}: {name} is {x.dtype}, the kernel takes "
                            f"{dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{who}: {name} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{who}: {name} is not contiguous")


def on_cpu(who: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    tensor (the kernel runs); any other device raises."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{who}: no kernel for device {x.device}")
    return False


def smem_bytes(nv: int, R: int, nM: int, n_tab: int, n_up: int) -> int:
    """Dynamic shared memory of one block, in bytes. Mirrors the kernels'
    carve-up (``carve`` in csrc/solve_rows.cu) in the instance that takes
    R rows (32 ``tile_cpl(R)`` of them): per-warp y slots, the warp
    partials of Yd^T y and of the block sums, d6, Yd with an odd row
    stride, ld, six dof vectors, eight row vectors, the n_tab words of
    tables and the n_up up-sweep entries decoded (L[e], i * S)."""
    nwarp = THREADS // 32
    mr = 32 * tile_cpl(R)
    return 4 * (nwarp * 16 + nwarp * mr + 4 * nwarp + 6 * nv
                + nv * (R | 1) + nM + 6 * nv + 8 * mr + n_tab + 2 * n_up)


def check_shape(who: str, nv: int, R: int) -> None:
    """Raise unless the kernels take nv dofs and R rows."""
    if nv > MAX_NV or R > MAX_R:
        raise ValueError(f"{who}: nv={nv}, R={R}; the kernel takes nv <= "
                         f"{MAX_NV} and R <= {MAX_R} (Yd in registers)")


def kernel_info(kernel: str, nv: int, R: int, nM: int, tables: dict) -> dict:
    """Registers, shared memory, resident blocks per SM and local (spill)
    bytes per thread of ``kernel`` ("solve_rows", "upsolve" or
    "apgd_iterate") in the instance that takes R rows, at these shapes,
    with the tree's ``pack_tables`` (``cuda_build.kernel_info``)."""
    which = ("solve_rows", "upsolve", "apgd_iterate").index(kernel)
    n_up = tables["n_up"]
    smem = (smem_bytes(nv, R, nM, tables["n_tab"], n_up), smem_bytes(
        nv, R, nM, nv + 1 + n_up, n_up), smem_bytes(nv, R, 0, 0, 0))[which]
    if tile_cpl(R) == CPL_WIDE:
        which += 3
    return dict(cuda_build.kernel_info("solve_rows", which, THREADS, smem),
                cpl=tile_cpl(R))


def _row_checks(nv, R, B, nbody, nM, d6, u6, b1, b2, lim_sign, lim_dadr,
                maskd, ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr):
    f32, i32 = torch.float32, torch.int32
    return [("d6", d6, (nv, 6, B), f32), ("u6", u6, (R, 6, B), f32),
            ("b1", b1, (R, B), i32), ("b2", b2, (R, B), i32),
            ("lim_sign", lim_sign, (R, B), f32),
            ("lim_dadr", lim_dadr, (R, B), i32),
            ("maskd", maskd, (nbody, nv), f32), ("ld", ld, (nM, B), f32),
            ("dinv", dinv, (nv, B), f32),
            ("qacc_smooth", qacc_smooth, (nv, B), f32),
            ("qvel", qvel, (nv, B), f32), ("kcoef", kcoef, (R, B), f32),
            ("bcoef", bcoef, (R, B), f32), ("posr", posr, (R, B), f32)]


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
    if on_cpu("solve_rows", d6):
        return solve_rows_reference(
            tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
            qacc_smooth, qvel, kcoef, bcoef, posr, rreg, active, mu, f0,
            v0, kl=kl, kc=kc, iterations=iterations,
            noslip_iterations=noslip_iterations, power_iters=power_iters)
    nv = d6.shape[0]
    R, _, B = u6.shape
    nbody = maskd.shape[0]
    nM = ld.shape[0]
    if R != kl + 3 * kc:
        raise ValueError(f"solve_rows: R={R} != kl + 3 kc = {kl + 3 * kc}")
    dev = d6.device
    f32 = torch.float32
    checks = _row_checks(nv, R, B, nbody, nM, d6, u6, b1, b2, lim_sign,
                         lim_dadr, maskd, ld, dinv, qacc_smooth, qvel,
                         kcoef, bcoef, posr) + [
        ("rreg", rreg, (R, B), f32), ("active", active, (R, B), f32),
        ("mu", mu, (max(kc, 1), B), f32), ("f0", f0, (R, B), f32),
        ("v0", v0, (R, B), f32)]
    check_args("solve_rows", checks, dev)
    check_shape("solve_rows", nv, R)
    tb = _tables(tree, dev)
    smem = smem_bytes(nv, R, nM, tb["n_tab"], tb["n_up"])
    ptrs = [x.data_ptr() for _, x, _, _ in checks]
    ptrs[6] = _mask_bits_cached(maskd).data_ptr()
    f = torch.empty((R, B), dtype=f32, device=dev)
    v = torch.empty((R, B), dtype=f32, device=dev)
    qfrc = torch.empty((nv, B), dtype=f32, device=dev)
    dqacc = torch.empty((nv, B), dtype=f32, device=dev)
    _launch("solve_rows", "solve_rows_launch", *ptrs,
            f.data_ptr(), v.data_ptr(), qfrc.data_ptr(), dqacc.data_ptr(),
            tb["tab"].data_ptr(), nv, R, B, nM, kl, kc, tb["n_up"],
            tb["n_down"], tb["nseg"], tb["nlev"], iterations,
            noslip_iterations, power_iters, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    solve_rows.launches += 1
    return f, v, qfrc, dqacc


solve_rows.launches = 0


def _upsolve_launch(who, tree, build, jt, row_args, ld, dinv, qacc_smooth,
                    qvel, kcoef, bcoef, posr, nv, R, B):
    """Shared launch of upsolve_build_yd (build) and upsolve_yd: checks
    the shape, then launches (row_args' maskd goes as bits)."""
    dev = ld.device
    nM = ld.shape[0]
    check_shape(who, nv, R)
    tb = _tables(tree, dev)
    smem = smem_bytes(nv, R, nM, nv + 1 + tb["n_up"], tb["n_up"])
    if build:
        row_args = (*row_args[:6], _mask_bits_cached(row_args[6]))
    yd = torch.empty((nv, R, B), dtype=torch.float32, device=dev)
    b = torch.empty((R, B), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    _launch(who, "upsolve_launch", int(build), ptr(jt),
            *[ptr(x) for x in row_args], ld.data_ptr(), dinv.data_ptr(),
            qacc_smooth.data_ptr(), qvel.data_ptr(), kcoef.data_ptr(),
            bcoef.data_ptr(), posr.data_ptr(), yd.data_ptr(), b.data_ptr(),
            tb["tab"].data_ptr(), nv, R, B, nM, tb["n_up"], smem,
            torch.cuda.current_stream(dev).cuda_stream)
    return yd, b


def upsolve_build_yd(tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd,
                     ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr):
    """J build + triangular up-solve: (yd (nv, R, B), b (R, B)), the
    inputs and Yd of ``solve_rows`` with b = -bcoef (J qvel) - kcoef posr
    - J qacc_smooth.

    CPU tensors go to ``upsolve_build_yd_reference``. CUDA tensors launch
    the kernel (float32, contiguous) or raise."""
    if on_cpu("upsolve_build_yd", d6):
        return upsolve_build_yd_reference(
            tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
            qacc_smooth, qvel, kcoef, bcoef, posr)
    nv = d6.shape[0]
    R, _, B = u6.shape
    checks = _row_checks(nv, R, B, maskd.shape[0], ld.shape[0], d6, u6, b1,
                         b2, lim_sign, lim_dadr, maskd, ld, dinv,
                         qacc_smooth, qvel, kcoef, bcoef, posr)
    check_args("upsolve_build_yd", checks, d6.device)
    out = _upsolve_launch("upsolve_build_yd", tree, True, None,
                          (d6, u6, b1, b2, lim_sign, lim_dadr, maskd), ld,
                          dinv, qacc_smooth, qvel, kcoef, bcoef, posr, nv, R,
                          B)
    upsolve_build_yd.launches += 1
    return out


upsolve_build_yd.launches = 0


def upsolve_yd(tree, jt, ld, dinv, qacc_smooth, qvel, kcoef, bcoef, posr):
    """Triangular up-solve of a given jt (nv, R, B): (yd (nv, R, B),
    b (R, B)) with b = -bcoef (J qvel) - kcoef posr - J qacc_smooth.

    CPU tensors go to ``upsolve_yd_reference``. CUDA tensors launch the
    kernel (float32, contiguous) or raise."""
    if on_cpu("upsolve_yd", jt):
        return upsolve_yd_reference(tree, jt, ld, dinv, qacc_smooth, qvel,
                                    kcoef, bcoef, posr)
    nv, R, B = jt.shape
    f32 = torch.float32
    check_args("upsolve_yd", [
        ("jt", jt, (nv, R, B), f32), ("ld", ld, (ld.shape[0], B), f32),
        ("dinv", dinv, (nv, B), f32),
        ("qacc_smooth", qacc_smooth, (nv, B), f32),
        ("qvel", qvel, (nv, B), f32), ("kcoef", kcoef, (R, B), f32),
        ("bcoef", bcoef, (R, B), f32), ("posr", posr, (R, B), f32)],
        jt.device)
    out = _upsolve_launch("upsolve_yd", tree, False, jt, (None,) * 7, ld,
                          dinv, qacc_smooth, qvel, kcoef, bcoef, posr, nv, R,
                          B)
    upsolve_yd.launches += 1
    return out


upsolve_yd.launches = 0


def apgd_iterate(yd, b, rreg, active, mu, f0, v0=None, *, kl: int, kc: int,
                 iterations: int, noslip_iterations: int = 0,
                 power_iters: int = 4):
    """APGD + noslip on A = Yd^T Yd + diag(rreg) for a given yd (nv, R, B):
    (f (R, B), ystar = Yd f (nv, B), v (R, B)). R = kl + 3 kc; v0 warm-
    starts the power iteration (None: the active indicator).

    CPU tensors go to ``apgd_iterate_reference``. CUDA tensors launch the
    kernel (float32, contiguous) or raise."""
    nv, R, B = yd.shape
    if R != kl + 3 * kc:
        raise ValueError(f"apgd_iterate: R={R} != kl + 3 kc = "
                         f"{kl + 3 * kc}")
    if v0 is None:
        v0 = active
    if on_cpu("apgd_iterate", yd):
        return apgd_iterate_reference(
            yd, b, rreg, active, mu, f0, v0, kl=kl, kc=kc,
            iterations=iterations, noslip_iterations=noslip_iterations,
            power_iters=power_iters)
    dev = yd.device
    f32 = torch.float32
    checks = [("yd", yd, (nv, R, B), f32), ("b", b, (R, B), f32),
              ("rreg", rreg, (R, B), f32), ("active", active, (R, B), f32),
              ("mu", mu, (max(kc, 1), B), f32), ("f0", f0, (R, B), f32),
              ("v0", v0, (R, B), f32)]
    check_args("apgd_iterate", checks, dev)
    check_shape("apgd_iterate", nv, R)
    smem = smem_bytes(nv, R, 0, 0, 0)
    f = torch.empty((R, B), dtype=f32, device=dev)
    ystar = torch.empty((nv, B), dtype=f32, device=dev)
    v = torch.empty((R, B), dtype=f32, device=dev)
    _launch("apgd_iterate", "apgd_launch",
            *[x.data_ptr() for _, x, _, _ in checks],
            f.data_ptr(), ystar.data_ptr(), v.data_ptr(), nv, R, B, kl, kc,
            iterations, noslip_iterations, power_iters, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    apgd_iterate.launches += 1
    return f, ystar, v


apgd_iterate.launches = 0
