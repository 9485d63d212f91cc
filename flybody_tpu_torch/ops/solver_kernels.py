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


def upsolve_dense_factor(tree, ld, dinv):
    """U = L^T D^{1/2}, dense, upper triangular and env-major (B, nv, nv),
    so that Yd = U^{-1} J^T: one batched ``torch.linalg.solve_triangular(
    U, jt.permute(2, 0, 1), upper=True)`` gives ``upsolve_yd``'s Yd (not
    its b). chip_smoke.py times that call as the library yardstick of
    ``upsolve_yd``; the port solves with the tree sweeps instead."""
    nv, B = dinv.shape
    off = np.flatnonzero(tree.entry_i != tree.entry_j)
    ei = torch.as_tensor(tree.entry_i[off], device=ld.device)
    ej = torch.as_tensor(tree.entry_j[off], device=ld.device)
    sd = torch.rsqrt(dinv)                           # D^{1/2}, (nv, B)
    u = ld.new_zeros((B, nv, nv))
    u[:, ej, ei] = (ld[torch.as_tensor(off, device=ld.device)]
                    * sd[ei]).t()
    iv = torch.arange(nv, device=ld.device)
    u[:, iv, iv] = sd.t()
    return u


def _rsum(x):
    """Sum over rows (dim 0), keeping it: (R, B) -> (1, B)."""
    return torch.sum(x, dim=0, keepdim=True)


def _apgd_math(yd, b, rreg, act, mu, f0, v0, *, kl, kc, iterations,
               noslip_iterations, power_iters, flip=None, trace=None):
    """APGD + noslip on A = Yd^T Yd + diag(rreg). yd (nv, R, B), vectors
    (R, B), mu (kc, B); v0 = warm power-iteration start. Returns
    (f (R, B), ystar = Yd f (nv, B), v (R, B)).

    The restart test r = sum(g (z_new - z)) > 0 is the one discontinuous
    decision: where r is near 0 another summation order can decide it
    otherwise. ``flip`` (iterations, B) bool takes the other decision
    where True; ``trace``, a list, gains (r, sum |g (z_new - z)|), each
    (1, B), per iteration."""
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
    for i in range(iterations):
        beta = kk / (kk + 3.0)
        y = z + beta * (z - zp)
        g = mv_as(y) - bs
        z_new = proj(y - inv_l * g)
        gdz = g * (z_new - z)
        restart = _rsum(gdz) > 0
        if trace is not None:
            trace.append((_rsum(gdz), _rsum(gdz.abs())))
        if flip is not None:
            restart = restart ^ flip[i:i + 1]
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
                         power_iters: int = 4, flip=None, trace=None):
    """Plain PyTorch version of ``solve_rows``: J build, up-solve, APGD,
    then ``tree_ldl.mul_lt`` and ``tree_ldl.solve_down`` for the outputs.
    ``flip`` and ``trace`` as in ``_apgd_math``."""
    if v0 is None:
        v0 = active
    yd, bvec = upsolve_build_yd_reference(
        tree, d6, u6, b1, b2, lim_sign, lim_dadr, maskd, ld, dinv,
        qacc_smooth, qvel, kcoef, bcoef, posr)
    f, ystar, v = _apgd_math(yd, bvec, rreg, active, mu, f0, v0,
                             kl=kl, kc=kc, iterations=iterations,
                             noslip_iterations=noslip_iterations,
                             power_iters=power_iters, flip=flip, trace=trace)
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
                          + [_P] * 2         # the packed tables, the chain
                          + [_I] * 15        # sizes and iteration counts
                          + [_P]),           # stream
    "upsolve_launch": ([_P] * 14             # inputs (maskd as bits)
                       + [_P] * 2            # outputs yd, b
                       + [_P]                # the packed tables
                       + [_I] * 9            # sizes
                       + [_P]),              # stream
    "upsolve_yd_launch": ([_P] * 8           # inputs
                          + [_P] * 2         # outputs yd, b
                          + [_P]             # the packed tables
                          + [_I] * 9         # sizes
                          + [_P]),           # stream
    "apgd_launch": ([_P] * 7 + [_P] * 3      # inputs, outputs f, ystar, v
                    + [_I] * 9 + [_P]),      # sizes and counts, stream
}

# The kernels' shape limits (csrc/solve_rows.cu): solve_rows and
# apgd_iterate run one block of 256 threads per env, Yd held as 8 warps x
# 14 dofs by 32 lanes x CPL column groups, in two instances: CPL 5 takes
# R <= 160 rows, CPL 6 R <= 192 (groups 4-5 read from shared memory, the
# first four in registers). A launch takes the narrower instance that
# holds R. Within them shared memory stays under 227 kB per block (a chain
# of 112 dofs at 192 rows).
THREADS = 256
MAX_NV = 112
CPL_NARROW, CPL_WIDE = 5, 6
MAX_R_NARROW = 32 * CPL_NARROW
MAX_R = 32 * CPL_WIDE
# The top chain taken out of the up-sweep's pull: at most CHAIN dofs
# (csrc CH).
CHAIN = 6
# upsolve_build_yd's and upsolve_yd's block (one kernel): YD_ENVS
# consecutive envs by YD_COLS columns (csrc YE, YC), YD_PARTS threads per
# (env, column) pair, each on one part of the dofs (csrc YQ).
YD_ENVS, YD_COLS, YD_PARTS = 8, 16, 4
YD_PAIRS = YD_ENVS * YD_COLS
YD_THREADS = YD_PARTS * YD_PAIRS
# apgd_iterate's thread block cluster: APGD_CLUSTER blocks on as many
# consecutive envs (csrc AC); a warp loads APGD_RUNS runs of 32 words a
# step (csrc AB).
APGD_CLUSTER, APGD_RUNS = 8, 2


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
          n_head = nv + 1 + n_up words, staged in shared memory;
    push  (ndepth nv): L^{-1} x pushed root first, step l of dof i at
          l nv + i: a | e << 7 for its ancestor a at depth l and the entry
          e of L[i, a], -1 where i has no ancestor that deep.

    Also n_up, n_head, ndepth (the tree's depth) and n_tab = len(tab), and
    the top chain the kernels take out of the up-sweep's pull
    (``top_chain``): its length ``nch``, the split point ``dsplit`` of the
    dofs below between two threads (``split_points``; upsolve_yd's
    ``ysplit`` between YD_PARTS) and ``chain``, n_chain = len(chain) int32
    entry indices (-1: no entry, read as L = 0): L[i, k] for i >= nch,
    k < CHAIN at (i - nch) CHAIN + k, then the chain's own L[i, j] at
    (nv - nch) CHAIN + i CHAIN + j (empty when nch is 0)."""
    nv = tree.nv
    if nv > MAX_NV:
        raise ValueError(f"pack_tables: nv={nv} > {MAX_NV}")
    up = TL.flat_up(tree)
    pu = _pack(up[:, 0], up[:, 1], up[:, 2])
    order = np.argsort(up[:, 2], kind="stable")
    cptr = np.concatenate([[0], np.cumsum(np.bincount(up[:, 2],
                                                      minlength=nv))])
    entry = _entries(tree)
    ndepth = max(len(a) for a in tree.anc_lists)
    push = np.full((ndepth, nv), -1, np.int64)
    for i, anc in enumerate(tree.anc_lists):
        for depth, a in enumerate(reversed(anc)):
            push[depth, i] = a | entry[(i, a)] << 7
    tab = np.concatenate([cptr, pu[order], push.reshape(-1)]
                         ).astype(np.int32)
    parent = _parents(tree)
    m = top_chain(parent)
    chain = _chain_entries(tree, m, entry)
    return dict(tab=tab, n_up=len(up), n_head=nv + 1 + len(up),
                ndepth=ndepth, n_tab=len(tab), nch=m,
                dsplit=split_points(parent, m, np.diff(cptr), 2)[0],
                ysplit=split_points(parent, m, np.diff(cptr), YD_PARTS),
                chain=chain, n_chain=len(chain))


def _entries(tree) -> dict:
    """{(i, j): entry index of L[i, j]} over the factor's off-diagonal."""
    return {(int(i), int(j)): e for e, (i, j) in enumerate(
        zip(tree.entry_i, tree.entry_j)) if i != j}


def _parents(tree) -> np.ndarray:
    """Each dof's parent dof (-1 at a root), from the tree's ancestors."""
    return np.array([a[0] if len(a) else -1 for a in tree.anc_lists],
                    np.int64)


def top_chain(parent) -> int:
    """Length m of the top chain: dofs 0 .. m - 1 with each dof k < m the
    parent of k + 1 from root dof 0, at most CHAIN of them, above every
    other dof (each dof >= m descends from m - 1), as a free root's six
    dofs are. 0 where no such chain has 2 dofs (a forest)."""
    parent = np.asarray(parent)
    n = 0
    while n < min(CHAIN, len(parent)) and parent[n] == n - 1:
        n += 1
    for m in range(n, 1, -1):
        if bool((parent[m:] >= m - 1).all()):
            return m
    return 0


def _chain_entries(tree, m: int, entry: dict) -> np.ndarray:
    """``pack_tables``' chain: the entry index of L[i, k] for each dof
    i >= m and k < CHAIN, then of the chain's own L[i, j], -1 where L has
    no entry (k >= m, or k no ancestor of i); ``entry`` from ``_entries``."""
    if m == 0:
        return np.zeros(0, np.int32)
    nv = tree.nv
    below = [[entry.get((i, k), -1) for k in range(CHAIN)]
             for i in range(m, nv)]
    own = [[entry.get((i, j), -1) if i < m else -1 for j in range(CHAIN)]
           for i in range(CHAIN)]
    return np.asarray(below + own, np.int32).reshape(-1)


def split_points(parent, m: int, n_pull, parts: int) -> list:
    """Where the kernels split a column's dofs below the top chain between
    ``parts`` threads: boundaries m < d_1 <= ... <= d_{parts-1} <= nv that
    best balance the parts [0, d_1) (with the chain, resolved after),
    [d_1, d_2), ..., [d_{parts-1}, nv), each d a subtree boundary: no dof of
    [d, nv) has an ancestor in [m, d) (each such dof's parent is < m or
    >= d), so each part's pull stays inside it. A boundary at nv leaves a
    part empty. ``n_pull``: each dof's up-sweep entries. The weights count
    a thread's shared-memory loads and FMAs: J build and scaling ~21 per
    dof, the chain sums ~10 per dof below the chain, the pull ~5 per entry
    and ~6 per dof."""
    parent = np.asarray(parent)
    nv = len(parent)
    iv = np.arange(nv)
    cost = 21.0 + np.where(iv >= m, 10.0 + 6.0 + 5.0 * np.asarray(n_pull),
                           0.0)
    acc = np.concatenate([[0.0], np.cumsum(cost)])
    cuts = [d for d in range(m + 1, nv)
            if bool(((parent[d:] < m) | (parent[d:] >= d)).all())] + [nv]
    # best[k][d]: the least largest part when dofs [0, d) form k + 1 parts
    best = {(0, d): acc[d] + 15.0 for d in cuts}
    back = {}
    for k in range(1, parts):
        for d in cuts:
            best[k, d], back[k, d] = min(
                (max(best[k - 1, c], acc[d] - acc[c]), c)
                for c in cuts if c <= d)
    out, d = [nv], nv
    for k in range(parts - 1, 0, -1):
        d = back[k, d]
        out.append(d)
    return out[::-1][:-1]


def _tables(tree, device):
    """``pack_tables`` with ``tab`` and ``chain`` on ``device`` (cached on
    the tree)."""
    key = ("sk_tab", str(device))
    t = tree._dev.get(key)
    if t is None:
        t = pack_tables(tree)
        for k in ("tab", "chain"):
            t[k] = torch.as_tensor(t[k], device=device).contiguous()
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
    host sync) once per tensor and version. The bits live as long as the
    mask: a captured CUDA graph reads them by address."""
    hit = _mask_cache.get(id(maskd))
    if hit is not None and hit[0]() is maskd and hit[1] == maskd._version:
        return hit[2]
    bits = mask_bits(maskd)
    if len(_mask_cache) > 64:
        for k in [k for k, v in _mask_cache.items() if v[0]() is None]:
            del _mask_cache[k]
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


def smem_bytes(nv: int, R: int, nM: int, n_head: int, n_up: int,
               n_chain: int) -> int:
    """Dynamic shared memory of one block, in bytes. Mirrors the kernels'
    carve-up (``carve`` in csrc/solve_rows.cu) in the instance that takes
    R rows (32 ``tile_cpl(R)`` of them): per-warp y slots, the warp
    partials of Yd^T y and of the block sums, eleven row vectors, d6 with
    qvel and qacc_smooth (8 words a dof), the top chain's L decoded
    (n_chain), Yd with an odd row stride, ld, five dof vectors, the
    up-sweep's n_up L entries and the n_head words of the tables' head."""
    nwarp = THREADS // 32
    mr = 32 * tile_cpl(R)
    return 4 * (nwarp * 16 + nwarp * mr + 4 * nwarp + 11 * mr + 8 * nv
                + n_chain + nv * (R | 1) + nM + 5 * nv + n_up + n_head)


def upsolve_yd_grid(R: int, B: int) -> tuple:
    """upsolve_yd's grid: (env tiles, column tiles) of YD_ENVS envs by
    YD_COLS columns (csrc ``upsolve_yd_launch``); the last of each may be
    ragged."""
    return -(-B // YD_ENVS), -(-R // YD_COLS)


def upsolve_yd_pair(bx: int, by: int, t: int) -> tuple:
    """The (env, column) that thread t of upsolve_yd's block (bx, by)
    takes, as the kernel computes it (threads t, t + YD_PAIRS, ... share a
    pair, each on one part of the dofs); past B or R it is masked."""
    p = t % YD_PAIRS
    return bx * YD_ENVS + p % YD_ENVS, by * YD_COLS + p // YD_ENVS


def upsolve_yd_smem(nv: int, n_up: int, build: bool = False) -> int:
    """upsolve_yd's dynamic shared memory per block, in bytes (csrc
    ``upsolve_yd_kernel``): the pairs' columns (nv per pair); per env a
    record of each dof's qvel and qacc_smooth (after its d6 with
    ``build``: 8 words, else 2) and the rhs sums of the pairs' other parts,
    then in the same place the up-sweep's L entries (n_up); sqrt(dinv);
    then cptr | cidx."""
    words = 8 if build else 2
    region = max(n_up, words * nv + 2 * (YD_PARTS - 1) * YD_COLS)
    return 4 * (nv * YD_PAIRS + (region + nv) * YD_ENVS + nv + 1 + n_up)


def upsolve_build_yd_smem(nv: int, n_up: int) -> int:
    """upsolve_build_yd's dynamic shared memory per block, in bytes: the
    same kernel's carve-up with each dof's d6 staged beside its qvel and
    qacc_smooth."""
    return upsolve_yd_smem(nv, n_up, build=True)


def upsolve_yd_dof_parts(nv: int, ysplit) -> list:
    """The dofs [v0, v1) of each of a pair's YD_PARTS threads, thread h
    YD_PAIRS + p taking part h (csrc ``upsolve_yd_kernel``)."""
    bounds = [0, *ysplit, nv]
    return list(zip(bounds[:-1], bounds[1:]))


def upsolve_build_yd_d6_copy(k, b0: int):
    """Where upsolve_build_yd's block stages word k of its env tile's d6
    (k < 6 nv YD_ENVS, k strided by the threads): (env, d6 word 6 v + c,
    shared-memory slot (v YD_ENVS + e) 8 + c), as the kernel computes
    them; 8 consecutive k read 8 consecutive envs, one sector."""
    k = np.asarray(k)
    e, vk = k % YD_ENVS, k // YD_ENVS
    return b0 + e, vk, ((vk // 6) * YD_ENVS + e) * 8 + vk % 6


def apgd_grid(B: int) -> int:
    """apgd_iterate's grid: B rounded up to whole clusters of
    APGD_CLUSTER blocks (csrc ``apgd_launch``); block b takes env b, and
    the blocks from B on only load for their cluster."""
    return -(-B // APGD_CLUSTER) * APGD_CLUSTER


def _apgd_run(block, t, i, a):
    """(first env of the cluster, lane, run n) of thread t of
    apgd_iterate's block in step i, run a: warp w of the block of rank q
    takes run n = ((i APGD_CLUSTER + q) 8 + w) APGD_RUNS + a, words
    [32 n, 32 n + 32) of Yd's nv R for each of its cluster's envs."""
    block, t = np.asarray(block), np.asarray(t)
    q = block % APGD_CLUSTER
    n = ((i * APGD_CLUSTER + q) * (THREADS // 32) + t // 32) * APGD_RUNS + a
    return block - q, t % 32, n


def apgd_load(block, t, i, a, j):
    """The (env, word k) that thread t of apgd_iterate's block loads in
    step i, run a, load j (csrc ``apgd_kernel``): word 32 n + 4 j +
    lane / 8 of env lane % 8 of its cluster, so 8 lanes read one sector.
    The kernel skips an env past B and a word past nv R."""
    b0, lane, n = _apgd_run(block, t, i, a)
    return b0 + lane % 8, 32 * n + 4 * j + lane // 8


def apgd_store(block, t, i, a, e):
    """What thread t of apgd_iterate's block stores into env e of its
    cluster for step i, run a: (env, word 32 n + lane, and the lane and
    load j whose register holds that word, the shuffle's source)."""
    b0, lane, n = _apgd_run(block, t, i, a)
    return b0 + e, 32 * n + lane, (lane % 4) * 8 + e, lane // 4


def check_shape(who: str, nv: int, R: int) -> None:
    """Raise unless the kernels take nv dofs and R rows."""
    if nv > MAX_NV or R > MAX_R:
        raise ValueError(f"{who}: nv={nv}, R={R}; the kernel takes nv <= "
                         f"{MAX_NV} and R <= {MAX_R} (Yd in registers)")


def kernel_info(kernel: str, nv: int, R: int, nM: int, tables: dict) -> dict:
    """Registers, shared memory, resident blocks and warps per SM, local
    (spill) bytes per thread and active clusters (apgd_iterate's; 0 for
    the others) of ``kernel`` ("solve_rows" or "apgd_iterate", in the
    instance that takes R rows, "upsolve_yd" or "upsolve_build_yd") at
    these shapes, with the tree's ``pack_tables``
    (``cuda_build.kernel_info``)."""
    n_up = tables["n_up"]
    if kernel in ("upsolve_yd", "upsolve_build_yd"):
        build = kernel == "upsolve_build_yd"
        info = cuda_build.kernel_info("solve_rows", 5 if build else 4,
                                      YD_THREADS,
                                      upsolve_yd_smem(nv, n_up, build))
        return dict(info, warps_per_sm=info["blocks_per_sm"]
                    * YD_THREADS // 32)
    which = ("solve_rows", "apgd_iterate").index(kernel)
    smem = (smem_bytes(nv, R, 0, 0, 0, 0) if which else
            smem_bytes(nv, R, nM, tables["n_head"], n_up, tables["n_chain"]))
    if tile_cpl(R) == CPL_WIDE:
        which += 2
    info = cuda_build.kernel_info("solve_rows", which, THREADS, smem)
    return dict(info, cpl=tile_cpl(R),
                warps_per_sm=info["blocks_per_sm"] * THREADS // 32)


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
    smem = smem_bytes(nv, R, nM, tb["n_head"], tb["n_up"], tb["n_chain"])
    ptrs = [x.data_ptr() for _, x, _, _ in checks]
    ptrs[6] = _mask_bits_cached(maskd).data_ptr()
    f = torch.empty((R, B), dtype=f32, device=dev)
    v = torch.empty((R, B), dtype=f32, device=dev)
    qfrc = torch.empty((nv, B), dtype=f32, device=dev)
    dqacc = torch.empty((nv, B), dtype=f32, device=dev)
    _launch("solve_rows", "solve_rows_launch", *ptrs,
            f.data_ptr(), v.data_ptr(), qfrc.data_ptr(), dqacc.data_ptr(),
            tb["tab"].data_ptr(), tb["chain"].data_ptr(), nv, R, B, nM, kl,
            kc, tb["n_up"], tb["ndepth"], tb["nch"], tb["dsplit"],
            tb["n_chain"], iterations, noslip_iterations, power_iters, smem,
            torch.cuda.current_stream(dev).cuda_stream)
    solve_rows.launches += 1
    return f, v, qfrc, dqacc


solve_rows.launches = 0


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
    dev = d6.device
    check_args("upsolve_build_yd", checks, dev)
    check_shape("upsolve_build_yd", nv, R)
    tb = _tables(tree, dev)
    n_up = tb["n_up"]
    ptrs = [x.data_ptr() for _, x, _, _ in checks]
    ptrs[6] = _mask_bits_cached(maskd).data_ptr()
    yd = torch.empty((nv, R, B), dtype=torch.float32, device=dev)
    b = torch.empty((R, B), dtype=torch.float32, device=dev)
    _launch("upsolve_build_yd", "upsolve_launch", *ptrs, yd.data_ptr(),
            b.data_ptr(), tb["tab"].data_ptr(), nv, R, B, n_up, tb["nch"],
            *tb["ysplit"], upsolve_build_yd_smem(nv, n_up),
            torch.cuda.current_stream(dev).cuda_stream)
    upsolve_build_yd.launches += 1
    return yd, b


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
    dev = jt.device
    checks = [
        ("jt", jt, (nv, R, B), f32), ("ld", ld, (ld.shape[0], B), f32),
        ("dinv", dinv, (nv, B), f32),
        ("qacc_smooth", qacc_smooth, (nv, B), f32),
        ("qvel", qvel, (nv, B), f32), ("kcoef", kcoef, (R, B), f32),
        ("bcoef", bcoef, (R, B), f32), ("posr", posr, (R, B), f32)]
    check_args("upsolve_yd", checks, dev)
    check_shape("upsolve_yd", nv, R)
    tb = _tables(tree, dev)
    yd = torch.empty((nv, R, B), dtype=f32, device=dev)
    b = torch.empty((R, B), dtype=f32, device=dev)
    _launch("upsolve_yd", "upsolve_yd_launch",
            *[x.data_ptr() for _, x, _, _ in checks], yd.data_ptr(),
            b.data_ptr(), tb["tab"].data_ptr(), nv, R, B, tb["n_up"],
            tb["nch"], *tb["ysplit"], upsolve_yd_smem(nv, tb["n_up"]),
            torch.cuda.current_stream(dev).cuda_stream)
    upsolve_yd.launches += 1
    return yd, b


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
    smem = smem_bytes(nv, R, 0, 0, 0, 0)
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
