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

In this frozen copy each wrapper runs its ``*_reference`` on any device:
the plain arithmetic the benchmark holds the kernels to.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.ops import tree_ldl as TL


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


def solve_rows(*args, **kw):
    """``solve_rows_reference`` on any device."""
    return solve_rows_reference(*args, **kw)


def upsolve_build_yd(*args, **kw):
    """``upsolve_build_yd_reference`` on any device."""
    return upsolve_build_yd_reference(*args, **kw)


def apgd_iterate(*args, **kw):
    """``apgd_iterate_reference`` on any device."""
    return apgd_iterate_reference(*args, **kw)
