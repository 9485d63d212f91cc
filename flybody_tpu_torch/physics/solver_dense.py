"""Dense-dual ADMM constraint solver.

Same dual QP as physics/solver.py:

    min_{f in K}  0.5 f' (A + R) f  -  f' b,   A = J M^-1 J', b = aref - J a0

but A is assembled once per substep instead of applied matrix-free:

  * X = M^-1 J'   by the sparse tree factor (one batched multi-rhs solve)
  * A = J X       one (rows, nv) x (nv, rows) product per env
  * Jacobi scaling s = 1/sqrt(diag(A) + R), uniform per friction cone so
    the scaled feasible set is still a product of cones
  * ADMM on the scaled problem (rho 10, over-relaxation alpha 1.9): the
    f-step factors (A_s + rho I) once (blocked batched Cholesky,
    ops/linalg) and each iteration is two triangular solves and a cone
    projection.

With ``use_kernel`` the iterations run in the CUDA kernel of
ops/admm_kernel.py on the explicit inverse W = (A_s + rho I)^-1 (bf16),
when the flat row layout is [nonneg rows | condim-3 cones] (asserted) and
has kc > 0 cones and at most 256 rows; otherwise the plain ADMM loop runs.
That is a static property of the layout, as in the JAX package.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.ops import admm_kernel as AK
from flybody_tpu_torch.ops import linalg as LA
from flybody_tpu_torch.ops import rows as RW
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics.solver import warm_match
from flybody_tpu_torch.physics.types import Data, Model

LIMIT_ACTIVE = 32   # top-K selected limit rows in the dense system
KERNEL_MAX_ROWS = 256


class _LimSel:
    """Per-env top-K selection of limit rows by margin-adjusted limit
    distance, most violating first (ties to the lower index). The fly has
    102 limited joints but ~15 near their range at any state."""

    def __init__(self, m: Model, lim, K: int):
        nl = lim.sign.shape[0]
        self.nl = nl
        self.K = min(K, nl)
        self.idx = RW.smallest_k(lim.pos, self.K)          # (K, B)
        self.sign = RW.take(lim.sign, self.idx)
        self.aref = RW.take(lim.aref, self.idx)
        self.R = RW.take(lim.R, self.idx)
        self.active = RW.take(lim.active, self.idx)
        self.dadr_sel = m.ix(lim.dadr)[self.idx]           # (K, B)

    def rows_j(self, nv: int):
        """(K, nv, B) rows sign * e_dadr."""
        ohv = torch.nn.functional.one_hot(self.dadr_sel, nv).permute(0, 2, 1)
        return ohv.to(self.sign.dtype) * self.sign[:, None, :]

    def scatter_forces(self, f_sel):
        """(K, B) selected forces -> (nl, B) full limit-force vector."""
        return RW.add_rows(f_sel[:, None], self.idx, self.nl)[:, 0]


def _gather_rows(ls, groups, d):
    """Flat (rows, nv, B) J and (rows, B) aref / R / active."""
    nv, B = d.qvel.shape
    Js, arefs, Rs, actives = [], [], [], []
    if ls is not None:
        Js.append(ls.rows_j(nv))
        arefs.append(ls.aref)
        Rs.append(ls.R)
        actives.append(ls.active)
    for g in groups:
        ndim = min(g.condim, 3)
        Js.append(g.jac.reshape(g.K * ndim, nv, B))
        arefs.append(g.aref.reshape(g.K * ndim, B))
        Rs.append(g.R.reshape(g.K * ndim, B))
        actives.append(torch.repeat_interleave(g.active, ndim, dim=0))
    return (torch.cat(Js, dim=0), torch.cat(arefs, dim=0),
            torch.cat(Rs, dim=0), torch.cat(actives, dim=0))


def _cone_proj(fn, ft, mu):
    """Elliptic cone projection of (fn (K, B), ft (K, d, B))."""
    t = torch.sqrt(torch.sum(ft * ft, dim=1)) + 1e-20
    inside = t <= mu * fn
    zero = mu * t <= -fn
    fn_m = (fn + mu * t) / (1.0 + mu * mu)
    scale_t = mu * fn_m / t
    fn_new = torch.where(inside, fn,
                         torch.where(zero, torch.zeros_like(fn), fn_m))
    ft_new = torch.where(inside[:, None], ft,
                         torch.where(zero[:, None], torch.zeros_like(ft),
                                     ft * scale_t[:, None]))
    return fn_new, ft_new


def _proj_groups(ls, groups, f_flat):
    """Project the flat scaled force vector onto the feasible set (the
    row scaling is uniform within each cone, so the elliptic projection
    applies unchanged in the scaled space)."""
    out = []
    off = 0
    if ls is not None:
        out.append(torch.clamp(f_flat[:ls.K], min=0.0) * ls.active)
        off = ls.K
    for g in groups:
        ndim = min(g.condim, 3)
        f = f_flat[off:off + g.K * ndim].reshape(g.K, ndim, -1)
        off += g.K * ndim
        if ndim == 1:
            out.append((torch.clamp(f, min=0.0)
                        * g.active[:, None]).reshape(g.K, -1))
            continue
        fn_new, ft_new = _cone_proj(f[:, 0], f[:, 1:], g.mu)
        proj = torch.cat([fn_new[:, None], ft_new], dim=1)
        out.append((proj * g.active[:, None]).reshape(g.K * ndim, -1))
    return torch.cat(out, dim=0)


def _warm_flat(ls, groups, d, dtype):
    """Flat warm-start forces matched from the previous step's selected
    slots (the same membership contraction as solver.py)."""
    parts = []
    if ls is not None:
        parts.append(RW.take(d.warm_lim.to(dtype), ls.idx))
    for g in groups:
        ndim = min(g.condim, 3)
        prev = warm_match(g.sel, d.warm_sel, d.warm_f.to(dtype))[:, :ndim]
        parts.append(prev.reshape(g.K * ndim, -1))
    return torch.cat(parts, dim=0)


def kernel_layout(ls, groups, rows: int):
    """(use, kl, kc, mu) of the kernel path: the flat layout must be
    [nonneg rows | condim-3 cones] (asserted), and the kernel runs when it
    has kc > 0 cones and rows <= KERNEL_MAX_ROWS."""
    kl = ls.K if ls is not None else 0
    kc = 0
    seen_cone = False
    mus = []
    for g in groups:
        ndim = min(g.condim, 3)
        if ndim == 1:
            assert not seen_cone, "condim-1 group after a cone group"
            kl += g.K
        else:
            assert ndim == 3, "the admm kernel supports condim 1/3 only"
            seen_cone = True
            kc += g.K
            mus.append(g.mu)
    use = kc > 0 and rows <= KERNEL_MAX_ROWS
    return use, kl, kc, (torch.cat(mus, dim=0) if mus else None)


def dense_system(m: Model, d: Data, lim, groups, rho: float = 10.0):
    """The assembled, Jacobi-scaled dual of one substep: ls (the limit
    selection), A (B, rows, rows), b and s (rows, B), bs = b s, active,
    the factor of M = A_s + rho I (``fac``) and the scaled warm start z0,
    as a dict."""
    dtype = d.qpos.dtype
    B = d.qvel.shape[-1]
    ls = _LimSel(m, lim, LIMIT_ACTIVE) if lim is not None else None
    J, aref, Rreg, active = _gather_rows(ls, groups, d)

    # ---- assemble A = J M^-1 J' (one multi-rhs tree solve + one product)
    X = TL.solve(m.tree, d.qLD, d.qLDiagInv,
                 J.permute(1, 0, 2).contiguous())       # (nv, rows, B)
    A = torch.einsum("rvB,vsB->Brs", J, X)              # (B, rows, rows)
    b = aref - torch.einsum("rvB,vB->rB", J, d.qacc_smooth)

    # ---- per-cone Jacobi scaling (uniform inside each cone)
    diagA = torch.diagonal(A, dim1=1, dim2=2).T + Rreg   # (rows, B)
    off = 0
    dlist = []
    if ls is not None:
        dlist.append(diagA[:ls.K])
        off = ls.K
    for g in groups:
        ndim = min(g.condim, 3)
        dn = diagA[off:off + g.K * ndim].reshape(g.K, ndim, B)[:, 0]
        dlist.append(torch.repeat_interleave(dn, ndim, dim=0))
        off += g.K * ndim
    s = 1.0 / torch.sqrt(torch.clamp(torch.cat(dlist, dim=0), min=1e-12))

    # scaled operator: As = S (A + diag(Rreg)) S, unit-ish diagonal
    SA = A * s.T[:, :, None] * s.T[:, None, :]
    SA.diagonal(dim1=1, dim2=2).add_((Rreg * s * s).T)
    SA.diagonal(dim1=1, dim2=2).add_(rho)
    z0 = _warm_flat(ls, groups, d, dtype) / torch.clamp(s, min=1e-30)
    return dict(ls=ls, A=A, b=b, s=s, bs=b * s, active=active,
                fac=LA.cho_factor(SA), z0=z0)


def inverse_operator(fac) -> torch.Tensor:
    """W = M^-1 (rows, rows, B) from the factor of M (rows solves against
    the identity); cond(M) <= ~(1 + lam_max / rho), so inverting
    explicitly is safe."""
    Ls, _ = fac
    eye = torch.eye(Ls.shape[-1], dtype=Ls.dtype,
                    device=Ls.device).expand(Ls.shape)
    return LA.cho_solve(fac, eye).permute(1, 2, 0)


def solve_dual_dense(m: Model, d: Data, lim, groups,
                     iterations: int = 20, noslip_iterations: int = 0,
                     rho: float = 10.0, alpha: float = 1.9,
                     use_kernel: bool = False):
    """Returns (f_lim (nl, B) | None, [f_group (K, dim, B)]) like
    solver.solve_dual, computed by dense ADMM (over-relaxation alpha).

    use_kernel: run the iterations in ops/admm_kernel.admm_iterate (see
    the module doc for when the layout allows it)."""
    dtype = d.qpos.dtype
    sysd = dense_system(m, d, lim, groups, rho)
    ls, A, b, s, bs, fac, z0 = (sysd[k] for k in (
        "ls", "A", "b", "s", "bs", "fac", "z0"))
    rows = b.shape[0]

    if use_kernel:
        use_kernel, kl, kc, mu = kernel_layout(ls, groups, rows)
    if use_kernel:
        f32 = torch.float32
        z = AK.admm_iterate(
            inverse_operator(fac).to(f32), bs.to(f32).contiguous(),
            z0.to(f32).contiguous(), mu.to(f32).contiguous(),
            sysd["active"].to(f32).contiguous(), kl=kl, kc=kc,
            iterations=iterations, rho=float(rho),
            alpha=float(alpha)).to(dtype)
    else:
        # rho and alpha in the working dtype, as the JAX package holds them
        rho_a = torch.as_tensor(rho, dtype=dtype, device=b.device)
        alpha_a = torch.as_tensor(alpha, dtype=dtype, device=b.device)
        z = _proj_groups(ls, groups, z0)
        u = torch.zeros_like(z)
        for _ in range(iterations):
            f = LA.cho_solve(fac, (bs + rho_a * (z - u)).T).T
            fr = alpha_a * f + (1.0 - alpha_a) * z   # over-relaxation
            z_new = _proj_groups(ls, groups, fr + u)
            u = u + fr - z_new
            z = z_new
    f_flat = z * s                                    # unscale

    # ---- noslip post-pass: tangentials with R = 0, normals frozen,
    # projected gradient on the dense operator
    nl = ls.K if ls is not None else 0

    def split(ff):
        out, off2 = [], nl
        for g in groups:
            ndim = min(g.condim, 3)
            out.append(ff[off2:off2 + g.K * ndim].reshape(g.K, ndim, -1))
            off2 += g.K * ndim
        return out

    if noslip_iterations > 0 and any(min(g.condim, 3) > 1 for g in groups):
        fn_frozen = [f[:, 0] for f in split(f_flat)]
        for _ in range(2 * noslip_iterations):
            grad = torch.einsum("Brs,sB->rB", A, f_flat) - b
            parts = split(f_flat - (s * s) * grad)     # Jacobi-scaled step
            out = [f_flat[:nl]] if nl else []
            for g, p, c, fn in zip(groups, parts, split(f_flat), fn_frozen):
                ndim = min(g.condim, 3)
                if ndim == 1:
                    out.append(c.reshape(g.K, -1))
                    continue
                ft = p[:, 1:]
                t = torch.sqrt(torch.sum(ft * ft, dim=1)) + 1e-20
                cap = torch.clamp(g.mu * fn, min=0.0)
                ft = ft * torch.clamp(cap / t, max=1.0)[:, None]
                new = torch.cat([fn[:, None], ft], dim=1)
                out.append((new * g.active[:, None]).reshape(g.K * ndim, -1))
            f_flat = torch.cat(out, dim=0)

    # ---- unflatten
    f_lim = ls.scatter_forces(f_flat[:nl]) if ls is not None else None
    return f_lim, split(f_flat)
