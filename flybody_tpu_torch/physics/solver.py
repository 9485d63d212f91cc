"""Dual APGD constraint solver, matrix-free over the sparse tree factor.

Solves the dual of MuJoCo's soft-constraint QP:

    min_{f in K}  0.5 f' (J M^-1 J' + R) f  -  f' (aref - J qacc_smooth)

with K = {limit/frictionless forces >= 0} x {elliptic friction cones}.
Accelerated projected gradient (APGD) with adaptive per-env restart; the
(A f) matvec is evaluated matrix-free as J (M^-1 (J' f)) through the
sparse LDL^T factor (ops/tree_ldl), with a Jacobi preconditioner from
MuJoCo's invweight. The per-env step size comes from 6 power iterations
on the preconditioned (A + R). A noslip post-pass (MuJoCo
opt.noslip_iterations semantics: the friction components re-solved with
zero regularization, normal forces frozen) runs as projected gradient on
the tangential block.

This is the ``Option`` default (``contact_solver="apgd"``) and, at 800
iterations, the oracle every other solver is held to. It runs no kernel.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.physics import smooth as S
from flybody_tpu_torch.physics.types import Data, Model


def _tree_dot(xs, ys):
    """Sum over matched force lists -> (B,)."""
    tot = None
    for x, y in zip(xs, ys):
        v = torch.sum(x * y, dim=tuple(range(x.ndim - 1)))
        tot = v if tot is None else tot + v
    return tot


def _bcast(v, ref):
    return v.reshape((1,) * (ref.ndim - 1) + (-1,))


def warm_match(sel, warm_sel, warm_f):
    """Previous forces of this step's selected slots: a (K, J) membership
    contraction of warm_f (J, 3, B) by sel (K, B) == warm_sel (J, B) ->
    (K, 3, B)."""
    hit = (sel[:, None, :] == warm_sel[None, :, :]).to(warm_f.dtype)
    return torch.einsum("kjB,jdB->kdB", hit, warm_f)


def solve_dual(m: Model, d: Data, lim, groups, iterations: int = 24,
               noslip_iterations: int = 0):
    """Returns (f_lim (nl, B) | None, [f_group (K, dim, B)])."""
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    dadr = m.ix(lim.dadr) if lim is not None else None

    def jt_apply(f_lim, f_groups):
        """J^T f -> (nv, B)."""
        u = torch.zeros_like(d.qvel)
        if lim is not None:
            u = u.index_add(0, dadr, lim.sign * f_lim)
        for g, f in zip(groups, f_groups):
            u = u + torch.einsum("kdvB,kdB->vB", g.jac, f)
        return u

    def j_apply(w):
        """J w -> (limit rows, [group rows])."""
        out_lim = lim.sign * w[dadr] if lim is not None else None
        return out_lim, [torch.einsum("kdvB,vB->kdB", g.jac, w)
                         for g in groups]

    def matvec(f_lim, f_groups, with_R=True):
        o_lim, o_groups = j_apply(S.solve_m(m, d, jt_apply(f_lim, f_groups)))
        if with_R:
            if lim is not None:
                o_lim = o_lim + lim.R * f_lim
            o_groups = [o + g.R * f for o, g, f in
                        zip(o_groups, groups, f_groups)]
        return o_lim, o_groups

    # rhs b = aref - J qacc_smooth
    ja_lim, ja_groups = j_apply(d.qacc_smooth)
    b_lim = (lim.aref - ja_lim) if lim is not None else None
    b_groups = [g.aref - ja for g, ja in zip(groups, ja_groups)]

    def proj(f_lim, f_groups, tangent_only=False, fn_frozen=None):
        if lim is not None and not tangent_only:
            f_lim = torch.clamp(f_lim, min=0.0) * lim.active
        out = []
        for gi, (g, f) in enumerate(zip(groups, f_groups)):
            if f.shape[1] == 1:
                if not tangent_only:
                    f = torch.clamp(f, min=0.0) * g.active[:, None]
                out.append(f)
                continue
            ft = f[:, 1:]
            t = torch.sqrt(torch.sum(ft * ft, dim=1)) + 1e-20
            if tangent_only:
                # ball projection: |ft| <= mu * fn_frozen
                cap = torch.clamp(g.mu * fn_frozen[gi], min=0.0)
                ft = ft * torch.clamp(cap / t, max=1.0)[:, None]
                out.append(torch.cat([f[:, :1], ft], dim=1)
                           * g.active[:, None])
                continue
            fn = f[:, 0]
            mu = g.mu
            inside = t <= mu * fn
            zero = mu * t <= -fn
            fn_m = (fn + mu * t) / (1.0 + mu * mu)
            scale_t = mu * fn_m / t
            nil = torch.zeros_like(fn)
            fn_new = torch.where(inside, fn, torch.where(zero, nil, fn_m))
            ft_new = torch.where(inside[:, None], ft,
                                 torch.where(zero[:, None],
                                             torch.zeros_like(ft),
                                             ft * scale_t[:, None]))
            out.append(torch.cat([fn_new[:, None], ft_new], dim=1)
                       * g.active[:, None])
        return f_lim, out

    def flat(f_lim, f_groups):
        return ([f_lim] if f_lim is not None else []) + list(f_groups)

    # ---- Jacobi preconditioner: P ~ 1/diag(A + R) from invweight, uniform
    # per friction cone (the normal row's value) so the cone projection
    # stays valid in the scaled metric
    P_lim = (1.0 / torch.clamp(lim.diag, min=1e-30)) \
        if lim is not None else None
    P_groups = [(1.0 / torch.clamp(g.diag, min=1e-30))[:, None, :]
                .expand(bg.shape) for g, bg in zip(groups, b_groups)]

    def act_mask(f_lim, f_groups):
        fl = f_lim * lim.active if lim is not None else None
        return fl, [f * g.active[:, None] for g, f in zip(groups, f_groups)]

    # ---- step size: power iteration on P^1/2 (A+R) P^1/2 over the active
    # rows (inactive rows are projected to zero and must not inflate it)
    v_lim = torch.ones_like(b_lim) if lim is not None else None
    v_groups = [torch.ones_like(bg) for bg in b_groups]
    v_lim, v_groups = act_mask(v_lim, v_groups)
    L = torch.ones((B,), dtype=dtype, device=d.qpos.device)
    for _ in range(6):
        nrm = torch.sqrt(_tree_dot(flat(v_lim, v_groups),
                                   flat(v_lim, v_groups))) + 1e-30
        v_lim = v_lim / nrm if lim is not None else None
        v_groups = [v / nrm for v in v_groups]
        s_lim = v_lim * torch.sqrt(P_lim) if lim is not None else None
        s_groups = [v * torch.sqrt(P) for v, P in zip(v_groups, P_groups)]
        s_lim, s_groups = matvec(s_lim, s_groups)
        v_lim = s_lim * torch.sqrt(P_lim) if lim is not None else None
        v_groups = [s * torch.sqrt(P) for s, P in zip(s_groups, P_groups)]
        v_lim, v_groups = act_mask(v_lim, v_groups)
        L = torch.sqrt(_tree_dot(flat(v_lim, v_groups),
                                 flat(v_lim, v_groups))) + 1e-30
    inv_L = 1.0 / torch.clamp(1.5 * L, min=1.0)

    # ---- warm start from the previous step's selected forces -----------
    f_lim0 = d.warm_lim.to(dtype) if lim is not None else None
    f_groups0 = [warm_match(g.sel, d.warm_sel, d.warm_f.to(dtype))
                 [:, :bg.shape[1]] for g, bg in zip(groups, b_groups)]
    f_lim0, f_groups0 = proj(f_lim0, f_groups0)

    # ---- APGD with per-env adaptive restart ----------------------------
    f_lim, f_groups = f_lim0, f_groups0
    p_lim, p_groups = f_lim0, f_groups0
    kk = torch.zeros((B,), dtype=dtype, device=d.qpos.device)
    for _ in range(iterations):
        beta = kk / (kk + 3.0)
        y_groups = [f + _bcast(beta, f) * (f - p)
                    for f, p in zip(f_groups, p_groups)]
        y_lim = (f_lim + _bcast(beta, f_lim) * (f_lim - p_lim)) \
            if lim is not None else None
        g_lim, g_groups = matvec(y_lim, y_groups)
        if lim is not None:
            g_lim = g_lim - b_lim
        g_groups = [g - bg for g, bg in zip(g_groups, b_groups)]
        n_lim = (y_lim - _bcast(inv_L, y_lim) * P_lim * g_lim) \
            if lim is not None else None
        n_groups = [y - _bcast(inv_L, y) * P * g
                    for y, g, P in zip(y_groups, g_groups, P_groups)]
        n_lim, n_groups = proj(n_lim, n_groups)
        # restart: the gradient at y correlates with the step just taken
        diffs = [n - f for n, f in zip(n_groups, f_groups)]
        df = flat((n_lim - f_lim) if lim is not None else None, diffs)
        restart = _tree_dot(flat(g_lim, g_groups), df) > 0
        kk = torch.where(restart, torch.zeros_like(kk), kk + 1.0)
        p_lim, p_groups = f_lim, f_groups
        f_lim, f_groups = n_lim, n_groups

    # ---- noslip post-pass (tangentials, R = 0, normals frozen) ---------
    if noslip_iterations > 0 and any(f.shape[1] > 1 for f in f_groups):
        fn_frozen = [f[:, 0] for f in f_groups]
        for _ in range(2 * noslip_iterations):
            _, g_groups = matvec(f_lim, f_groups, with_R=False)
            g_groups = [g - bg for g, bg in zip(g_groups, b_groups)]
            n_groups = []
            for g, f, gr in zip(groups, f_groups, g_groups):
                if f.shape[1] == 1:
                    n_groups.append(f)
                    continue
                P = 1.0 / torch.clamp(g.diag - g.R[:, 0], min=1e-30)
                step = f - _bcast(inv_L, f) * P[:, None] * gr
                # keep the normal frozen
                n_groups.append(torch.cat([f[:, :1], step[:, 1:]], dim=1))
            _, f_groups = proj(None, n_groups, tangent_only=True,
                               fn_frozen=fn_frozen)

    return f_lim, f_groups
