"""Exact convex narrowphase: support minimization over the unit sphere.

For convex bodies S1, S2 with Minkowski difference D = S1 - S2 and support
h_D(u) = h_1(u) + h_2(-u),

    signed_distance(S1, S2) = -min_{|u|=1} h_D(u)

in both regimes (separated: -distance; penetrating: +depth), and the
optimal u points from geom1 toward geom2. The smooth part is projected
gradient on S^2 with Barzilai-Borwein steps; the kinks (a segment or disk
axis orthogonal to u) are covered by a closed-form candidate set: one
unconstrained run, one run per flat axis on the great circle u.a = 0, the
disk poles +-a and +-normalize(a1 x a2). Two Riemannian Newton steps
polish the winner. Every run is branch-free and batched over (lanes, B).

Shapes are Ellipsoid(a) + Segment(h) + r * Ball:
    sphere r=size[0]; capsule h=size[1], r=size[0]; ellipsoid a=size;
    cylinder a=(size[0], size[0], 0), h=size[1].
"""

from __future__ import annotations

import numpy as np
import torch


def _n3(v, eps=1e-12):
    return torch.sqrt(torch.sum(v * v, dim=-2, keepdim=True) + eps)


def _dot(a, b):
    return torch.sum(a * b, dim=-2, keepdim=True)


def _mT(R, u):
    """R^T u: (..., 3, 3, B), (..., 3, B) -> (..., 3, B)."""
    return torch.einsum("...jiB,...jB->...iB", R, u)


def _m(R, u):
    """R u."""
    return torch.einsum("...ijB,...jB->...iB", R, u)


def _ez(like):
    e = torch.zeros_like(like)
    e[..., 2, :] = 1.0
    return e


def support_core(u_local, ell, seg_h):
    """Support point of Ellipsoid(ell)+Segment(seg_h) in the geom frame.
    u_local (..., 3, B); ell (..., 3, 1|B), seg_h (..., 1, 1|B)."""
    au = ell * u_local
    s_ell = ell * au / _n3(au)
    s_seg = seg_h * torch.sign(u_local[..., 2:3, :]) * _ez(u_local)
    return s_ell + s_seg


class _Pair:
    """Closure bundle for one batched pair lane-set."""

    def __init__(self, p1, R1, g1p, p2, R2, g2p):
        self.p1, self.R1, self.g1p = p1, R1, g1p
        self.p2, self.R2, self.g2p = p2, R2, g2p

        def rad(gp):
            ell, seg_h = gp
            return torch.amax(ell, dim=-2, keepdim=True) + seg_h
        self.c = p1 - p2
        scale = rad(g1p) + rad(g2p) + _n3(self.c)
        self.eta0 = 1.0 / torch.clamp(scale, min=1e-9)

    def sup(self, u):
        s1l = support_core(_mT(self.R1, u), *self.g1p)
        s2l = support_core(_mT(self.R2, -u), *self.g2p)
        return self.p1 + _m(self.R1, s1l), self.p2 + _m(self.R2, s2l)

    def f(self, u, s1, s2):
        return _dot(u, s1 - s2)[..., 0, :]


def _pgd(pair: _Pair, u0, iters: int, proj_axis=None):
    """Projected-gradient descent of f on S^2, optionally constrained to
    the great circle orthogonal to proj_axis. Returns (u, f, s1, s2)."""
    eta0 = pair.eta0

    def project(u):
        if proj_axis is not None:
            u = u - _dot(u, proj_axis) * proj_axis
        return u / _n3(u)

    def tangrad(u, g):
        r = g - _dot(u, g) * u
        if proj_axis is not None:
            r = r - _dot(r, proj_axis) * proj_axis
        return r

    u = project(u0)
    s1, s2 = pair.sup(u)
    r0 = tangrad(u, s1 - s2)
    u_prev, r_prev = u, r0
    u = project(u - eta0 * r0)
    eta = eta0.expand(r0[..., :1, :].shape)
    for _ in range(iters):
        s1, s2 = pair.sup(u)
        r = tangrad(u, s1 - s2)
        du = u - u_prev
        dr = r - r_prev
        num = torch.sum(du * du, dim=-2, keepdim=True)
        den = torch.sum(du * dr, dim=-2, keepdim=True)
        eta_bb = num / torch.where(torch.abs(den) > 1e-30, den,
                                   torch.full_like(den, 1e-30))
        eta = torch.where((den > 1e-30) & (num > 0.0),
                          torch.minimum(torch.maximum(eta_bb, 0.05 * eta0),
                                        20.0 * eta0),
                          eta)
        u_prev, r_prev = u, r
        u = project(u - eta * r)
    s1, s2 = pair.sup(u)
    # one half-step polish damps any terminal two-cycle
    r = tangrad(u, s1 - s2)
    u_d = project(u - 0.5 * eta0 * r)
    s1d, s2d = pair.sup(u_d)
    bm = (pair.f(u_d, s1d, s2d) < pair.f(u, s1, s2))[..., None, :]
    u = torch.where(bm, u_d, u)
    s1 = torch.where(bm, s1d, s1)
    s2 = torch.where(bm, s2d, s2)
    return u, pair.f(u, s1, s2), s1, s2


def _ell_hess_quad(R, ell, u, t1, t2):
    """(t_i^T H t_j) entries of the ellipsoid-part support Hessian
    H = (diag(ell^2) - q q^T / w^2) / w in the geom frame."""
    ul, t1l, t2l = _mT(R, u), _mT(R, t1), _mT(R, t2)
    e2 = ell * ell
    w2 = torch.sum(e2 * ul * ul, dim=-2, keepdim=True)
    w = torch.sqrt(w2 + 1e-30)

    def quad(x, y):
        axy = torch.sum(e2 * x * y, dim=-2, keepdim=True)
        qx = torch.sum(e2 * ul * x, dim=-2, keepdim=True)
        qy = torch.sum(e2 * ul * y, dim=-2, keepdim=True)
        return ((axy - qx * qy / w2) / w)[..., 0, :]

    return quad(t1l, t1l), quad(t1l, t2l), quad(t2l, t2l)


def minimize_support(p1, R1, g1p, axis1_flat, p2, R2, g2p, axis2_flat,
                     iters: int = 32, u0=None):
    """Minimize f over S^2 with the kink-aware candidate set.
    axis_i_flat: static bool, shape i has a flat axis (its local z).
    u0: optional warm-start directions; lanes with u0 ~ 0 reseed from the
    center line. Returns (u*, f*, s1*, s2*)."""
    pair = _Pair(p1, R1, g1p, p2, R2, g2p)
    # start pointing geom1 -> geom2; the fixed jitter breaks exactly
    # axis-aligned stationary starts
    jit = torch.tensor([1e-7, 2e-7, 3e-7], dtype=pair.c.dtype,
                       device=pair.c.device)[:, None]
    u0c = -pair.c + jit
    if u0 is not None:
        has_warm = torch.sum(u0 * u0, dim=-2, keepdim=True) > 0.25
        u0 = torch.where(has_warm, u0, u0c)
    else:
        u0 = u0c

    cands = [_pgd(pair, u0, iters)]
    axes = []
    if axis1_flat:
        axes.append(R1[..., :, 2, :])
    if axis2_flat:
        axes.append(R2[..., :, 2, :])
    for a in axes:
        cands.append(_pgd(pair, u0, iters, proj_axis=a))
        for sgn in (1.0, -1.0):         # disk poles: direct evaluations
            u = sgn * a
            s1, s2 = pair.sup(u)
            cands.append((u, pair.f(u, s1, s2), s1, s2))
    if len(axes) == 2:
        x = torch.linalg.cross(axes[0], axes[1], dim=-2)
        xnorm = _n3(x)
        xn = x / xnorm
        degenerate = xnorm[..., 0, :] < 1e-5
        for sgn in (1.0, -1.0):
            u = sgn * xn
            s1, s2 = pair.sup(u)
            f = torch.where(degenerate, torch.full_like(xnorm[..., 0, :],
                                                        float("inf")),
                            pair.f(u, s1, s2))
            cands.append((u, f, s1, s2))

    bu, bf, bs1, bs2 = cands[0]
    for u, f, s1, s2 in cands[1:]:
        mk = f < bf
        mm = mk[..., None, :]
        bu = torch.where(mm, u, bu)
        bs1 = torch.where(mm, s1, bs1)
        bs2 = torch.where(mm, s2, bs2)
        bf = torch.where(mk, f, bf)

    # Riemannian Newton polish (two steps, accept-if-better)
    ell1, _ = pair.g1p
    ell2, _ = pair.g2p
    ex = torch.zeros_like(bu)
    ex[..., 0, :] = 1.0
    ey = torch.zeros_like(bu)
    ey[..., 1, :] = 1.0
    for _ in range(2):
        alt = torch.where(torch.abs(bu[..., 0:1, :]) < 0.5, ex, ey)
        t1 = torch.linalg.cross(bu, alt, dim=-2)
        t1 = t1 / _n3(t1)
        t2 = torch.linalg.cross(bu, t1, dim=-2)
        g = bs1 - bs2
        g1_ = torch.sum(g * t1, dim=-2)
        g2_ = torch.sum(g * t2, dim=-2)
        a11a, a12a, a22a = _ell_hess_quad(pair.R1, ell1, bu, t1, t2)
        a11b, a12b, a22b = _ell_hess_quad(pair.R2, ell2, bu, t1, t2)
        h11 = a11a + a11b - bf
        h12 = a12a + a12b
        h22 = a22a + a22b - bf
        det = h11 * h22 - h12 * h12
        ok = torch.abs(det) > 1e-20
        det = torch.where(ok, det, torch.ones_like(det))
        x1 = (-g1_ * h22 + g2_ * h12) / det
        x2 = (-g2_ * h11 + g1_ * h12) / det
        sn = torch.sqrt(x1 * x1 + x2 * x2) + 1e-30
        sc = torch.where(sn > 0.2, 0.2 / sn, torch.ones_like(sn)) * ok
        u_c = (bu + (x1 * sc)[..., None, :] * t1
               + (x2 * sc)[..., None, :] * t2)
        u_c = u_c / _n3(u_c)
        s1c, s2c = pair.sup(u_c)
        f_c = pair.f(u_c, s1c, s2c)
        mk = f_c < bf
        mm = mk[..., None, :]
        bu = torch.where(mm, u_c, bu)
        bs1 = torch.where(mm, s1c, bs1)
        bs2 = torch.where(mm, s2c, bs2)
        bf = torch.where(mk, f_c, bf)
    return bu, bf, bs1, bs2


def _refine_witnesses(u, s1, s2, p1, R1, g1p, p2, R2, g2p):
    """Center the witness pair on non-unique support sets (segment flats,
    cylinder faces) with a short alternating-projection pass, clamping
    around the support-set center."""
    tol = 1e-5

    def sup_set(p, R, gp, u_world, s_w, other):
        ell, seg_h = gp
        ul = _mT(R, u_world)
        un = _n3(ul)
        zaxis = R[..., :, 2, :]
        flat_z = torch.abs(ul[..., 2:3, :]) < tol * un
        w_seg = torch.where(flat_z, seg_h, torch.zeros_like(seg_h))
        disk = ((ell[..., 0:1, :] > 0) & (ell[..., 2:3, :] <= 0)
                & (torch.sqrt(ul[..., 0:1, :] ** 2 + ul[..., 1:2, :] ** 2)
                   < tol * un))
        w_disk = torch.where(disk, ell[..., 0:1, :],
                             torch.zeros_like(ell[..., 0:1, :]))
        rad_dir = other - s_w
        rad_dir = rad_dir - _dot(rad_dir, zaxis) * zaxis
        rad_dir = rad_dir / _n3(rad_dir)
        use_disk = w_disk > w_seg
        dvec = torch.where(use_disk, rad_dir, zaxis)
        w = torch.maximum(w_disk, w_seg)
        ax = _dot(s_w - p, zaxis)
        c_seg = s_w - ax * zaxis
        c_disk = p + ax * zaxis
        c = torch.where(use_disk, c_disk, c_seg)
        c = torch.where(w > 0, c, s_w)
        return dvec, w, c

    d1, w1, c1 = sup_set(p1, R1, g1p, u, s1, s2)
    d2, w2, c2 = sup_set(p2, R2, g2p, -u, s2, s1)
    d1 = d1 - _dot(d1, u) * u
    d2 = d2 - _dot(d2, u) * u
    n1 = _n3(d1)
    n2 = _n3(d2)
    w1 = torch.where(n1 > 1e-9, w1, torch.zeros_like(w1))
    w2 = torch.where(n2 > 1e-9, w2, torch.zeros_like(w2))
    d1 = d1 / n1
    d2 = d2 / n2

    def clamp_seg(c0, dvec, w, x):
        t = torch.minimum(torch.maximum(_dot(x - c0, dvec), -w), w)
        return c0 + t * dvec

    x1, x2 = c1, c2
    for _ in range(6):
        x1 = clamp_seg(c1, d1, w1, x2)
        x2 = clamp_seg(c2, d2, w2, x1)
    return x1, x2


def manifold_nu(u, dist, R1, param1, R2, param2):
    """Manifold multiplicity of MuJoCo's native convex collider, folded
    into the contact row's regularizer (nu coincident contacts == one row
    at invw/nu): 1 when a smooth shape is involved, 3 for two active flat
    features, 4 when a cylinder face is active; narrow crossed clusters
    collapse back to 1 below |dist| ~ 0.2 R_flat. Returns (..., B)."""
    ell1, seg1, r1, _ = param1
    ell2, seg2, r2, _ = param2

    def feats(R, ell, seg, rad):
        a = R[..., :, 2, :]
        c = torch.abs(_dot(a, u))[..., 0, :]
        disk = (ell[..., 0, :] > 0) & (ell[..., 2, :] <= 0)
        has_seg = seg[..., 0, :] > 0
        side = has_seg & (c < 0.02)
        face = disk & (c > 0.999)
        rim = disk & ~face & ~side
        flat = side | face | rim
        rflat = torch.where(disk, ell[..., 0, :], rad[..., 0, :])
        return flat, face, side, rflat, a

    flat1, face1, side1, rf1, a1 = feats(R1, ell1, seg1, r1)
    flat2, face2, side2, rf2, a2 = feats(R2, ell2, seg2, r2)
    both = flat1 & flat2
    any_face = face1 | face2
    zero = torch.zeros_like(dist)
    rmax = torch.maximum(torch.where(flat1, rf1, zero),
                         torch.where(flat2, rf2, zero))
    cx = torch.linalg.cross(a1, a2, dim=-2)
    parallel = torch.sum(cx * cx, dim=-2) < 0.09
    wide = (side1 & side2 & parallel) | any_face
    keep = both & (dist < 0.0) & (wide | (-dist < 0.2 * rmax))
    nu = torch.where(keep, torch.where(any_face, 4.0 + zero, 3.0 + zero),
                     1.0 + zero)
    return nu


def narrowphase(p1, R1, param1, p2, R2, param2, iters: int = 32,
                refine: bool = True, u0=None, with_nu: bool = False):
    """Full convex narrowphase for a batch of lanes.

    param_i = (ell (...,3,1|B), seg (...,1,1|B), radius (...,1,1|B),
    axis_flat: bool). Returns (dist (..., B), pos (..., 3, B),
    normal (..., 3, B)) with the normal pointing from geom1 toward geom2;
    with ``with_nu`` also the manifold multiplicity."""
    ell1, seg1, r1, ax1 = param1
    ell2, seg2, r2, ax2 = param2
    g1p = (ell1, seg1)
    g2p = (ell2, seg2)
    u, f, s1, s2 = minimize_support(p1, R1, g1p, ax1, p2, R2, g2p, ax2,
                                    iters, u0=u0)
    if refine:
        s1, s2 = _refine_witnesses(u, s1, s2, p1, R1, g1p, p2, R2, g2p)
    dist = -f - (r1 + r2)[..., 0, :]
    x1 = s1 + r1 * u
    x2 = s2 - r2 * u
    pos = 0.5 * (x1 + x2)
    if with_nu:
        return dist, pos, u, manifold_nu(u, dist, R1, param1, R2, param2)
    return dist, pos, u


def geom_core_params(gtype: int, size) -> np.ndarray:
    """Static [ell(3), seg(1), radius(1), axis_flat(1)] for a geom."""
    from benchmark.reference.physics import types as T
    s = np.asarray(size, np.float64)
    out = np.zeros(6)
    if gtype == T.GEOM_SPHERE:
        out[4] = s[0]
    elif gtype == T.GEOM_CAPSULE:
        out[4] = s[0]
        out[3] = s[1]
        out[5] = 1.0
    elif gtype == T.GEOM_ELLIPSOID:
        out[0:3] = s[:3]
    elif gtype == T.GEOM_CYLINDER:
        out[0] = out[1] = s[0]
        out[3] = s[1]
        out[5] = 1.0
    else:
        raise NotImplementedError(f"ccd geom type {gtype}")
    return out
