"""Collision detection: static candidate pairs + batched narrowphase.

The broadphase is static: the candidate pair list is enumerated once from
the model (contype/conaffinity, weld and parent-child exclusion, explicit
excludes) and grouped by geom type pair. Each group is one batched closed
form over (pairs, ..., B); every candidate pair owns fixed contact slots.
Ellipsoid/cylinder pairs go through the gated exact narrowphase in
physics/ccd.py (``_ccd_stage``).

Selection keeps the top-K contacts per condim group by effective distance.
The JAX package moves the selected rows with one-hot contractions (a TPU
idiom); here they are per-env index gathers (ops/rows), and the top-K is a
stable sort so ties resolve to the lower index exactly as ``lax.top_k``.

Analytic pair functions ported: sphere-sphere, sphere-capsule and
capsule-capsule (the pairs of the walk_on_ball model), plane-sphere,
plane-capsule, plane-ellipsoid and plane-cylinder (the floor pairs of
walk_imitation), heightfield-sphere, -capsule, -ellipsoid and -cylinder
(the terrain pairs of vision_guided_flight and the rat's arenas), and
plane-box, sphere-box and capsule-box (the rat's skull and jaw boxes).
The heightfield makers read the model's terrain, so ``_dispatch`` takes
the model. Every pair of the JAX package is ported; ``_dispatch`` raises
NotImplementedError for a pair neither package has.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.math.consts import literal
from flybody_tpu_torch.ops import rows
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.io_mj import PAIR_NCON
from flybody_tpu_torch.physics.types import Contact, Data, Model


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-2, keepdim=True))


def _dot(a, b):
    return torch.sum(a * b, dim=-2, keepdim=True)


def make_frame(n):
    """Orthonormal frame rows (k, 3, 3, B) from unit normals (k, 3, B)."""
    ex = torch.zeros_like(n)
    ex[..., 0, :] = 1.0
    ey = torch.zeros_like(n)
    ey[..., 1, :] = 1.0
    a = torch.where(torch.abs(n[..., 0:1, :]) < 0.5, ex, ey)
    t1 = bq.cross(n, a)
    t1 = t1 / torch.clamp(_norm(t1), min=1e-12)
    t2 = bq.cross(n, t1)
    return torch.stack([n, t1, t2], dim=-3)


# Each narrowphase fn: (p1, M1, s1, p2, M2, s2) with p (P, 3, B),
# M (P, 3, 3, B), s (P, 3, 1|B) -> (dist (P, k, B), pos (P, k, 3, B),
# normal (P, k, 3, B)) with k static contacts per pair.


def _plane_sphere(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2, :]                       # plane z axis (P, 3, B)
    dctr = _dot(n, p2 - p1)[..., 0, :]         # (P, B)
    dist = dctr - s2[..., 0, :]
    pos = p2 - n * (s2[..., 0:1, :] + 0.5 * dist[..., None, :])
    return dist[:, None], pos[:, None], n[:, None]


def _plane_capsule(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2, :]
    axis = m2[..., :, 2, :]
    r = s2[..., 0:1, :]
    hl = s2[..., 1:2, :]
    dists, poss = [], []
    for sgn in (1.0, -1.0):
        c = p2 + sgn * hl * axis
        dd = _dot(n, c - p1) - r
        dists.append(dd[..., 0, :])
        poss.append(c - n * (r + 0.5 * dd))
    return (torch.stack(dists, dim=1), torch.stack(poss, dim=1),
            torch.stack([n, n], dim=1))


def _plane_ellipsoid(p1, m1, s1, p2, m2, s2):
    n = m1[..., :, 2, :]
    nl = bq.matvec_t(m2, n)                    # (P, 3, B)
    support_l = -(s2 * s2 * nl) / torch.clamp(_norm(s2 * nl), min=1e-12)
    sp = p2 + bq.matvec(m2, support_l)
    dd = _dot(n, sp - p1)
    pos = sp - 0.5 * dd * n
    return dd[..., 0, :][:, None], pos[:, None], n[:, None]


def _plane_cylinder(p1, m1, s1, p2, m2, s2):
    """Plane vs cylinder: deepest rim points of both caps + one extra
    lower-cap rim point (stabilizes the near-upright case)."""
    n = m1[..., :, 2, :]
    a = m2[..., :, 2, :]
    r = s2[..., 0:1, :]
    h = s2[..., 1:2, :]
    na = _dot(n, a)
    u = n - na * a
    u_norm = _norm(u)
    # an upright cylinder has no deepest rim direction: any unit vector
    # normal to the axis (both branches evaluated, as in the JAX package)
    ex = torch.zeros_like(a)
    ex[..., 0, :] = 1.0
    ey = torch.zeros_like(a)
    ey[..., 1, :] = 1.0
    alt = torch.where(torch.abs(a[..., 0:1, :]) < 0.5, ex, ey)
    alt = alt - _dot(alt, a) * a
    alt = alt / torch.clamp(_norm(alt), min=1e-12)
    u = torch.where(u_norm > 1e-9, u / torch.clamp(u_norm, min=1e-12), alt)
    w = bq.cross(a, u)
    sgn = torch.where(na > 0, -torch.ones_like(na), torch.ones_like(na))
    c_low = p2 + sgn * h * a
    c_high = p2 - sgn * h * a
    pts = torch.stack([
        c_low - r * u,
        c_high - r * u,
        c_low - r * (-0.5 * u + 0.8660254 * w),
    ], dim=1)                                   # (P, 3pts, 3, B)
    dd = torch.sum(pts * n[:, None], dim=-2) - _dot(p1, n)  # (P, 3pts, B)
    pos = pts - 0.5 * dd[..., None, :] * n[:, None]
    return dd, pos, n[:, None].expand(pts.shape)


_BOX_CORNERS = tuple((sx, sy, sz) for sx in (-1., 1.)
                     for sy in (-1., 1.) for sz in (-1., 1.))


def _plane_box(p1, m1, s1, p2, m2, s2):
    """Plane vs box: the 4 deepest of the box's 8 corners, by a stable
    sort (a box lying flat has exact ties; the lower corner index goes
    first, as in the JAX package's argsort)."""
    n = m1[..., :, 2, :]
    corners = literal(_BOX_CORNERS, p2.dtype, p2.device)
    corner_l = corners[None, :, :, None] * s2[:, None]      # (P, 8, 3, .)
    pts = p2[:, None] + bq.matvec(m2[:, None], corner_l)    # (P, 8, 3, B)
    dd = torch.sum(pts * n[:, None], dim=-2) - _dot(p1, n)  # (P, 8, B)
    idx = torch.argsort(dd, dim=1, stable=True)[:, :4]      # (P, 4, B)
    d4 = torch.gather(dd, 1, idx)
    pos8 = pts - 0.5 * dd[..., None, :] * n[:, None]
    pos = torch.gather(pos8, 1, idx[:, :, None].expand(-1, -1, 3, -1))
    return d4, pos, n[:, None].expand(pos.shape)


def _sphere_sphere(p1, m1, s1, p2, m2, s2):
    dvec = p2 - p1
    L = _norm(dvec)
    n = dvec / torch.clamp(L, min=1e-12)
    dist = (L - s1[..., 0:1, :] - s2[..., 0:1, :])[..., 0, :]
    pos = p1 + n * (s1[..., 0:1, :] + 0.5 * dist[..., None, :])
    return dist[:, None], pos[:, None], n[:, None]


def _closest_on_seg(p, a, b):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    return a + torch.clamp(t, 0.0, 1.0) * ab


def _zero_r(s):
    return torch.cat([s[..., 0:1, :], torch.zeros_like(s[..., 1:, :])],
                     dim=-2)


def _sphere_capsule(p1, m1, s1, p2, m2, s2):
    axis = m2[..., :, 2, :]
    hl = s2[..., 1:2, :]
    c = _closest_on_seg(p1, p2 - hl * axis, p2 + hl * axis)
    return _sphere_sphere(p1, m1, s1, c, m2, _zero_r(s2))


def _sphere_box(p1, m1, s1, p2, m2, s2):
    """Sphere vs box in the box frame: outside, the nearest box point;
    inside, the face of least penetration (the first of equal ones, as
    argmin in both libraries), its sign that of the centre's coordinate
    (sign(c + 1e-30), so a centre on the mid-plane takes +)."""
    r = s1[..., 0:1, :]
    c = bq.matvec_t(m2, p1 - p2)
    q = torch.minimum(torch.maximum(c, -s2), s2)
    dvec = c - q
    L = _norm(dvec)
    outside = L > 1e-9
    pen = s2 - torch.abs(c)                               # (P, 3, B)
    amin = torch.argmin(pen, dim=-2, keepdim=True)        # (P, 1, B)
    pen_min = torch.gather(pen, -2, amin)
    sgn = torch.sign(torch.gather(c, -2, amin) + 1e-30)
    onehot = (torch.arange(3, device=c.device)[None, :, None]
              == amin).to(c.dtype)
    n_in = onehot * sgn
    n_local = torch.where(outside, dvec / torch.clamp(L, min=1e-12), n_in)
    dist = torch.where(outside[..., 0, :], (L - r)[..., 0, :],
                       -(pen_min + r)[..., 0, :])
    q_surf = torch.where(outside, q, c + n_in * pen_min)
    n = bq.matvec(m2, n_local)
    pos_w = p2 + bq.matvec(m2, q_surf)
    pos = pos_w + 0.5 * dist[..., None, :] * (-n)
    return dist[:, None], pos[:, None], (-n)[:, None]


def _capsule_box(p1, m1, s1, p2, m2, s2):
    """Capsule vs box: sphere-box at both caps and at the segment point
    nearest the box centre; the 2 deepest of the 3, by a stable sort."""
    axis = m1[..., :, 2, :]
    hl = s1[..., 1:2, :]
    rs = _zero_r(s1)
    e1, e2 = p1 - hl * axis, p1 + hl * axis
    mid = _closest_on_seg(p2, e1, e2)
    outs = [_sphere_box(c, m1, rs, p2, m2, s2) for c in (e1, e2, mid)]
    d3 = torch.stack([o[0][:, 0] for o in outs], dim=1)   # (P, 3, B)
    idx = torch.argsort(d3, dim=1, stable=True)[:, :2]
    idx3 = idx[:, :, None].expand(-1, -1, 3, -1)
    pos = torch.gather(torch.stack([o[1][:, 0] for o in outs], dim=1), 1,
                       idx3)
    nrm = torch.gather(torch.stack([o[2][:, 0] for o in outs], dim=1), 1,
                       idx3)
    return torch.gather(d3, 1, idx), pos, nrm


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
    a1 = m1[..., :, 2, :] * s1[..., 1:2, :]
    a2 = m2[..., :, 2, :] * s2[..., 1:2, :]
    P1, Q1 = p1 - a1, p1 + a1
    P2, Q2 = p2 - a2, p2 + a2
    d1 = Q1 - P1
    d2 = Q2 - P2
    r = P1 - P2
    A = _dot(d1, d1)
    E = _dot(d2, d2)
    Bc = _dot(d1, d2)
    C = _dot(d1, r)
    F = _dot(d2, r)
    denom = torch.clamp(A * E - Bc * Bc, min=1e-12)
    s = torch.clamp((Bc * F - C * E) / denom, 0.0, 1.0)
    t = torch.clamp((Bc * s + F) / torch.clamp(E, min=1e-12), 0.0, 1.0)
    s = torch.clamp((Bc * t - C) / torch.clamp(A, min=1e-12), 0.0, 1.0)
    c1 = P1 + s * d1
    c2 = P2 + t * d2
    return _sphere_sphere(c1, m1, _zero_r(s1), c2, m2, _zero_r(s2))


def _hfield_height_normal(m: Model, hid: int, xy_local, size):
    """Bilinear height and unit normal of heightfield ``hid`` in its local
    frame at xy_local (P, 2, B) -> (h (P, B), n (P, 3, B)). The cell index
    is clamped after the cast as well, so a NaN position reads a valid
    cell (and stays NaN) instead of indexing out of range."""
    data = m.hfield_data[hid]
    nr, nc = m.hfield_nrow, m.hfield_ncol
    sx, sy, zt = size[0], size[1], size[2]
    fx = (xy_local[..., 0, :] / sx + 1.0) * 0.5 * (nc - 1)
    fy = (xy_local[..., 1, :] / sy + 1.0) * 0.5 * (nr - 1)
    fx = torch.clamp(fx, 0.0, nc - 1.001)
    fy = torch.clamp(fy, 0.0, nr - 1.001)
    ix = torch.floor(fx).long().clamp(0, nc - 2)
    iy = torch.floor(fy).long().clamp(0, nr - 2)
    tx, ty = fx - ix.to(fx.dtype), fy - iy.to(fy.dtype)
    h00 = data[iy, ix]
    h01 = data[iy, ix + 1]
    h10 = data[iy + 1, ix]
    h11 = data[iy + 1, ix + 1]
    h = ((1 - ty) * ((1 - tx) * h00 + tx * h01)
         + ty * ((1 - tx) * h10 + tx * h11)) * zt
    dx = (((1 - ty) * (h01 - h00) + ty * (h11 - h10)) * zt
          / (2.0 * sx / (nc - 1)))
    dy = (((1 - tx) * (h10 - h00) + tx * (h11 - h01)) * zt
          / (2.0 * sy / (nr - 1)))
    n = torch.stack([-dx, -dy, torch.ones_like(dx)], dim=-2)
    return h, n / _norm(n)


def _make_hfield_sphere(m: Model, hid: int):
    def fn(p1, m1, s1, p2, m2, s2):
        local = bq.matvec_t(m1, p2 - p1)
        h, nl = _hfield_height_normal(m, hid, local[..., :2, :],
                                      m.hfield_size[hid])
        n = bq.matvec(m1, nl)
        dist = (local[..., 2, :] - h) * nl[..., 2, :] - s2[..., 0, :]
        pos = p2 - n * (s2[..., 0:1, :] + 0.5 * dist[..., None, :])
        return dist[:, None], pos[:, None], n[:, None]
    return fn


def _hfield_tangent_plane(m: Model, hid: int, p1, m1, xy):
    """World-space tangent plane (anchor point, unit normal) of the
    heightfield at the local footprint xy (P, 2, B)."""
    h, nl = _hfield_height_normal(m, hid, xy, m.hfield_size[hid])
    n = bq.matvec(m1, nl)
    anchor_l = torch.cat([xy, h[..., None, :]], dim=-2)
    return p1 + bq.matvec(m1, anchor_l), n


def _make_hfield_ellipsoid(m: Model, hid: int):
    """Heightfield vs ellipsoid on the local tangent plane with two support
    refinements: the bilinear surface under the ellipsoid's deepest point,
    then the analytic plane-ellipsoid form there. Exact where the terrain
    is flat at the geom's footprint scale (the sine terrains' wavelengths
    are far above the fly's geom sizes)."""

    def fn(p1, m1, s1, p2, m2, s2):
        xy = bq.matvec_t(m1, p2 - p1)[..., :2, :]
        sp = p2
        for _ in range(2):
            _, n = _hfield_tangent_plane(m, hid, p1, m1, xy)
            nloc = bq.matvec_t(m2, n)
            sup_l = -(s2 * s2 * nloc) / torch.clamp(_norm(s2 * nloc),
                                                    min=1e-12)
            sp = p2 + bq.matvec(m2, sup_l)
            xy = bq.matvec_t(m1, sp - p1)[..., :2, :]
        anchor, n = _hfield_tangent_plane(m, hid, p1, m1, xy)
        dd = _dot(n, sp - anchor)
        pos = sp - 0.5 * dd * n
        return dd[..., 0, :][:, None], pos[:, None], n[:, None]

    return fn


def _make_hfield_cylinder(m: Model, hid: int):
    """Heightfield vs cylinder: the tangent plane at the footprint, the
    plane-cylinder three-point rim manifold, then once more at the
    deepest witness (the same regime as _make_hfield_ellipsoid)."""

    def plane_pts(p1, m1, s1, p2, m2, s2, xy):
        anchor, n = _hfield_tangent_plane(m, hid, p1, m1, xy)
        frame = make_frame(n)                  # rows (n, t1, t2)
        # a frame whose z column is n, as _plane_cylinder reads a plane's
        fake_m = torch.stack([frame[..., 1, :, :], frame[..., 2, :, :],
                              frame[..., 0, :, :]], dim=-2)
        return _plane_cylinder(anchor, fake_m, s1, p2, m2, s2)

    def fn(p1, m1, s1, p2, m2, s2):
        xy = bq.matvec_t(m1, p2 - p1)[..., :2, :]
        dd, pos, _ = plane_pts(p1, m1, s1, p2, m2, s2, xy)
        deepest = torch.argmin(dd, dim=1, keepdim=True)      # (P, 1, B)
        idx = deepest[:, :, None, :].expand(-1, -1, 3, -1)
        psel = torch.gather(pos, 1, idx)[:, 0]               # (P, 3, B)
        xy = bq.matvec_t(m1, psel - p1)[..., :2, :]
        return plane_pts(p1, m1, s1, p2, m2, s2, xy)

    return fn


def _make_hfield_capsule(m: Model, hid: int):
    sph = _make_hfield_sphere(m, hid)

    def fn(p1, m1, s1, p2, m2, s2):
        axis = m2[..., :, 2, :]
        hl = s2[..., 1:2, :]
        outs = [sph(p1, m1, s1, p2 + sgn * hl * axis, m2, _zero_r(s2))
                for sgn in (1.0, -1.0)]
        return tuple(torch.cat([o[i] for o in outs], dim=1)
                     for i in range(3))
    return fn


_PAIR_FN = {
    (T.GEOM_PLANE, T.GEOM_SPHERE): _plane_sphere,
    (T.GEOM_PLANE, T.GEOM_CAPSULE): _plane_capsule,
    (T.GEOM_PLANE, T.GEOM_ELLIPSOID): _plane_ellipsoid,
    (T.GEOM_PLANE, T.GEOM_CYLINDER): _plane_cylinder,
    (T.GEOM_PLANE, T.GEOM_BOX): _plane_box,
    (T.GEOM_SPHERE, T.GEOM_SPHERE): _sphere_sphere,
    (T.GEOM_SPHERE, T.GEOM_CAPSULE): _sphere_capsule,
    (T.GEOM_SPHERE, T.GEOM_BOX): _sphere_box,
    (T.GEOM_CAPSULE, T.GEOM_CAPSULE): _capsule_capsule,
    (T.GEOM_CAPSULE, T.GEOM_BOX): _capsule_box,
}


# heightfield pair makers, by the other geom's type (heightfield 0, as in
# the JAX package)
_HFIELD_MAKERS = {
    T.GEOM_SPHERE: _make_hfield_sphere,
    T.GEOM_CAPSULE: _make_hfield_capsule,
    T.GEOM_ELLIPSOID: _make_hfield_ellipsoid,
    T.GEOM_CYLINDER: _make_hfield_cylinder,
}


def _dispatch(m: Model, t1: int, t2: int):
    fn = _PAIR_FN.get((t1, t2))
    if fn is not None:
        return fn
    if t1 == T.GEOM_HFIELD and t2 in _HFIELD_MAKERS:
        return _HFIELD_MAKERS[t2](m, 0)
    raise NotImplementedError(f"collision pair {(t1, t2)}")


@dataclasses.dataclass(frozen=True, eq=False)
class SlotLayout:
    """A model's contact slots (``slot_layout``): pair k owns the analytic
    slots ``slot_of_pair[k]:slot_of_pair[k + 1]`` (PAIR_NCON of its type
    pair), the convex narrowphase's pair i the slot ncon_max + i. Per
    analytic slot: geoms, bodies, ``typ`` (its type pair's index in
    ``groups``) and ``sub`` (its sub-contact); ``cand_*`` run over every
    candidate slot, the analytic then the convex ones."""

    groups: dict             # {(t1, t2): pair ids}, first-occurrence order
    slot_of_pair: np.ndarray
    g1: np.ndarray; g2: np.ndarray; b1: np.ndarray; b2: np.ndarray
    typ: np.ndarray; sub: np.ndarray
    cand_g1: np.ndarray; cand_g2: np.ndarray
    cand_b1: np.ndarray; cand_b2: np.ndarray
    group_ix: tuple          # per group: (geom1, geom2, slots) tensors
    condim_slots: dict       # {condim: slots tensor}
    condim_typ: dict         # {condim: ((typ, (t1, t2)) among its slots)}


def _slot_layout(m: Model) -> SlotLayout:
    pt = [tuple(t) for t in np.asarray(m.pair_type).reshape(-1, 2).tolist()]
    keys = list(dict.fromkeys(pt))                 # first-occurrence order
    groups = {t: np.array([k for k, u in enumerate(pt) if u == t])
              for t in keys}
    typ_of_pair = np.array([keys.index(t) for t in pt], np.int64)
    n = np.array([PAIR_NCON[t] for t in pt], np.int64)
    slot_of_pair = np.concatenate([[0], np.cumsum(n)])
    pair = np.repeat(np.arange(len(pt)), n)        # each slot's pair
    pg1 = np.asarray(m.pair_geom1, np.int64)
    pg2 = np.asarray(m.pair_geom2, np.int64)
    g1, g2, typ = pg1[pair], pg2[pair], typ_of_pair[pair]
    gb = np.asarray(m.geom_bodyid, np.int64)
    con_dim = np.asarray(m.con_dim)
    cond = {int(cd): np.flatnonzero(con_dim == cd)
            for cd in np.unique(con_dim)}
    cat = lambda a, b: np.concatenate([a, np.asarray(b, np.int64)])
    return SlotLayout(
        groups=groups, slot_of_pair=slot_of_pair, g1=g1, g2=g2,
        b1=gb[g1], b2=gb[g2], typ=typ,
        sub=np.arange(len(pair)) - slot_of_pair[pair],
        cand_g1=cat(g1, m.ccd_geom1), cand_g2=cat(g2, m.ccd_geom2),
        cand_b1=cat(gb[g1], m.ccd_b1), cand_b2=cat(gb[g2], m.ccd_b2),
        group_ix=tuple((m.ix(pg1[p]), m.ix(pg2[p]),
                        m.ix(np.flatnonzero(typ == tid)))
                       for tid, p in enumerate(groups.values())),
        condim_slots={cd: m.ix(s) for cd, s in cond.items()},
        condim_typ={cd: tuple((int(t), keys[t]) for t in np.unique(typ[s]))
                    for cd, s in cond.items()})


def slot_layout(m: Model) -> SlotLayout:
    """The model's contact-slot layout, built once per model."""
    return m.plan("slot_layout", _slot_layout)


def selected_force(d: Data, mask: torch.Tensor) -> torch.Tensor:
    """(B,) sum of the normal force magnitudes of the selected contacts
    whose candidate slot (``warm_sel``'s ids; -1 pads) has ``mask`` set
    (a bool per candidate slot)."""
    sel = d.warm_sel.long()
    flag = torch.where(sel >= 0, mask.to(d.qpos.dtype)[sel.clamp(min=0)],
                       torch.zeros((), dtype=d.qpos.dtype,
                                   device=sel.device))
    return torch.sum(torch.abs(d.warm_f[:, 0]) * flag, dim=0)


def _narrowphase(m: Model, d: Data):
    """All candidate pairs -> per-slot (dist (ncon, B), pos (ncon, 3, B),
    normal (ncon, 3, B))."""
    lay = slot_layout(m)
    B = d.qpos.shape[-1]
    ncon = m.ncon_max
    dist = d.qpos.new_full((ncon, B), 1e10)
    pos = d.qpos.new_zeros((ncon, 3, B))
    nrm = d.qpos.new_zeros((ncon, 3, B))
    nrm[:, 2] = 1.0
    for (t1, t2), (pg1, pg2, slots) in zip(lay.groups, lay.group_ix):
        fn = _dispatch(m, t1, t2)
        dd, pp, nn = fn(d.geom_xpos[pg1], d.geom_xmat[pg1],
                        m.geom_size[pg1][..., None],
                        d.geom_xpos[pg2], d.geom_xmat[pg2],
                        m.geom_size[pg2][..., None])
        dist[slots] = dd.reshape(-1, B)
        pos[slots] = pp.reshape(-1, 3, B)
        nrm[slots] = nn.reshape(-1, 3, B)
    return dist, pos, nrm


def _slot_table(m: Model):
    """(ncon, 12) per-slot static solver params [solref0, solref1, mu,
    invw, includemargin, marginfull, b1, b2, g1, g2, typ, sub] and the
    (ncon, 5) solimp block."""
    lay = slot_layout(m)
    invw = (m.body_invweight0[m.ix(lay.b1), 0]
            + m.body_invweight0[m.ix(lay.b2), 0])
    f = lambda x: m.const(np.asarray(x, np.float64))
    cols = torch.stack([
        m.con_solref[:, 0], m.con_solref[:, 1],
        m.con_friction[:, 0], invw, m.con_includemargin, m.con_margin,
        f(lay.b1), f(lay.b2), f(lay.g1), f(lay.g2), f(lay.typ),
        f(lay.sub)], dim=1)
    return cols, m.con_solimp


def ccd_gate(m: Model, d: Data, start: int, n: int) -> torch.Tensor:
    """Center-line support-gap gate for a ccd pair segment -> (n, B).

    d_gate = |c| - h1(u) - h2(-u) along the center line u: a lower bound
    of the signed distance (never wrongly excludes a pair)."""
    seg = slice(start, start + n)
    g1 = m.ix(np.asarray(m.ccd_geom1)[seg])
    g2 = m.ix(np.asarray(m.ccd_geom2)[seg])
    core = m.ccd_core[seg]                     # (n, 10)
    cc = d.geom_xpos[g2] - d.geom_xpos[g1]
    cn = torch.sqrt(torch.sum(cc * cc, dim=1, keepdim=True) + 1e-20)
    u = cc / cn

    def _h(R_g, u_world, half):                # support height along u
        ell = half[:, 0:3, None]
        sg = half[:, 3, None]
        r = half[:, 4, None]
        ul = torch.einsum("njiB,njB->niB", R_g, u_world)
        au = ell * ul
        an = torch.sqrt(torch.sum(au * au, dim=1) + 1e-20)
        return an + sg * torch.abs(ul[:, 2]) + r

    return (cn[:, 0] - _h(d.geom_xmat[g1], u, core[:, :5])
            - _h(d.geom_xmat[g2], -u, core[:, 5:]))


def _ccd_table(m: Model):
    """(nccd, 25) static per-pair ccd table: core (10), solref (2),
    solimp (5), mu, invw, includemargin, margin, b1, b2, g1, g2."""
    b1, b2 = np.asarray(m.ccd_b1), np.asarray(m.ccd_b2)
    invw = m.body_invweight0[m.ix(b1), 0] + m.body_invweight0[m.ix(b2), 0]
    f = lambda x: m.const(np.asarray(x, np.float64))[:, None]
    return torch.cat([
        m.ccd_core, m.ccd_solref, m.ccd_solimp, m.ccd_mu[:, None],
        invw[:, None], m.ccd_includemargin[:, None], m.ccd_margin[:, None],
        f(b1), f(b2), f(m.ccd_geom1), f(m.ccd_geom2)], dim=1)


def _geom_payload(m: Model, d: Data) -> torch.Tensor:
    """(ngeom, 12, B) per-geom [xpos, xmat] for per-lane gathers."""
    B = d.qpos.shape[-1]
    return torch.cat([d.geom_xpos, d.geom_xmat.reshape(m.ngeom, 9, B)],
                     dim=1)


def _lane_frames(payload, gg):
    f = rows.take(payload, gg)                 # (N, 12, B)
    N, _, B = f.shape
    return f[:, :3], f[:, 3:].reshape(N, 3, 3, B)


def _ccd_params(ts, ax1, ax2):
    mv = lambda sl: ts[:, sl]
    return ((mv(slice(0, 3)), mv(slice(3, 4)), mv(slice(4, 5)), ax1),
            (mv(slice(5, 8)), mv(slice(8, 9)), mv(slice(9, 10)), ax2))


def _ccd_stage(m: Model, d: Data):
    """Gated exact-convex narrowphase, per kink-structure class: the gate
    selects each class's lane budget per env, then the narrowphase
    (ops/ccd_kernel: the kernel on the card, physics/ccd on the CPU) runs
    with the class's static axis flags. Returns per-class row tuples in
    class order, matching the (3, budget) groups efc_meta appends."""
    from flybody_tpu_torch.ops import ccd_kernel
    tab_all = m.plan("ccd_table", _ccd_table)
    payload = _geom_payload(m, d)
    g1_all = np.asarray(m.ccd_geom1)
    g2_all = np.asarray(m.ccd_geom2)
    out = []
    off = 0
    for (ax1, ax2, start, n, N) in m.ccd_classes:
        seg = slice(start, start + n)
        db = ccd_gate(m, d, start, n)
        eff = db - m.ccd_includemargin[seg][:, None]
        idx = rows.smallest_k(eff, N)                      # (N, B)
        ts = rows.take_static(tab_all[seg], idx)           # (N, 25, B)
        p1, R1 = _lane_frames(payload, m.ix(g1_all[seg])[idx])
        p2, R2 = _lane_frames(payload, m.ix(g2_all[seg])[idx])
        prm1, prm2 = _ccd_params(ts, ax1, ax2)
        sel = (m.ncon_max + start + idx).to(torch.int32)

        # warm start: match this step's lanes to the previous substep's
        # lanes of the same class by slot id; unmatched lanes get u0 = 0
        # and reseed from the center line inside minimize_support, and so
        # does a lane whose previous direction is not finite (an env that
        # blew up and was auto-reset keeps its old warm start)
        u0 = None
        if d.ccd_warm_u.shape[0]:
            old_id = d.ccd_warm_id[off:off + N]            # (N, B)
            hit = sel[:, None, :] == old_id[None, :, :]    # (N, N, B)
            src = torch.argmax(hit.to(torch.int8), dim=1)  # (N, B)
            old_u = rows.take(d.ccd_warm_u[off:off + N], src)
            ok = hit.any(dim=1) & torch.isfinite(old_u).all(dim=1)
            u0 = torch.where(ok[:, None, :], old_u, torch.zeros_like(old_u))
        dist, pos, nrm, nu = ccd_kernel.narrowphase(
            p1, R1, prm1, p2, R2, prm2, iters=m.ccd_iters, u0=u0,
            with_nu=True)
        col = lambda i: ts[:, i]
        # manifold multiplicity folds into the row regularizer
        stat = torch.stack([col(10), col(11), col(17), col(18) / nu,
                            col(19), col(20), col(21), col(22), col(23),
                            col(24), torch.full_like(col(0), -1.0),
                            torch.zeros_like(col(0))], dim=1)
        out.append((dist, pos, nrm, stat, ts[:, 12:17], sel, ts))
        off += N
    return out


def _finish(m: Model, dist, pos, nrm, stat, simp, sel):
    """Contact from the selected rows' geometry and static columns."""
    from flybody_tpu_torch.physics.constraint import kbi
    ri = lambda x: torch.round(x).to(torch.int32)
    margin = stat[:, 4]
    invw = stat[:, 3]
    k_, b_, imp = kbi((stat[:, 0], stat[:, 1]),
                      tuple(simp[:, i] for i in range(5)), dist - margin,
                      tsmin=2.0 * m.opt.timestep)
    R = torch.clamp((1.0 - imp) / imp * invw, min=1e-12)
    return Contact(
        sel=sel, dist=dist, pos=pos, frame=make_frame(nrm), k=k_, b=b_, R=R,
        mu=stat[:, 2], invw=invw, margin=margin, marginfull=stat[:, 5],
        b1=ri(stat[:, 6]), b2=ri(stat[:, 7]), g1=ri(stat[:, 8]),
        g2=ri(stat[:, 9]), typ=ri(stat[:, 10]), sub=ri(stat[:, 11]),
        solref=stat[:, 0:2], solimp=simp)


def collision(m: Model, d: Data) -> Data:
    """Narrowphase + top-K active-island selection -> selected Contact,
    per condim group by effective distance (dist - includemargin)."""
    if m.ncon_max == 0 and m.ccd_budget == 0:
        return d
    from flybody_tpu_torch.physics.constraint import efc_meta
    meta = efc_meta(m)
    B = d.qpos.shape[-1]
    sel_l, dist_l, pos_l, nrm_l, stat_l, simp_l = [], [], [], [], [], []
    if m.ncon_max:
        dist_all, pos_all, nrm_all = _narrowphase(m, d)
        table, solimp_t = m.plan("slot_table", _slot_table)
        cond = slot_layout(m).condim_slots
    for cd, K in meta.analytic_groups:
        s_ix = cond[cd]
        dist_g = dist_all[s_ix]
        if s_ix.shape[0] > K:
            eff = dist_g - m.con_includemargin[s_ix][:, None]
            idx = rows.smallest_k(eff, K)                 # (K, B)
            dist_l.append(torch.gather(dist_g, 0, idx))
            pos_l.append(rows.take(pos_all[s_ix], idx))
            nrm_l.append(rows.take(nrm_all[s_ix], idx))
            stat_l.append(rows.take_static(table[s_ix], idx))
            simp_l.append(rows.take_static(solimp_t[s_ix], idx))
            sel_l.append(s_ix[idx].to(torch.int32))
        else:
            dist_l.append(dist_g)
            pos_l.append(pos_all[s_ix])
            nrm_l.append(nrm_all[s_ix])
            stat_l.append(table[s_ix][..., None].expand(-1, -1, B))
            simp_l.append(solimp_t[s_ix][..., None].expand(-1, -1, B))
            sel_l.append(s_ix[:, None].expand(-1, B).to(torch.int32))

    ccd_warm = None
    if m.ccd_budget > 0:
        parts = _ccd_stage(m, d)
        for (cds, cdp, cdn, cst, csi, csel, _) in parts:
            dist_l.append(cds)
            pos_l.append(cdp)
            nrm_l.append(cdn)
            stat_l.append(cst)
            simp_l.append(csi)
            sel_l.append(csel)
        ccd_warm = (torch.cat([p[5] for p in parts], dim=0),
                    torch.cat([p[2] for p in parts], dim=0),
                    torch.cat([p[6] for p in parts], dim=0))

    contact = _finish(m, torch.cat(dist_l), torch.cat(pos_l),
                      torch.cat(nrm_l), torch.cat(stat_l),
                      torch.cat(simp_l), torch.cat(sel_l))
    if ccd_warm is not None:
        return d.replace(contact=contact, ccd_warm_id=ccd_warm[0],
                         ccd_warm_u=ccd_warm[1].to(d.ccd_warm_u.dtype),
                         ccd_lane_tab=ccd_warm[2].to(d.ccd_lane_tab.dtype))
    return d.replace(contact=contact)


def collision_update(m: Model, d: Data) -> Data:
    """Geometry/impedance refresh for the already-selected contact lanes
    (the update substeps of the Model.col_refresh schedule): no gates, no
    top-K. Analytic lanes re-evaluate their type group's closed form on
    the lane's own geoms; ccd lanes rerun the convex narrowphase warm-
    started from their own previous direction; k/b/R are re-evaluated from
    the stored solref/solimp at the new penetration."""
    from flybody_tpu_torch.ops import ccd_kernel
    from flybody_tpu_torch.physics.constraint import efc_meta, kbi
    if m.ncon_max == 0 and m.ccd_budget == 0:
        return d
    meta = efc_meta(m)
    B = d.qpos.shape[-1]
    con = d.contact
    lay = slot_layout(m)
    payload = _geom_payload(m, d)

    dist_l, pos_l, nrm_l = [], [], []
    row = 0
    for cd, K in meta.analytic_groups:
        nr = min(K, lay.condim_slots[cd].shape[0])
        rs = slice(row, row + nr)
        row += nr
        lg1, lg2 = con.g1[rs], con.g2[rs]
        ltyp, lsub = con.typ[rs], con.sub[rs]
        p1, M1 = _lane_frames(payload, lg1)
        p2, M2 = _lane_frames(payload, lg2)
        s1 = rows.take_static(m.geom_size, lg1)
        s2 = rows.take_static(m.geom_size, lg2)
        dist = d.qpos.new_full((nr, B), 1e10)
        pos = d.qpos.new_zeros((nr, 3, B))
        nrm = d.qpos.new_zeros((nr, 3, B))
        nrm[:, 2] = 1.0
        for tid, key in lay.condim_typ[cd]:
            dd, pp, nn = _dispatch(m, *key)(p1, M1, s1, p2, M2, s2)
            is_t = ltyp == tid
            for j in range(PAIR_NCON[key]):
                msk = is_t & (lsub == j)
                dist = torch.where(msk, dd[:, j], dist)
                pos = torch.where(msk[:, None], pp[:, j], pos)
                nrm = torch.where(msk[:, None], nn[:, j], nrm)
        dist_l.append(dist)
        pos_l.append(pos)
        nrm_l.append(nrm)

    new_warm_u = None
    invw_ccd_l = []
    if m.ccd_budget > 0:
        warm_u_l = []
        off = 0
        for (ax1, ax2, start, n, N) in m.ccd_classes:
            ts = d.ccd_lane_tab[off:off + N].to(d.qpos.dtype)
            p1, R1 = _lane_frames(payload, torch.round(ts[:, 23]).long())
            p2, R2 = _lane_frames(payload, torch.round(ts[:, 24]).long())
            prm1, prm2 = _ccd_params(ts, ax1, ax2)
            u0 = d.ccd_warm_u[off:off + N].to(d.qpos.dtype)
            # warm-started from each lane's own previous direction
            cds, cdp, cdn, cnu = ccd_kernel.narrowphase(
                p1, R1, prm1, p2, R2, prm2,
                iters=max(4, m.ccd_iters - 3), u0=u0, with_nu=True)
            dist_l.append(cds)
            pos_l.append(cdp)
            nrm_l.append(cdn)
            warm_u_l.append(cdn)
            invw_ccd_l.append(ts[:, 18] / cnu)
            off += N
        new_warm_u = torch.cat(warm_u_l, dim=0)

    dist = torch.cat(dist_l, dim=0)
    pos = torch.cat(pos_l, dim=0)
    nrm = torch.cat(nrm_l, dim=0)
    invw = con.invw
    if invw_ccd_l:
        n_ccd = sum(x.shape[0] for x in invw_ccd_l)
        invw = torch.cat([con.invw[:-n_ccd]] + invw_ccd_l,
                         dim=0).to(con.invw.dtype)
    k_, b_, imp = kbi((con.solref[:, 0], con.solref[:, 1]),
                      tuple(con.solimp[:, i] for i in range(5)),
                      dist - con.margin, tsmin=2.0 * m.opt.timestep)
    R = torch.clamp((1.0 - imp) / imp * invw, min=1e-12)
    contact = con.replace(dist=dist, pos=pos, frame=make_frame(nrm),
                          k=k_, b=b_, R=R, invw=invw)
    if new_warm_u is not None:
        return d.replace(contact=contact,
                         ccd_warm_u=new_warm_u.to(d.ccd_warm_u.dtype))
    return d.replace(contact=contact)
