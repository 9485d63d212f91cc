"""Forward kinematics, com-frame quantities, and fixed tendons (batched).

The kinematic tree is processed level-parallel: all bodies at one depth are
updated in one batched quaternion pass, so the sequential depth of FK is
the tree height, not the body count. Semantics match MuJoCo's
mj_kinematics / mj_comPos / mj_tendon for free/ball/slide/hinge joints.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model


def joint_plan(m: Model) -> SimpleNamespace:
    """The model's joints by type, built once: ``scalar`` (hinge and slide)
    as (joint ids (numpy), qpos addresses, dof addresses), ``ball`` as
    (qpos quaternion, dof) blocks and ``free`` as (position, dof,
    quaternion, dof) blocks of index tensors, None if the model has none;
    ``dof_root``, each dof's com root body."""
    def build(m):
        jt = np.asarray(m.jnt_type)
        qadr, dadr = np.asarray(m.jnt_qposadr), np.asarray(m.jnt_dofadr)
        sj = np.flatnonzero((jt == T.HINGE) | (jt == T.SLIDE))
        ball, free = np.flatnonzero(jt == T.BALL), np.flatnonzero(jt == T.FREE)
        block = lambda adr, a, b: m.ix(adr[:, None] + np.arange(a, b))
        return SimpleNamespace(
            dof_root=m.ix(np.asarray(m.body_rootid)[m.dof_bodyid]),
            scalar=(sj, m.ix(qadr[sj]), m.ix(dadr[sj])),
            ball=(block(qadr[ball], 0, 4), block(dadr[ball], 0, 3))
            if len(ball) else None,
            free=(block(qadr[free], 0, 3), block(dadr[free], 0, 3),
                  block(qadr[free], 3, 7), block(dadr[free], 3, 6))
            if len(free) else None)
    return m.plan("joints", build)


def _kinematics_plan(m: Model):
    """Per tree level (bodies, parents, joint slots), each joint slot's
    index tensors and (L, 1, 1) masks (None where no body of the level
    has such a joint in that slot), and the (rows, joint ids) scatter of
    the slots' anchors and axes."""
    jnt_type, jnt_qposadr = np.asarray(m.jnt_type), np.asarray(m.jnt_qposadr)
    on = lambda mask, v: v if mask.any() else None
    c = lambda mask: m.const(mask)[:, None, None]
    levels, jids_all, valid_all = [], [], []
    for level in m.body_tree:
        lev = np.asarray(level)
        jntnum = np.asarray(m.body_jntnum)[lev]
        jntadr = np.asarray(m.body_jntadr)[lev]
        slots = []
        for slot in range(int(jntnum.max()) if len(lev) else 0):
            has = jntnum > slot
            jid = np.where(has, jntadr + slot, 0)  # 0 = safe pad
            jt = np.where(has, jnt_type[jid], -1)
            qadr = jnt_qposadr[jid]
            free, ball, slide = jt == T.FREE, jt == T.BALL, jt == T.SLIDE
            rot = ball | (jt == T.HINGE)
            blk = lambda a, b: m.ix(np.minimum(qadr[:, None]
                                               + np.arange(a, b), m.nq - 1))
            slots.append(SimpleNamespace(
                jid=m.ix(jid), qadr=m.ix(qadr),
                free=on(free, (blk(0, 3), blk(3, 7), c(free))),
                joint=on(rot | slide, c(rot | slide)),
                slide=on(slide, c(slide)),
                rot=on(rot, (blk(0, 4), c(ball), c(rot)))))
            jids_all.append(jid)
            valid_all.append(has & (jt >= 0))
        levels.append((m.ix(lev), m.ix(np.asarray(m.body_parentid)[lev]),
                       tuple(slots)))
    scatter = None
    if jids_all:
        jcat = np.concatenate(jids_all)
        vcat = np.concatenate(valid_all)
        scatter = (m.ix(np.flatnonzero(vcat)), m.ix(jcat[vcat]))
    return tuple(levels), scatter


def kinematics(m: Model, d: Data) -> Data:
    """mj_kinematics: body/geom/site frames from qpos."""
    B = d.qpos.shape[-1]
    nb = m.nbody
    levels, scatter = m.plan("kinematics", _kinematics_plan)

    xpos = d.qpos.new_zeros((nb, 3, B))
    xquat = d.qpos.new_zeros((nb, 4, B))
    xquat[:, 0] = 1.0
    anchors, axes = [], []

    for lev, pid, slots in levels:
        L = lev.shape[0]
        p_pos, p_quat = xpos[pid], xquat[pid]
        pos = p_pos + bq.rotate(m.body_pos[lev][..., None], p_quat)
        quat = bq.mult(p_quat, m.body_quat[lev][..., None])

        for s in slots:
            anchor = d.qpos.new_zeros((L, 3, B))
            axis_w = d.qpos.new_zeros((L, 3, B))

            if s.free is not None:
                q3i, q4i, fm = s.free
                q3, q4 = d.qpos[q3i], d.qpos[q4i]
                pos = torch.where(fm, q3, pos)
                quat = torch.where(fm, q4, quat)
                anchor = torch.where(fm, q3, anchor)
                zax = d.qpos.new_zeros((L, 3, B))
                zax[:, 2] = 1.0
                axis_w = torch.where(fm, zax, axis_w)

            if s.joint is not None:
                jpos = m.jnt_pos[s.jid][..., None]
                jaxis = m.jnt_axis[s.jid][..., None]
                anc = pos + bq.rotate(jpos, quat)
                axw = bq.rotate(jaxis, quat)

                if s.slide is not None:
                    delta = d.qpos[s.qadr] - m.qpos0[s.qadr][:, None]
                    pos = torch.where(s.slide, pos + axw * delta[:, None, :],
                                      pos)

                if s.rot is not None:
                    qb, is_ball, am = s.rot
                    angle = d.qpos[s.qadr] - m.qpos0[s.qadr][:, None]
                    qloc_h = bq.axis_angle(jaxis, angle)
                    qloc = torch.where(is_ball, d.qpos[qb], qloc_h)
                    new_quat = bq.mult(quat, qloc)
                    new_pos = anc - bq.rotate(jpos, new_quat)
                    quat = torch.where(am, new_quat, quat)
                    pos = torch.where(am, new_pos, pos)

                anchor = torch.where(s.joint, anc, anchor)
                axis_w = torch.where(s.joint, axw, axis_w)

            anchors.append(anchor)
            axes.append(axis_w)

        # normalize quats once per level to keep long chains stable
        quat = quat / torch.linalg.vector_norm(quat, dim=-2, keepdim=True)
        xpos[lev] = pos
        xquat[lev] = quat

    xanchor = d.qpos.new_zeros((m.njnt, 3, B))
    xaxis = d.qpos.new_zeros((m.njnt, 3, B))
    if scatter is not None:
        sel, jids = scatter
        xanchor[jids] = torch.cat(anchors, dim=0)[sel]
        xaxis[jids] = torch.cat(axes, dim=0)[sel]

    xmat = bq.to_mat(xquat)
    xipos = xpos + bq.rotate(m.body_ipos[..., None], xquat)
    ximat = bq.matmat(xmat, bq.to_mat(m.body_iquat[..., None]))

    gb = m.ix(m.geom_bodyid)
    geom_xpos = xpos[gb] + bq.rotate(m.geom_pos[..., None], xquat[gb])
    geom_xmat = bq.matmat(xmat[gb], bq.to_mat(m.geom_quat[..., None]))
    sb = m.ix(m.site_bodyid)
    site_xpos = xpos[sb] + bq.rotate(m.site_pos[..., None], xquat[sb])
    site_xmat = bq.matmat(xmat[sb], bq.to_mat(m.site_quat[..., None]))
    return d.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        xanchor=xanchor, xaxis=xaxis,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat,
        site_xpos=site_xpos, site_xmat=site_xmat,
    )


def spatial_inertia(m: Model, d: Data) -> torch.Tensor:
    """(nbody, 10, B) compact spatial inertia at the com-root origin, in
    MuJoCo's cinert layout: [Ixx Iyy Izz Ixy Ixz Iyz, mc(3), m]."""
    com_root = d.subtree_com[m.ix(m.body_rootid)]
    c = d.xipos - com_root                       # (nbody, 3, B)
    R = d.ximat                                  # (nbody, 3, 3, B)
    Ic = m.body_inertia[:, None, :, None]        # (nbody, 1, 3, 1)
    mass = m.body_mass[:, None, None]            # (nbody, 1, 1)
    RI = R * Ic
    c2 = torch.sum(c * c, dim=-2, keepdim=True)  # (nbody, 1, B)

    def entry(i, j):
        val = torch.sum(RI[:, i] * R[:, j], dim=-2)
        if i == j:
            return val + mass[..., 0] * (c2[:, 0] - c[:, i] * c[:, j])
        return val - mass[..., 0] * c[:, i] * c[:, j]

    comps = [entry(0, 0), entry(1, 1), entry(2, 2),
             entry(0, 1), entry(0, 2), entry(1, 2)]
    h = mass * c
    return torch.cat([torch.stack(comps, dim=1), h,
                      mass.expand(c[:, :1].shape)], dim=1)


def mul_inertia(cin: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Compact spatial inertia product: (..., 10, B) x (..., 6, B) motion
    -> (..., 6, B) force (torque, force)."""
    Ixx, Iyy, Izz = cin[..., 0, :], cin[..., 1, :], cin[..., 2, :]
    Ixy, Ixz, Iyz = cin[..., 3, :], cin[..., 4, :], cin[..., 5, :]
    h = cin[..., 6:9, :]
    mass = cin[..., 9:10, :]
    w = v[..., :3, :]
    u = v[..., 3:, :]
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    Iw = torch.stack([Ixx * wx + Ixy * wy + Ixz * wz,
                      Ixy * wx + Iyy * wy + Iyz * wz,
                      Ixz * wx + Iyz * wy + Izz * wz], dim=-2)
    torque = Iw + bq.cross(h, u)
    force = mass * u - bq.cross(h, w)
    return torch.cat([torque, force], dim=-2)


def com_pos(m: Model, d: Data) -> Data:
    """mj_comPos: subtree com, spatial inertias, com-frame dof axes."""
    from flybody_tpu_torch.physics.sensors import subtree_sum
    mom = m.body_mass[:, None, None] * d.xipos
    acc = subtree_sum(m, mom)
    denom = torch.clamp(m.body_subtreemass, min=1e-12)[:, None, None]
    subtree_com = acc / denom
    d = d.replace(subtree_com=subtree_com)
    cinert = spatial_inertia(m, d)

    jnt_of_dof = np.asarray(m.dof_jntid)
    body_of_dof = np.asarray(m.dof_bodyid)
    jt = np.asarray(m.jnt_type)[jnt_of_dof]
    com = subtree_com[joint_plan(m).dof_root]    # (nv, 3, B)
    anchor = d.xanchor[m.ix(jnt_of_dof)]
    axis = d.xaxis[m.ix(jnt_of_dof)]
    xmat_b = d.xmat[m.ix(body_of_dof)]           # (nv, 3, 3, B)

    dofadr = np.asarray(m.jnt_dofadr)[jnt_of_dof]
    k = np.arange(m.nv) - dofadr
    is_rot_local = (jt == T.BALL) | ((jt == T.FREE) & (k >= 3))
    is_slide = jt == T.SLIDE
    is_hinge = jt == T.HINGE

    e_world = m.const(np.eye(3)[np.clip(k, 0, 2)])[..., None]   # (nv, 3, 1)
    local_col = np.clip(np.where(jt == T.FREE, k - 3, k), 0, 2)
    e_local = xmat_b[m.ix(np.arange(m.nv)), :, m.ix(local_col)]  # (nv, 3, B)

    hinge = m.const(is_hinge)[:, None, None]
    rot_axis = torch.where(hinge, axis, e_local)
    rot_anchor = torch.where(hinge, anchor, d.xpos[m.ix(body_of_dof)])
    rot = m.const(is_rot_local | is_hinge)[:, None, None]
    ang = torch.where(rot, rot_axis, torch.zeros_like(axis))
    lin_rot = bq.cross(rot_axis, com - rot_anchor)
    lin = torch.where(rot, lin_rot,
                      torch.where(m.const(is_slide)[:, None, None], axis,
                                  e_world.expand(axis.shape)))
    cdof = torch.cat([ang, lin], dim=-2)         # (nv, 6, B)
    return d.replace(cdof=cdof, cinert=cinert)


def _tendon_map(m: Model):
    """Static (segment, coefficient (n, 1), joint qposadr, joint dofadr) of
    the fixed-tendon wrap list's entries."""
    ten_adr = np.asarray(m.ten_adr)
    ten_num = np.asarray(m.ten_num)
    wrap_jnt = np.asarray(m.wrap_jntid)
    seg = np.concatenate([np.full(ten_num[t], t) for t in range(m.ntendon)])
    widx = np.concatenate([np.arange(ten_adr[t], ten_adr[t] + ten_num[t])
                           for t in range(m.ntendon)])
    qadr = np.asarray(m.jnt_qposadr)[wrap_jnt[widx]]
    dadr = np.asarray(m.jnt_dofadr)[wrap_jnt[widx]]
    return (m.ix(seg), m.wrap_coef.reshape(-1)[m.ix(widx)][:, None],
            m.ix(qadr), m.ix(dadr))


def tendon(m: Model, d: Data) -> Data:
    """Fixed tendons: length = sum coef * qpos_joint (static sparse map)."""
    if m.ntendon == 0:
        return d
    seg, coefs, qadr, _ = m.plan("tendon_map", _tendon_map)
    vals = coefs * d.qpos[qadr]
    length = d.qpos.new_zeros((m.ntendon, d.qpos.shape[-1]))
    length.index_add_(0, seg, vals)
    return d.replace(ten_length=length)


def ten_moment_apply(m: Model, d: Data, frc: torch.Tensor) -> torch.Tensor:
    """qfrc (nv, B) from per-tendon forces frc (ntendon, B) via the static
    fixed-tendon moment map."""
    seg, coefs, _, dadr = m.plan("tendon_map", _tendon_map)
    out = torch.zeros_like(d.qvel)
    out.index_add_(0, dadr, coefs * frc[seg])
    return out


def ten_velocity_of(m: Model, d: Data) -> torch.Tensor:
    """(ntendon, B) tendon velocities via the static moment map."""
    seg, coefs, _, dadr = m.plan("tendon_map", _tendon_map)
    out = d.qvel.new_zeros((m.ntendon, d.qvel.shape[-1]))
    out.index_add_(0, seg, coefs * d.qvel[dadr])
    return out
