"""Forward kinematics, com-frame quantities, and fixed tendons (batched).

The kinematic tree is processed level-parallel: all bodies at one depth are
updated in one batched quaternion pass, so the sequential depth of FK is
the tree height, not the body count. Semantics match MuJoCo's
mj_kinematics / mj_comPos / mj_tendon for free/ball/slide/hinge joints.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model


def kinematics(m: Model, d: Data) -> Data:
    """mj_kinematics: body/geom/site frames from qpos."""
    B = d.qpos.shape[-1]
    nb = m.nbody
    jnt_type = np.asarray(m.jnt_type)
    jnt_qposadr = np.asarray(m.jnt_qposadr)
    parent = np.asarray(m.body_parentid)

    xpos = d.qpos.new_zeros((nb, 3, B))
    xquat = d.qpos.new_zeros((nb, 4, B))
    xquat[:, 0] = 1.0
    anchors, axes, jids_all, valid_all = [], [], [], []

    for level in m.body_tree:
        lev = np.asarray(level)
        L = len(lev)
        pid = m.ix(parent[lev])
        p_pos, p_quat = xpos[pid], xquat[pid]
        pos = p_pos + bq.rotate(m.body_pos[m.ix(lev)][..., None], p_quat)
        quat = bq.mult(p_quat, m.body_quat[m.ix(lev)][..., None])

        jntnum = np.asarray(m.body_jntnum)[lev]
        jntadr = np.asarray(m.body_jntadr)[lev]
        max_slots = int(jntnum.max()) if L else 0
        for slot in range(max_slots):
            has = jntnum > slot
            jid = np.where(has, jntadr + slot, 0)  # 0 = safe pad
            jt = np.where(has, jnt_type[jid], -1)
            qadr = jnt_qposadr[jid]

            is_free = jt == T.FREE
            is_ball = jt == T.BALL
            is_slide = jt == T.SLIDE
            is_hinge = jt == T.HINGE
            any_rot = is_ball | is_hinge

            anchor = d.qpos.new_zeros((L, 3, B))
            axis_w = d.qpos.new_zeros((L, 3, B))

            if is_free.any():
                q3 = d.qpos[m.ix(qadr[:, None] + np.arange(3))]
                q4 = d.qpos[m.ix(qadr[:, None] + np.arange(3, 7))]
                fm = m.const(is_free)[:, None, None]
                pos = torch.where(fm, q3, pos)
                quat = torch.where(fm, q4, quat)
                anchor = torch.where(fm, q3, anchor)
                zax = d.qpos.new_zeros((L, 3, B))
                zax[:, 2] = 1.0
                axis_w = torch.where(fm, zax, axis_w)

            if (is_ball | is_slide | is_hinge).any():
                jpos = m.jnt_pos[m.ix(jid)][..., None]
                jaxis = m.jnt_axis[m.ix(jid)][..., None]
                anc = pos + bq.rotate(jpos, quat)
                axw = bq.rotate(jaxis, quat)

                if is_slide.any():
                    delta = d.qpos[m.ix(qadr)] - m.qpos0[m.ix(qadr)][:, None]
                    pos = torch.where(m.const(is_slide)[:, None, None],
                                      pos + axw * delta[:, None, :], pos)

                if any_rot.any():
                    angle = d.qpos[m.ix(qadr)] - m.qpos0[m.ix(qadr)][:, None]
                    qloc_h = bq.axis_angle(jaxis, angle)
                    qloc_b = d.qpos[m.ix(np.minimum(
                        qadr[:, None] + np.arange(4), m.nq - 1))]
                    qloc = torch.where(m.const(is_ball)[:, None, None],
                                       qloc_b, qloc_h)
                    new_quat = bq.mult(quat, qloc)
                    new_pos = anc - bq.rotate(jpos, new_quat)
                    am = m.const(any_rot)[:, None, None]
                    quat = torch.where(am, new_quat, quat)
                    pos = torch.where(am, new_pos, pos)

                mask = m.const(is_ball | is_slide | is_hinge)[:, None, None]
                anchor = torch.where(mask, anc, anchor)
                axis_w = torch.where(mask, axw, axis_w)

            anchors.append(anchor)
            axes.append(axis_w)
            jids_all.append(jid)
            valid_all.append(has & (jt >= 0))

        # normalize quats once per level to keep long chains stable
        quat = quat / torch.linalg.vector_norm(quat, dim=-2, keepdim=True)
        xpos[m.ix(lev)] = pos
        xquat[m.ix(lev)] = quat

    xanchor = d.qpos.new_zeros((m.njnt, 3, B))
    xaxis = d.qpos.new_zeros((m.njnt, 3, B))
    if jids_all:
        jcat = np.concatenate(jids_all)
        vcat = np.concatenate(valid_all)
        sel = m.ix(np.nonzero(vcat)[0])
        xanchor[m.ix(jcat[vcat])] = torch.cat(anchors, dim=0)[sel]
        xaxis[m.ix(jcat[vcat])] = torch.cat(axes, dim=0)[sel]

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
    root = np.asarray(m.body_rootid)[body_of_dof]
    com = subtree_com[m.ix(root)]                # (nv, 3, B)
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
    """Static (segment, wrap entry, joint qposadr, joint dofadr) arrays of
    the fixed-tendon wrap list."""
    ten_adr = np.asarray(m.ten_adr)
    ten_num = np.asarray(m.ten_num)
    wrap_jnt = np.asarray(m.wrap_jntid)
    seg = np.concatenate([np.full(ten_num[t], t) for t in range(m.ntendon)])
    widx = np.concatenate([np.arange(ten_adr[t], ten_adr[t] + ten_num[t])
                           for t in range(m.ntendon)])
    qadr = np.asarray(m.jnt_qposadr)[wrap_jnt[widx]]
    dadr = np.asarray(m.jnt_dofadr)[wrap_jnt[widx]]
    return m.ix(seg), m.ix(widx), m.ix(qadr), m.ix(dadr)


def tendon(m: Model, d: Data) -> Data:
    """Fixed tendons: length = sum coef * qpos_joint (static sparse map)."""
    if m.ntendon == 0:
        return d
    seg, widx, qadr, _ = m.plan("tendon_map", _tendon_map)
    coefs = m.wrap_coef.reshape(-1)[widx][:, None]
    vals = coefs * d.qpos[qadr]
    length = d.qpos.new_zeros((m.ntendon, d.qpos.shape[-1]))
    length.index_add_(0, seg, vals)
    return d.replace(ten_length=length)


def ten_moment_apply(m: Model, d: Data, frc: torch.Tensor) -> torch.Tensor:
    """qfrc (nv, B) from per-tendon forces frc (ntendon, B) via the static
    fixed-tendon moment map."""
    seg, widx, _, dadr = m.plan("tendon_map", _tendon_map)
    coefs = m.wrap_coef.reshape(-1)[widx][:, None]
    out = torch.zeros_like(d.qvel)
    out.index_add_(0, dadr, coefs * frc[seg])
    return out


def ten_velocity_of(m: Model, d: Data) -> torch.Tensor:
    """(ntendon, B) tendon velocities via the static moment map."""
    seg, widx, _, dadr = m.plan("tendon_map", _tendon_map)
    coefs = m.wrap_coef.reshape(-1)[widx][:, None]
    out = d.qvel.new_zeros((m.ntendon, d.qvel.shape[-1]))
    out.index_add_(0, seg, coefs * d.qvel[dadr])
    return out
