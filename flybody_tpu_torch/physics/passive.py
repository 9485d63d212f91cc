"""Passive forces: joint/tendon springs & dampers and fluid forces (batched).

The fly runs in a viscous medium (air at CGS scale), so fluid forces act on
every body via MuJoCo's inertia-box model, and on geoms that opt in via the
per-geom ellipsoid model. Both are batched closed forms over the trailing
env axis.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.physics.types import Data, Model

_PI = np.pi


def _mid(s):
    """Middle semi-axis per geom: sum - max - min over the last axis."""
    return (torch.sum(s, dim=-1) - torch.amax(s, dim=-1)
            - torch.amin(s, dim=-1))


def support_matrix(m: Model) -> torch.Tensor:
    """Static (nbody, nv) 0/1 support mask (dof supports body)."""
    return m.const(np.asarray(m.body_dof_mask, dtype=np.float64))


def project_body_forces(m: Model, d: Data, cfrc: torch.Tensor):
    """Per-body spatial forces (nbody, 6, B) at the com-root origin, world
    frame -> joint space qfrc (nv, B):
    qfrc[v] = cdof[v] . sum over bodies b supported by v of cfrc[b]."""
    acc = torch.einsum("bv,bcB->vcB", support_matrix(m), cfrc)
    return torch.sum(acc * d.cdof, dim=-2)


def body_velocity_local(m: Model, d: Data):
    """6D velocity of each body at its com, in the inertia frame
    (mj_objectVelocity(..., mjOBJ_BODY, flg_local=1)).
    Returns (angvel_local, linvel_local), (nbody, 3, B)."""
    offset = d.xipos - d.subtree_com[m.ix(m.body_rootid)]
    ang_w = d.cvel[:, :3]
    lin_w = d.cvel[:, 3:] + bq.cross(ang_w, offset)
    return bq.matvec_t(d.ximat, ang_w), bq.matvec_t(d.ximat, lin_w)


def _fluid_plan(m: Model):
    """The inertia-box model's (nbody, 3, 1) box (the full side lengths of
    the diagonal inertia's equivalent box) and (nbody,) body weights (0
    for the world and for bodies with an ellipsoid-fluid geom), and the
    ellipsoid model's (geoms, their bodies, their com roots) index
    tensors, or None."""
    I = m.body_inertia
    mass = torch.clamp(m.body_mass, min=1e-12)[:, None]
    Ij = torch.stack([I[:, 1] + I[:, 2] - I[:, 0],
                      I[:, 2] + I[:, 0] - I[:, 1],
                      I[:, 0] + I[:, 1] - I[:, 2]], dim=-1)
    box = torch.sqrt(torch.clamp(6.0 * Ij / mass, min=1e-24))[..., None]
    active = np.asarray(m.geom_fluid_active)
    gids = np.flatnonzero(active)
    bids = np.asarray(m.geom_bodyid)[gids]
    keep = np.ones(m.nbody)
    keep[bids] = 0.0
    keep[0] = 0.0
    return box, m.const(keep), ((m.ix(gids), m.ix(bids),
                                 m.ix(np.asarray(m.body_rootid)[bids]))
                                if active.any() else None)


def fluid_box(m: Model, d: Data) -> torch.Tensor:
    """Inertia-box fluid model (mj_inertiaBoxFluid): (nbody, 6, B) spatial
    forces at the com-root origin. Bodies with an ellipsoid-fluid geom are
    excluded (they use ``fluid_ellipsoid``)."""
    dtype = d.qpos.dtype
    ang_l, lin_l = body_velocity_local(m, d)
    wind = m.opt.wind.to(dtype)
    wind_l = bq.matvec_t(d.ximat, wind[None, :, None].expand(d.xipos.shape))
    lin_l = lin_l - wind_l

    box, keep, _ = m.plan("fluid", _fluid_plan)
    rho, beta = m.opt.density, m.opt.viscosity
    b0, b1, b2 = box[:, 0], box[:, 1], box[:, 2]  # (nbody, 1)
    area = torch.stack([b1 * b2, b0 * b2, b0 * b1], dim=-2)
    frc = -0.5 * rho * area * torch.abs(lin_l) * lin_l
    btrq = torch.stack([
        b0 * (b1 ** 4 + b2 ** 4),
        b1 * (b0 ** 4 + b2 ** 4),
        b2 * (b0 ** 4 + b1 ** 4)], dim=-2)
    trq = -rho * btrq * torch.abs(ang_l) * ang_l / 64.0

    diam = (b0 + b1 + b2) / 3.0      # (nbody, 1)
    frc = frc - 3.0 * _PI * diam[:, None] * beta * lin_l
    trq = trq - _PI * (diam ** 3)[:, None] * beta * ang_l

    frc_w = bq.matvec(d.ximat, frc)
    trq_w = bq.matvec(d.ximat, trq)
    offset = d.xipos - d.subtree_com[m.ix(m.body_rootid)]
    trq_o = trq_w + bq.cross(offset, frc_w)
    out = torch.cat([trq_o, frc_w], dim=-2)   # (nbody, 6, B)
    return out * keep[:, None, None]


def fluid_ellipsoid(m: Model, d: Data) -> torch.Tensor:
    """Per-geom ellipsoid fluid model. Returns (nbody, 6, B) spatial forces
    at the com-root origin; zero unless a geom opts in via fluidshape.
    Terms (see the JAX package's passive.fluid_ellipsoid for their
    derivation against MuJoCo): viscous Stokes, quadratic angular and
    slender rotational drag, blunt + slender quadratic drag, Kutta lift,
    Magnus force and the added-mass gyroscopic terms."""
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    _, _, geoms = m.plan("fluid", _fluid_plan)
    if geoms is None:
        return d.qpos.new_zeros((m.nbody, 6, B))
    g_ix, b_ix, root = geoms

    offset = d.geom_xpos[g_ix] - d.subtree_com[root]
    ang_w = d.cvel[b_ix, :3]
    lin_w = d.cvel[b_ix, 3:] + bq.cross(ang_w, offset)
    R = d.geom_xmat[g_ix]                      # (g, 3, 3, B)
    wind = m.opt.wind.to(dtype)[None, :, None].expand(lin_w.shape)
    ang = bq.matvec_t(R, ang_w)
    lin = bq.matvec_t(R, lin_w - wind)

    fl = m.geom_fluid[g_ix]
    c_blunt, c_slender, c_ang = fl[:, 1:2], fl[:, 2:3], fl[:, 3:4]
    c_kutta, c_magnus = fl[:, 4:5], fl[:, 5:6]
    vmass = fl[:, 6:9, None]
    vinertia = fl[:, 9:12, None]
    s = m.geom_size[g_ix]
    sx, sy, sz = s[:, 0:1], s[:, 1:2], s[:, 2:3]
    rho, beta = m.opt.density, m.opt.viscosity
    eps = 1e-15

    r_eq = (sx + sy + sz) / 3.0
    frc = -6.0 * _PI * r_eq[..., None] * beta * lin
    trq = -8.0 * _PI * (r_eq ** 3)[..., None] * beta * ang

    I_ang = (8.0 / 15.0) * _PI * torch.cat([
        sx * torch.maximum(sy, sz) ** 4,
        sy * torch.maximum(sx, sz) ** 4,
        sz * torch.maximum(sx, sy) ** 4], dim=-1)[..., None]  # (g, 3, 1)
    I_max = torch.amax(I_ang, dim=-2, keepdim=True)
    mom_visc = ang * (c_ang[..., None] * I_ang
                      + c_slender[..., None] * (I_max - I_ang))
    trq = trq - rho * bq.norm(mom_visc)[:, None, :] * ang

    speed = bq.norm(lin)[:, None, :]            # (g, 1, B)
    pair = torch.cat([sy * sz, sx * sz, sx * sy], dim=-1)[..., None]
    p_num = torch.sum((pair * lin) ** 2, dim=-2, keepdim=True)
    p_den = torch.sum((pair ** 2 * lin) ** 2, dim=-2, keepdim=True)
    A_proj = _PI * torch.sqrt(p_den / torch.clamp(p_num, min=eps))
    A_max = _PI * (torch.amax(s, dim=-1) * _mid(s))[:, None, None]
    drag = (rho * c_blunt[..., None] * A_proj
            + rho * c_slender[..., None] * torch.clamp(A_max - A_proj,
                                                       min=0.0))
    frc = frc - drag * speed * lin

    normal = pair ** 2 * lin
    lift = bq.cross(bq.cross(normal, lin), lin)
    kutta_coef = (_PI * torch.sqrt(p_num / torch.clamp(p_den, min=eps))
                  / torch.clamp(speed, min=eps))
    frc = frc + rho * c_kutta[..., None] * kutta_coef * lift

    vol = ((4.0 / 3.0) * _PI * (sx * sy * sz))[..., None]
    frc = frc + c_magnus[..., None] * rho * vol * bq.cross(ang, lin)

    p_mom = rho * vmass * lin
    l_mom = rho * vinertia * ang
    frc = frc + bq.cross(p_mom, ang)
    trq = trq + bq.cross(p_mom, lin) + bq.cross(l_mom, ang)

    frc_w = bq.matvec(R, frc)
    trq_w = bq.matvec(R, trq)
    trq_o = trq_w + bq.cross(offset, frc_w)
    out = d.qpos.new_zeros((m.nbody, 6, B))
    out.index_add_(0, b_ix, torch.cat([trq_o, frc_w], dim=-2))
    return out


def passive(m: Model, d: Data) -> Data:
    """mj_passive: springs + dampers + fluid -> qfrc_passive."""
    from flybody_tpu_torch.physics import kinematics as K
    qfrc = torch.zeros_like(d.qvel)
    scalar, qadr, dadr = K.joint_plan(m).scalar
    if len(scalar):
        stiff = m.jnt_stiffness[m.ix(scalar)][:, None]
        qfrc.index_add_(0, dadr,
                        -stiff * (d.qpos[qadr] - m.qpos_spring[qadr][:, None]))

    qfrc = qfrc - m.dof_damping[:, None] * d.qvel

    if m.ntendon:
        lo = m.ten_lengthspring[:, 0:1]
        hi = m.ten_lengthspring[:, 1:2]
        zero = torch.zeros_like(d.ten_length)
        dlen = torch.where(d.ten_length > hi, d.ten_length - hi,
                           torch.where(d.ten_length < lo, d.ten_length - lo,
                                       zero))
        ten_vel = K.ten_velocity_of(m, d)
        frc = (-m.ten_stiffness[:, None] * dlen
               - m.ten_damping[:, None] * ten_vel)
        qfrc = qfrc + K.ten_moment_apply(m, d, frc)

    qfrc_fluid = torch.zeros_like(qfrc)
    if m.opt.has_fluid:
        cfrc = fluid_box(m, d) + fluid_ellipsoid(m, d)
        qfrc_fluid = project_body_forces(m, d, cfrc)
        qfrc = qfrc + qfrc_fluid
    return d.replace(qfrc_passive=qfrc, qfrc_fluid=qfrc_fluid)
