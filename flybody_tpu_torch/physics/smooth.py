"""Smooth (unconstrained) dynamics: velocities, mass matrix, bias forces.

Matches MuJoCo's mj_comVel / mj_crb / mj_rne / mj_transmission semantics,
batch-native (trailing env axis). The joint-space inertia is assembled
directly in compressed form over the kinematic-tree sparsity pattern
(Model.tree) and factored with the level-parallel sparse LDL^T of
ops/tree_ldl.

Spatial vector convention: motion = (angular, linear) at the com-root
origin; force = (torque, force) at the same origin (MuJoCo's c-frame).
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.actuation import actuator_plan
from flybody_tpu_torch.physics.types import Data, Model


def motion_cross(v, u):
    """Spatial motion cross product v x u; (..., 6, B) inputs."""
    ang = bq.cross(v[..., :3, :], u[..., :3, :])
    lin = (bq.cross(v[..., :3, :], u[..., 3:, :])
           + bq.cross(v[..., 3:, :], u[..., :3, :]))
    return torch.cat([ang, lin], dim=-2)


def force_cross(v, f):
    """Spatial force cross product v x* f (motion x force)."""
    ang = (bq.cross(v[..., :3, :], f[..., :3, :])
           + bq.cross(v[..., 3:, :], f[..., 3:, :]))
    lin = bq.cross(v[..., :3, :], f[..., 3:, :])
    return torch.cat([ang, lin], dim=-2)


def _velpre_plan(m: Model):
    """Static (nv, nv) 0/1 matrix of the (i, j) dof pairs where dof j's
    velocity is part of the partial body velocity seen by dof i when
    forming cdof_dot[i] (the sequential mj_comVel semantics): dofs of
    strict body ancestors, dofs of earlier joints on the same body, and
    for the rotational dofs of a free joint the translational dofs of
    that joint; and the (nv,) mask of the dofs i with any such j."""
    jnt_type = np.asarray(m.jnt_type)
    jnt_dofadr = np.asarray(m.jnt_dofadr)
    body_parent = np.asarray(m.body_parentid)
    body_jntadr = np.asarray(m.body_jntadr)
    body_jntnum = np.asarray(m.body_jntnum)

    def joint_dofs(j):
        n = {T.FREE: 6, T.BALL: 3, T.SLIDE: 1, T.HINGE: 1}[int(jnt_type[j])]
        return list(range(jnt_dofadr[j], jnt_dofadr[j] + n))

    body_own = {b: [joint_dofs(j)
                    for j in range(body_jntadr[b],
                                   body_jntadr[b] + body_jntnum[b])]
                for b in range(m.nbody)}
    ii, jj = [], []
    for b in range(1, m.nbody):
        anc_dofs = []
        cur = body_parent[b]
        while cur != 0:
            anc_dofs = sum(body_own[cur], []) + anc_dofs
            cur = body_parent[cur]
        seen = list(anc_dofs)
        for j in range(body_jntadr[b], body_jntadr[b] + body_jntnum[b]):
            dofs = joint_dofs(j)
            if int(jnt_type[j]) == T.FREE:
                trans, rot = dofs[:3], dofs[3:]
                for i in rot:
                    for jd in seen + trans:
                        ii.append(i); jj.append(jd)
            else:
                for i in dofs:
                    for jd in seen:
                        ii.append(i); jj.append(jd)
            seen = seen + dofs
    ii, jj = np.asarray(ii, np.int32), np.asarray(jj, np.int32)
    P = np.zeros((m.nv, m.nv))
    P[ii, jj] = 1.0
    has_pre = np.zeros(m.nv, dtype=bool)
    has_pre[np.unique(ii)] = True
    return m.const(P), m.const(has_pre)


def com_vel(m: Model, d: Data) -> Data:
    """mj_comVel: body spatial velocities and cdof time derivatives."""
    from flybody_tpu_torch.physics.passive import support_matrix
    dof_vel = d.cdof * d.qvel[:, None, :]            # (nv, 6, B)
    S = support_matrix(m)
    cvel = torch.einsum("bv,vcB->bcB", S, dof_vel)
    P, has_pre = m.plan("velpre", _velpre_plan)
    vpre = torch.einsum("iv,vcB->icB", P, dof_vel)
    cdof_dot = motion_cross(vpre, d.cdof)
    # dofs with no contributing pairs have zero cdof_dot
    cdof_dot = torch.where(has_pre[:, None, None], cdof_dot,
                           torch.zeros_like(cdof_dot))
    return d.replace(cvel=cvel, cdof_dot=cdof_dot)


def crb(m: Model, d: Data) -> Data:
    """mj_crb + mj_factorM: compressed tree-sparse inertia + LDL^T.

    Factors both M and (M + h diag(damping)) in one stacked elimination
    pass: the Euler implicit-damping factor (forward.euler) shares the
    sparsity pattern and schedule."""
    from flybody_tpu_torch.physics.kinematics import mul_inertia
    from flybody_tpu_torch.physics.sensors import subtree_sum
    crb_inert = subtree_sum(m, d.cinert)
    crb_dof = crb_inert[m.ix(m.dof_bodyid)]          # (nv, 10, B)
    tmp = mul_inertia(crb_dof, d.cdof)               # (nv, 6, B)
    t = m.tree.on(d.qpos.device)
    # M[e] = cdof[j_e] . tmp[i_e]  (i's composite inertia, ancestor j)
    qM = torch.sum(tmp[t["entry_i"]] * d.cdof[t["entry_j"]], dim=-2)
    diag = t["diag_entry"]
    qM = qM.index_add(0, diag, m.dof_armature[:, None].expand(-1, qM.shape[1]))
    h = m.opt.timestep.to(qM.dtype)
    MhB = qM.index_add(0, diag, (h * m.dof_damping.to(qM.dtype))[:, None]
                       .expand(-1, qM.shape[1]))
    both = torch.stack([qM, MhB], dim=1)             # (nM, 2, B)
    LD2, Dinv2 = TL.factor(m.tree, both)
    c = lambda x: x.contiguous()
    return d.replace(qM=qM, qLD=c(LD2[:, 0]), qLDiagInv=c(Dinv2[:, 0]),
                     qLDh=c(LD2[:, 1]), qLDiagInvh=c(Dinv2[:, 1]))


def solve_m(m: Model, d: Data, rhs: torch.Tensor) -> torch.Tensor:
    """Solve qM x = rhs using the cached sparse factor. rhs (nv, ...B)."""
    return TL.solve(m.tree, d.qLD, d.qLDiagInv, rhs)


def body_cacc(m: Model, d: Data, dof_contrib: torch.Tensor):
    """(nbody, 6, B) body accelerations: gravity + the sum of per-dof
    contributions over each body's supporting dofs."""
    from flybody_tpu_torch.physics.passive import support_matrix
    grav = torch.cat([torch.zeros(3, dtype=d.qpos.dtype,
                                  device=d.qpos.device),
                      -m.opt.gravity.to(d.qpos.dtype)])
    acc = torch.einsum("bv,vcB->bcB", support_matrix(m), dof_contrib)
    return grav[None, :, None] + acc


def rne(m: Model, d: Data) -> Data:
    """mj_rne (flg_acc=0): qfrc_bias = C(qpos, qvel)."""
    from flybody_tpu_torch.physics.kinematics import mul_inertia
    from flybody_tpu_torch.physics.passive import project_body_forces
    dof_contrib = d.cdof_dot * d.qvel[:, None, :]   # (nv, 6, B)
    cacc = body_cacc(m, d, dof_contrib)
    Iv = mul_inertia(d.cinert, d.cvel)
    cfrc = mul_inertia(d.cinert, cacc) + force_cross(d.cvel, Iv)
    return d.replace(qfrc_bias=project_body_forces(m, d, cfrc))


def transmission(m: Model, d: Data) -> Data:
    """mj_transmission for joint/tendon actuators (static moment maps).
    Adhesion (body) transmission is handled in ``actuation``."""
    if m.nu == 0:
        return d
    B = d.qpos.shape[-1]
    length = d.qpos.new_zeros((m.nu, B))
    velocity = d.qpos.new_zeros((m.nu, B))
    p = actuator_plan(m)
    gear0 = m.actuator_gear[:, 0]

    if p.joint is not None:
        ids, qadr, dadr = p.joint
        g = gear0[ids][:, None]
        length[ids] = d.qpos[qadr] * g
        velocity[ids] = d.qvel[dadr] * g

    ten_velocity = d.ten_velocity
    if p.tendon is not None:
        from flybody_tpu_torch.physics import kinematics as K
        ten_velocity = K.ten_velocity_of(m, d)
        ids, tids = p.tendon
        g = gear0[ids][:, None]
        length[ids] = d.ten_length[tids] * g
        velocity[ids] = ten_velocity[tids] * g

    return d.replace(actuator_length=length, actuator_velocity=velocity,
                     ten_velocity=ten_velocity)
