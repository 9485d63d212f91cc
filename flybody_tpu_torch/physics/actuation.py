"""Actuation: activation dynamics, gain/bias force model, adhesion (batched).

Covers the fly's actuator set: ``general`` actuators (gaintype fixed,
biastype none/affine, dyntype none/integrator/filter/filterexact) and
``adhesion`` actuators (trntype body), whose moment is the mean of the
contact-normal Jacobian rows over the active contacts of the target body.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model


def actuator_plan(m: Model) -> SimpleNamespace:
    """The model's static actuator masks and index sets, built once:
    ``integrator``, ``filter`` (filter and filterexact) and ``filterexact``
    as (ids, act address); ``joint`` as (ids, qpos address, dof address);
    ``tendon`` and ``adhesion`` as (ids, tendon or body id); None if empty."""
    def build(m):
        def ids(mask, *cols):
            """(ids, each of cols at ids) as index tensors; None if empty."""
            i = np.flatnonzero(mask)
            if len(i) == 0:
                return None
            return (m.ix(i),) + tuple(m.ix(c[i]) for c in cols)

        dyn = np.asarray(m.actuator_dyntype)
        actadr = np.asarray(m.actuator_actadr)
        trntype = np.asarray(m.actuator_trntype)
        trnid = np.asarray(m.actuator_trnid)[:, 0]
        jnt = np.where(trntype == T.TRN_JOINT, trnid, 0)
        has_act = dyn != T.DYN_NONE
        filt = (dyn == T.DYN_FILTER) | (dyn == T.DYN_FILTEREXACT)
        return SimpleNamespace(
            ctrllimited=m.const(np.asarray(m.actuator_ctrllimited, bool)),
            forcelimited=m.const(np.asarray(m.actuator_forcelimited, bool)),
            integrator=ids(dyn == T.DYN_INTEGRATOR, actadr),
            filter=ids(filt, actadr),
            filterexact=ids(dyn == T.DYN_FILTEREXACT, actadr),
            has_act=m.const(has_act),
            act_idx=m.ix(np.where(has_act, np.maximum(actadr, 0), 0)),
            gain_affine=m.const(np.asarray(m.actuator_gaintype)
                                == T.GAIN_AFFINE),
            bias_affine=m.const(np.asarray(m.actuator_biastype)
                                == T.BIAS_AFFINE),
            joint=ids(trntype == T.TRN_JOINT,
                      np.asarray(m.jnt_qposadr)[jnt],
                      np.asarray(m.jnt_dofadr)[jnt]),
            tendon=ids(trntype == T.TRN_TENDON, trnid),
            adhesion=ids(trntype == T.TRN_BODY, trnid))
    return m.plan("actuators", build)


def clamp_ctrl(m: Model, ctrl: torch.Tensor) -> torch.Tensor:
    limited = actuator_plan(m).ctrllimited
    lo = m.actuator_ctrlrange[:, 0:1]
    hi = m.actuator_ctrlrange[:, 1:2]
    return torch.where(limited[:, None],
                       torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)


def act_dynamics(m: Model, d: Data) -> Data:
    """act_dot from ctrl (dyntype integrator/filter)."""
    if m.na == 0:
        return d
    ctrl = clamp_ctrl(m, d.ctrl)
    p = actuator_plan(m)
    act_dot = torch.zeros_like(d.act)
    if p.integrator is not None:
        ids, a = p.integrator
        act_dot[a] = ctrl[ids]
    if p.filter is not None:
        ids, a = p.filter
        tau = torch.clamp(m.actuator_dynprm[ids, 0], min=1e-12)
        act_dot[a] = (ctrl[ids] - d.act[a]) / tau[:, None]
    return d.replace(act_dot=act_dot)


def adhesion_qfrc(m: Model, d: Data, force: torch.Tensor) -> torch.Tensor:
    """qfrc (nv, B) of the adhesion actuators given their scalar forces
    (nu, B): moment = -(mean over active contacts of the target body of
    the contact-normal Jacobian row) * gear (mjTRN_BODY semantics).

    The weighted normal-row sum is accumulated as per-body 6D wrenches
    (row scatter-adds over the selected contacts' two bodies), then mapped to
    dofs through the static (nbody, nv) support mask."""
    qfrc = torch.zeros_like(d.qvel)
    adhesion = actuator_plan(m).adhesion
    if adhesion is None or (m.ncon_max == 0 and m.nccd == 0):
        return qfrc
    acts, bodies = adhesion
    from flybody_tpu_torch.math import bquat as bq
    from flybody_tpu_torch.ops import rows
    from flybody_tpu_torch.physics import solver_fused as SF
    from flybody_tpu_torch.physics.passive import support_matrix
    dtype = d.qpos.dtype
    con = d.contact

    active = (con.dist < con.marginfull).to(dtype)          # (Ksum, B)
    bod = bodies[:, None, None]                             # (nact, 1, 1)
    member = ((con.b1[None].long() == bod)
              | (con.b2[None].long() == bod)).to(dtype)     # (nact, Ksum, B)
    count = torch.sum(member * active[None], dim=1)         # (nact, B)
    gain = m.actuator_gear[acts, 0]
    scale = torch.where(count > 0,
                        -gain[:, None] / torch.clamp(count, min=1.0),
                        torch.zeros_like(count)) * force[acts]
    coeff = torch.sum(member * scale[:, None, :], dim=0) * active

    normal = con.frame[:, 0]                                # (Ksum, 3, B)
    u6n = torch.cat([normal, bq.cross(con.pos, normal)], dim=-2)
    w = u6n * coeff[:, None, :]                             # (Ksum, 6, B)
    # wrench[b] = sum_k ([b2_k == b] - [b1_k == b]) w_k
    wrench = (rows.add_rows(w, con.b2, m.nbody)
              - rows.add_rows(w, con.b1, m.nbody))           # (nb, 6, B)
    wv = torch.einsum("bv,bcB->vcB", support_matrix(m), wrench)
    D6 = SF.dof_basis(m, d)
    return qfrc + torch.sum(wv * D6, dim=1)


def actuation(m: Model, d: Data) -> Data:
    """mj_fwdActuation: actuator forces -> qfrc_actuator."""
    if m.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
    ctrl = clamp_ctrl(m, d.ctrl)
    p = actuator_plan(m)
    inp = (torch.where(p.has_act[:, None], d.act[p.act_idx], ctrl)
           if m.na else ctrl)

    gp = m.actuator_gainprm
    gain = torch.where(p.gain_affine[:, None],
                       gp[:, 0:1] + gp[:, 1:2] * d.actuator_length
                       + gp[:, 2:3] * d.actuator_velocity,
                       gp[:, 0:1])
    bp = m.actuator_biasprm
    bias = torch.where(p.bias_affine[:, None],
                       bp[:, 0:1] + bp[:, 1:2] * d.actuator_length
                       + bp[:, 2:3] * d.actuator_velocity,
                       torch.zeros_like(d.actuator_length))
    force = gain * inp + bias
    force = torch.where(
        p.forcelimited[:, None],
        torch.minimum(torch.maximum(force, m.actuator_forcerange[:, 0:1]),
                      m.actuator_forcerange[:, 1:2]),
        force)

    qfrc = torch.zeros_like(d.qvel)
    gear0 = m.actuator_gear[:, 0]
    if p.joint is not None:
        ids, _, dadr = p.joint
        qfrc.index_add_(0, dadr, gear0[ids][:, None] * force[ids])
    if p.tendon is not None:
        from flybody_tpu_torch.physics import kinematics as K
        ids, tids = p.tendon
        ten_frc = d.qpos.new_zeros((m.ntendon, d.qpos.shape[-1]))
        ten_frc.index_add_(0, tids, gear0[ids][:, None] * force[ids])
        qfrc = qfrc + K.ten_moment_apply(m, d, ten_frc)

    qfrc = qfrc + adhesion_qfrc(m, d, force)
    return d.replace(actuator_force=force, qfrc_actuator=qfrc)
