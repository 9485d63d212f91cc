"""Actuation: activation dynamics, gain/bias force model, adhesion (batched).

Covers the fly's actuator set: ``general`` actuators (gaintype fixed,
biastype none/affine, dyntype none/integrator/filter/filterexact) and
``adhesion`` actuators (trntype body), whose moment is the mean of the
contact-normal Jacobian rows over the active contacts of the target body.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model


def clamp_ctrl(m: Model, ctrl: torch.Tensor) -> torch.Tensor:
    limited = m.const(np.asarray(m.actuator_ctrllimited, dtype=bool))
    lo = m.actuator_ctrlrange[:, 0:1]
    hi = m.actuator_ctrlrange[:, 1:2]
    return torch.where(limited[:, None],
                       torch.minimum(torch.maximum(ctrl, lo), hi), ctrl)


def act_dynamics(m: Model, d: Data) -> Data:
    """act_dot from ctrl (dyntype integrator/filter)."""
    if m.na == 0:
        return d
    ctrl = clamp_ctrl(m, d.ctrl)
    dyn = np.asarray(m.actuator_dyntype)
    actadr = np.asarray(m.actuator_actadr)
    act_dot = torch.zeros_like(d.act)
    integ = np.nonzero(dyn == T.DYN_INTEGRATOR)[0]
    if len(integ):
        act_dot[m.ix(actadr[integ])] = ctrl[m.ix(integ)]
    filt = np.nonzero((dyn == T.DYN_FILTER) | (dyn == T.DYN_FILTEREXACT))[0]
    if len(filt):
        tau = torch.clamp(m.actuator_dynprm[m.ix(filt), 0], min=1e-12)
        a = m.ix(actadr[filt])
        act_dot[a] = (ctrl[m.ix(filt)] - d.act[a]) / tau[:, None]
    return d.replace(act_dot=act_dot)


def slot_bodies(m: Model):
    """Static (ncon_max,) body ids of geom1/geom2 per contact slot."""
    from flybody_tpu_torch.physics.io_mj import PAIR_NCON
    gb = np.asarray(m.geom_bodyid)
    pt = np.asarray(m.pair_type)
    g1, g2 = np.asarray(m.pair_geom1), np.asarray(m.pair_geom2)
    b1, b2 = [], []
    for k in range(len(g1)):
        n = PAIR_NCON[(int(pt[k, 0]), int(pt[k, 1]))]
        b1 += [gb[g1[k]]] * n
        b2 += [gb[g2[k]]] * n
    return np.array(b1, dtype=np.int64), np.array(b2, dtype=np.int64)


def _adhesion_acts(m: Model):
    """Static (actuator id, target body id) pairs of adhesion actuators."""
    acts = np.nonzero(np.asarray(m.actuator_trntype) == T.TRN_BODY)[0]
    bodies = np.asarray(m.actuator_trnid)[acts, 0]
    return acts, bodies


def adhesion_qfrc(m: Model, d: Data, force: torch.Tensor) -> torch.Tensor:
    """qfrc (nv, B) of the adhesion actuators given their scalar forces
    (nu, B): moment = -(mean over active contacts of the target body of
    the contact-normal Jacobian row) * gear (mjTRN_BODY semantics).

    The weighted normal-row sum is accumulated as per-body 6D wrenches
    (row scatter-adds over the selected contacts' two bodies), then mapped to
    dofs through the static (nbody, nv) support mask."""
    qfrc = torch.zeros_like(d.qvel)
    acts, bodies = _adhesion_acts(m)
    if len(acts) == 0 or (m.ncon_max == 0 and m.nccd == 0):
        return qfrc
    from flybody_tpu_torch.math import bquat as bq
    from flybody_tpu_torch.ops import rows
    from flybody_tpu_torch.physics import solver_fused as SF
    from flybody_tpu_torch.physics.passive import support_matrix
    dtype = d.qpos.dtype
    con = d.contact

    active = (con.dist < con.marginfull).to(dtype)          # (Ksum, B)
    bod = m.ix(bodies)[:, None, None]                       # (nact, 1, 1)
    member = ((con.b1[None].long() == bod)
              | (con.b2[None].long() == bod)).to(dtype)     # (nact, Ksum, B)
    count = torch.sum(member * active[None], dim=1)         # (nact, B)
    gain = m.actuator_gear[m.ix(acts), 0]
    scale = torch.where(count > 0,
                        -gain[:, None] / torch.clamp(count, min=1.0),
                        torch.zeros_like(count)) * force[m.ix(acts)]
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
    dyn = np.asarray(m.actuator_dyntype)
    actadr = np.asarray(m.actuator_actadr)
    has_act = dyn != T.DYN_NONE
    act_idx = np.where(has_act, np.maximum(actadr, 0), 0)
    inp = (torch.where(m.const(has_act)[:, None], d.act[m.ix(act_idx)], ctrl)
           if m.na else ctrl)

    gaintype = np.asarray(m.actuator_gaintype)
    gp = m.actuator_gainprm
    gain = torch.where(m.const(gaintype == T.GAIN_AFFINE)[:, None],
                       gp[:, 0:1] + gp[:, 1:2] * d.actuator_length
                       + gp[:, 2:3] * d.actuator_velocity,
                       gp[:, 0:1])
    biastype = np.asarray(m.actuator_biastype)
    bp = m.actuator_biasprm
    bias = torch.where(m.const(biastype == T.BIAS_AFFINE)[:, None],
                       bp[:, 0:1] + bp[:, 1:2] * d.actuator_length
                       + bp[:, 2:3] * d.actuator_velocity,
                       torch.zeros_like(d.actuator_length))
    force = gain * inp + bias
    flimited = m.const(np.asarray(m.actuator_forcelimited, dtype=bool))
    force = torch.where(
        flimited[:, None],
        torch.minimum(torch.maximum(force, m.actuator_forcerange[:, 0:1]),
                      m.actuator_forcerange[:, 1:2]),
        force)

    qfrc = torch.zeros_like(d.qvel)
    trntype = np.asarray(m.actuator_trntype)
    trnid = np.asarray(m.actuator_trnid)[:, 0]
    gear0 = m.actuator_gear[:, 0]
    jnt_dofadr = np.asarray(m.jnt_dofadr)
    jids = np.nonzero(trntype == T.TRN_JOINT)[0]
    if len(jids):
        qfrc.index_add_(0, m.ix(jnt_dofadr[trnid[jids]]),
                        gear0[m.ix(jids)][:, None] * force[m.ix(jids)])
    tids = np.nonzero(trntype == T.TRN_TENDON)[0]
    if len(tids):
        from flybody_tpu_torch.physics import kinematics as K
        ten_frc = d.qpos.new_zeros((m.ntendon, d.qpos.shape[-1]))
        ten_frc.index_add_(0, m.ix(trnid[tids]),
                           gear0[m.ix(tids)][:, None] * force[m.ix(tids)])
        qfrc = qfrc + K.ten_moment_apply(m, d, ten_frc)

    qfrc = qfrc + adhesion_qfrc(m, d, force)
    return d.replace(actuator_force=force, qfrc_actuator=qfrc)
