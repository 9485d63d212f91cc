"""Sensor evaluation (accelerometer, gyro, velocimeter, force, touch, ...).

Covers the fly's sensor suite plus generic joint/frame/tendon sensors.
Acceleration-dependent sensors use a post-constraint RNE pass (cacc,
cfrc_int) equivalent to MuJoCo's mj_rnePostConstraint. Batch-native: all
tensors carry the trailing env axis.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.ops import rows
from flybody_tpu_torch.physics import smooth as S
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.collision import slot_layout
from flybody_tpu_torch.physics.types import Data, Model


def _contact_body_forces(m: Model, d: Data) -> torch.Tensor:
    """(nbody, 6, B) spatial contact forces (at the com-root origin, world
    frame) from the solver's compact selected forces."""
    B = d.qpos.shape[-1]
    out = d.qpos.new_zeros((m.nbody, 6, B))
    if m.ncon_max == 0 or d.warm_sel.shape[0] == 0:
        return out
    con = d.contact
    # world-frame force on body2 (normal points g1 -> g2; a positive
    # normal force pushes the bodies apart, along -normal on body2)
    F = -torch.einsum("cdkB,cdB->ckB", con.frame, d.warm_f)   # (Ksum, 3, B)
    com_root = d.subtree_com[m.ix(m.body_rootid)]            # (nbody, 3, B)
    r2 = con.pos - rows.take(com_root, con.b2)
    r1 = con.pos - rows.take(com_root, con.b1)
    w2 = torch.cat([bq.cross(r2, F), F], dim=-2)
    w1 = torch.cat([bq.cross(r1, F), F], dim=-2)
    return (out + rows.add_rows(w2, con.b2, m.nbody)
            - rows.add_rows(w1, con.b1, m.nbody))


def _subtree_matrix(m: Model):
    """Static (nbody, nbody) 0/1 matrix: [a, b] = 1 where a is b or an
    ancestor of b."""
    par = np.asarray(m.body_parentid)
    A = np.zeros((m.nbody, m.nbody))
    for b in range(m.nbody):
        cur = b
        while True:
            A[cur, b] = 1.0
            if cur == 0:
                break
            cur = par[cur]
    return m.const(A)


def subtree_sum(m: Model, x: torch.Tensor) -> torch.Tensor:
    """out[a] = sum over descendants-or-self b of x[b], as one matmul with
    the static (nbody, nbody) ancestor matrix."""
    A = m.plan("subtree_matrix", _subtree_matrix).to(x.dtype)
    return torch.einsum("ab,b...->a...", A, x)


def rne_postconstraint(m: Model, d: Data):
    """cacc (nbody, 6, B) and cfrc_int (nbody, 6, B) given solved qacc."""
    from flybody_tpu_torch.physics.kinematics import mul_inertia
    contrib = d.cdof_dot * d.qvel[:, None, :] + d.cdof * d.qacc[:, None, :]
    cacc = S.body_cacc(m, d, contrib)

    cfrc_ext = _contact_body_forces(m, d)
    offset = d.xipos - d.subtree_com[m.ix(m.body_rootid)]
    force = d.xfrc_applied[:, :3]
    torque = d.xfrc_applied[:, 3:]
    cfrc_ext = cfrc_ext + torch.cat([torque + bq.cross(offset, force),
                                     force], dim=-2)
    Iv = mul_inertia(d.cinert, d.cvel)
    leaf = mul_inertia(d.cinert, cacc) + S.force_cross(d.cvel, Iv) - cfrc_ext
    return cacc, subtree_sum(m, leaf)


def _spatial_at_point(vec6, origin, point):
    """Translate a spatial (ang, lin) vector from `origin` to `point`."""
    ang = vec6[..., :3, :]
    lin = vec6[..., 3:, :] + bq.cross(ang, point - origin)
    return ang, lin


_NEED_ACC = (T.SENS_ACCELEROMETER, T.SENS_FORCE, T.SENS_TORQUE)
_SITE_FRAME = (T.SENS_GYRO, T.SENS_VELOCIMETER) + _NEED_ACC


def _sensor_plan(m: Model):
    """Per sensor (type, object id, address, object type, its site's body
    and that body's com root, a touch sensor's mask over the candidate
    slots, set on its body's analytic slots, or None); whether any sensor
    needs the post-constraint accelerations."""
    lay = slot_layout(m) if m.ncon_max else None
    out = []
    for st, oid, a, ot in zip(*(np.asarray(x).tolist() for x in (
            m.sensor_type, m.sensor_objid, m.sensor_adr, m.sensor_objtype))):
        b = (int(m.site_bodyid[oid])
             if st in _SITE_FRAME + (T.SENS_TOUCH,) else 0)
        on = np.zeros(len(lay.cand_b1) if lay is not None else 0, bool)
        if st == T.SENS_TOUCH and lay is not None:
            on[:len(lay.b1)] = (lay.b1 == b) | (lay.b2 == b)
        out.append((st, oid, a, ot, b, int(m.body_rootid[b]),
                    m.const(on) if on.any() else None))
    return tuple(out), any(st in _NEED_ACC for st, *_ in out)


def sensor(m: Model, d: Data) -> Data:
    """Evaluate all sensors into sensordata (nsensordata, B)."""
    if m.nsensor == 0:
        return d
    B = d.qpos.shape[-1]
    filled: dict = {}
    plan, need_acc = m.plan("sensors", _sensor_plan)
    cacc = cfrc_int = None
    if need_acc:
        cacc, cfrc_int = rne_postconstraint(m, d)

    def put(a, val):
        filled[a] = val if val.ndim == 2 else val[None]

    for st, oid, a, objtype, b, com_b, touch in plan:
        if st in _SITE_FRAME:
            com = d.subtree_com[com_b]
            p = d.site_xpos[oid]
            R = d.site_xmat[oid]
            ang_w, lin_w = _spatial_at_point(d.cvel[b], com, p)
            if st == T.SENS_GYRO:
                put(a, bq.matvec_t(R, ang_w))
            elif st == T.SENS_VELOCIMETER:
                put(a, bq.matvec_t(R, lin_w))
            elif st == T.SENS_ACCELEROMETER:
                _, alin = _spatial_at_point(cacc[b], com, p)
                put(a, bq.matvec_t(R, alin + bq.cross(ang_w, lin_w)))
            elif st == T.SENS_FORCE:
                put(a, bq.matvec_t(R, cfrc_int[b, 3:]))
            else:  # TORQUE: subtree torque translated from com to site
                trq = cfrc_int[b, :3] - bq.cross(p - com, cfrc_int[b, 3:])
                put(a, bq.matvec_t(R, trq))
        elif st == T.SENS_TOUCH:
            val = d.qpos.new_zeros((B,))
            if touch is not None:
                # the selected contacts on the sensor's slots (-1 pads)
                sel = d.warm_sel.long()
                mask = (touch[sel.clamp(min=0)] & (sel >= 0)).to(
                    d.qpos.dtype)
                val = torch.sum(d.warm_f[:, 0] * mask, dim=0)
            put(a, torch.clamp(val, min=0.0))
        elif st == T.SENS_JOINTPOS:
            put(a, d.qpos[int(m.jnt_qposadr[oid])])
        elif st == T.SENS_JOINTVEL:
            put(a, d.qvel[int(m.jnt_dofadr[oid])])
        elif st == T.SENS_ACTUATORFRC:
            put(a, d.actuator_force[oid])
        elif st in (T.SENS_FRAMEPOS, T.SENS_FRAMEQUAT, T.SENS_FRAMEZAXIS):
            if objtype == 6:       # mjOBJ_SITE
                pos, mat = d.site_xpos[oid], d.site_xmat[oid]
            elif objtype == 5:     # mjOBJ_GEOM
                pos, mat = d.geom_xpos[oid], d.geom_xmat[oid]
            else:                  # mjOBJ_BODY / mjOBJ_XBODY
                pos, mat = d.xpos[oid], d.xmat[oid]
            if st == T.SENS_FRAMEPOS:
                put(a, pos)
            elif st == T.SENS_FRAMEZAXIS:
                put(a, mat[:, 2])
            else:
                put(a, bq.from_mat(mat))
        elif st == T.SENS_SUBTREECOM:
            put(a, d.subtree_com[oid])
        elif st == T.SENS_SUBTREELINVEL:
            off = d.xipos - d.subtree_com[m.ix(m.body_rootid)]
            vcom = d.cvel[:, 3:] + bq.cross(d.cvel[:, :3], off)
            mom = m.body_mass[:, None, None] * vcom
            acc = subtree_sum(m, mom)
            put(a, acc[oid] / torch.clamp(m.body_subtreemass[oid], min=1e-12))
        elif st == T.SENS_TENDONPOS:
            put(a, d.ten_length[oid])
        elif st == T.SENS_TENDONVEL:
            put(a, d.ten_velocity[oid])
    out = d.qpos.new_zeros((m.nsensordata, B))
    for a, val in filled.items():
        out[a:a + val.shape[0]] = val
    return d.replace(sensordata=out)
