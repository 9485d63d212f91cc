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


def _subtree_pairs(m: Model):
    """Static (ancestor_body, descendant_body) pairs (incl. self)."""
    par = np.asarray(m.body_parentid)
    anc_l, desc_l = [], []
    for b in range(m.nbody):
        cur = b
        while True:
            anc_l.append(cur)
            desc_l.append(b)
            if cur == 0:
                break
            cur = par[cur]
    return np.asarray(anc_l, np.int64), np.asarray(desc_l, np.int64)


def _subtree_matrix(m: Model):
    anc, desc = _subtree_pairs(m)
    A = np.zeros((m.nbody, m.nbody))
    A[anc, desc] = 1.0
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


def sensor(m: Model, d: Data) -> Data:
    """Evaluate all sensors into sensordata (nsensordata, B)."""
    if m.nsensor == 0:
        return d
    B = d.qpos.shape[-1]
    filled: dict = {}
    types = np.asarray(m.sensor_type)
    objid = np.asarray(m.sensor_objid)
    adr = np.asarray(m.sensor_adr)
    need_acc = np.any((types == T.SENS_ACCELEROMETER)
                      | (types == T.SENS_FORCE) | (types == T.SENS_TORQUE))
    cacc = cfrc_int = None
    if need_acc:
        cacc, cfrc_int = rne_postconstraint(m, d)
    root = np.asarray(m.body_rootid)
    site_body = np.asarray(m.site_bodyid)

    def put(a, val):
        filled[a] = val if val.ndim == 2 else val[None]

    for i in range(m.nsensor):
        st, oid, a = int(types[i]), int(objid[i]), int(adr[i])
        if st in (T.SENS_GYRO, T.SENS_VELOCIMETER, T.SENS_ACCELEROMETER,
                  T.SENS_FORCE, T.SENS_TORQUE):
            b = int(site_body[oid])
            com = d.subtree_com[int(root[b])]
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
            b = int(site_body[oid])
            val = d.qpos.new_zeros((B,))
            if m.ncon_max:
                from flybody_tpu_torch.physics.actuation import slot_bodies
                b1s, b2s = slot_bodies(m)
                on = np.nonzero((b1s == b) | (b2s == b))[0]
                if len(on):
                    mask = selected_in(d.warm_sel, m.ix(on)).to(d.qpos.dtype)
                    val = torch.sum(d.warm_f[:, 0] * mask, dim=0)
            put(a, torch.clamp(val, min=0.0))
        elif st == T.SENS_JOINTPOS:
            put(a, d.qpos[int(np.asarray(m.jnt_qposadr)[oid])])
        elif st == T.SENS_JOINTVEL:
            put(a, d.qvel[int(np.asarray(m.jnt_dofadr)[oid])])
        elif st == T.SENS_ACTUATORFRC:
            put(a, d.actuator_force[oid])
        elif st in (T.SENS_FRAMEPOS, T.SENS_FRAMEQUAT, T.SENS_FRAMEZAXIS):
            objtype = int(np.asarray(m.sensor_objtype)[i])
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
            off = d.xipos - d.subtree_com[m.ix(root)]
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


def selected_in(sel: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """(Ksum, B) bool: the selected slot id is in the static ``slots``."""
    return torch.isin(sel.long(), slots)
