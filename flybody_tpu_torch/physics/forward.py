"""Forward dynamics pipeline and integrator (batch-native).

``step(model, data) -> data`` advances a whole batch of envs (trailing
batch axis) by one physics substep. The stage order mirrors MuJoCo's
mj_forward / mj_Euler.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.ops import kinematics_kernel as KK
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import actuation as A
from flybody_tpu_torch.physics import collision as col
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import kinematics as K
from flybody_tpu_torch.physics import passive as P
from flybody_tpu_torch.physics import sensors as sens
from flybody_tpu_torch.physics import smooth as S
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.utils import telemetry as tm


def _stage(name: str, fn, m: Model, d: Data, **kw) -> Data:
    """``fn(m, d, **kw)`` inside the span ``physics.<name>``."""
    with tm.span("physics." + name):
        return fn(m, d, **kw)


def fwd_position(m: Model, d: Data, col_update: bool = False) -> Data:
    """col_update=True runs the selection-persistent collision refresh
    (Model.col_refresh > 1 schedule) instead of the full selection."""
    d = _stage("kinematics", KK.kinematics, m, d)
    d = _stage("com_pos", K.com_pos, m, d)
    d = _stage("tendon", K.tendon, m, d)
    d = _stage("crb", S.crb, m, d)
    d = _stage("collision",
               col.collision_update if col_update else col.collision, m, d)
    return _stage("transmission", S.transmission, m, d)


def fwd_velocity(m: Model, d: Data) -> Data:
    d = _stage("com_vel", S.com_vel, m, d)
    d = _stage("passive", P.passive, m, d)
    return _stage("rne", S.rne, m, d)


def fwd_actuation(m: Model, d: Data) -> Data:
    d = _stage("act_dynamics", A.act_dynamics, m, d)
    return _stage("actuation", A.actuation, m, d)


def _xfrc_to_qfrc(m: Model, d: Data) -> torch.Tensor:
    """xfrc_applied ((nbody, 6, B): force, torque at the body com, world
    frame) projected into joint space."""
    offset = d.xipos - d.subtree_com[m.ix(m.body_rootid)]
    force = d.xfrc_applied[:, :3]
    torque = d.xfrc_applied[:, 3:]
    cfrc = torch.cat([torque + bq.cross(offset, force), force], dim=-2)
    return P.project_body_forces(m, d, cfrc)


def fwd_acceleration(m: Model, d: Data) -> Data:
    qfrc_smooth = (d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator
                   + d.qfrc_applied + _xfrc_to_qfrc(m, d))
    qacc_smooth = S.solve_m(m, d, qfrc_smooth)
    return d.replace(qfrc_smooth=qfrc_smooth, qacc_smooth=qacc_smooth)


def smooth_forward(m: Model, d: Data, col_update: bool = False) -> Data:
    """Every forward stage before the constraint solve."""
    d = fwd_position(m, d, col_update=col_update)
    d = fwd_velocity(m, d)
    d = fwd_actuation(m, d)
    return _stage("acceleration", fwd_acceleration, m, d)


def forward(m: Model, d: Data, col_update: bool = False) -> Data:
    """Full forward dynamics: qacc from (qpos, qvel, ctrl, act)."""
    d = smooth_forward(m, d, col_update=col_update)
    return _stage("solve", C.solve, m, d, fresh=not col_update)


def _integrate_qpos(m: Model, qpos, qvel, h):
    """Position integration respecting quaternion manifolds (batched)."""
    out = qpos.clone()
    j = K.joint_plan(m)
    sj, qadr, dadr = j.scalar
    if len(sj):
        out.index_add_(0, qadr, h * qvel[dadr])
    if j.ball is not None:
        qidx, widx = j.ball
        out[qidx] = bq.integrate(qpos[qidx], qvel[widx], h)
    if j.free is not None:
        pidx, vidx, qidx, widx = j.free
        out[pidx] = out[pidx] + h * qvel[vidx]
        out[qidx] = bq.integrate(qpos[qidx], qvel[widx], h)
    return out


def _integrate_act(m: Model, d: Data, h):
    if m.na == 0:
        return d.act
    act = d.act + h * d.act_dot
    fe = A.actuator_plan(m).filterexact
    if fe is not None:
        ids, a = fe
        tau = torch.clamp(m.actuator_dynprm[ids, 0], min=1e-12)[:, None]
        ctrl = A.clamp_ctrl(m, d.ctrl)[ids]
        act[a] = d.act[a] + (ctrl - d.act[a]) * (1.0 - torch.exp(-h / tau))
    return act


def euler(m: Model, d: Data) -> Data:
    """Semi-implicit Euler with implicit-in-velocity joint damping
    (MuJoCo's default integrator): (M + h diag(damping)) qacc' =
    qfrc_smooth + qfrc_constraint, with the factor from smooth.crb."""
    h = m.opt.timestep.to(d.qpos.dtype)
    rhs = d.qfrc_smooth + d.qfrc_constraint
    qacc = TL.solve(m.tree, d.qLDh, d.qLDiagInvh, rhs)
    qvel = d.qvel + h * qacc
    act = _integrate_act(m, d, h)
    qpos = _integrate_qpos(m, d.qpos, qvel, h)
    return d.replace(qpos=qpos, qvel=qvel, act=act, time=d.time + h)


def step(m: Model, d: Data, col_update: bool = False) -> Data:
    """One physics step: forward dynamics + sensors + integration."""
    d = forward(m, d, col_update=col_update)
    d = _stage("sensor", sens.sensor, m, d)
    return _stage("euler", euler, m, d)
