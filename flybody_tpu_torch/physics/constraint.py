"""Constraints: joint limits + contacts, soft-constraint parameters and the
solve dispatch.

MuJoCo's soft-constraint model with static row counts: contacts are
grouped by condim with a top-K active island per group (selected inside
collision()), joint-limit rows are implicit (one nonzero per row). The
solve works in the dual over the product of friction cones. The port
carries the fused flat-row solver (physics/solver_fused.py), the
production path of every env; the matrix-free APGD and dense ADMM paths of
the JAX package raise NotImplementedError until they are ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model

# Default per-condim cap on simultaneously active contacts (static island
# size); overridable per model via put_model(con_sel=...).
MAX_ACTIVE = {1: 32, 3: 32, 4: 16, 6: 16}


def impedance(solimp, pos):
    """MuJoCo solimp sigmoid: impedance d(pos) in (0, 1).
    solimp: tuple of 5 broadcastable tensors; pos (..., B)."""
    dmin, dmax, width, mid, power = solimp
    x = torch.clamp(torch.abs(pos) / torch.clamp(width, min=1e-12), 0.0, 1.0)
    mid = torch.clamp(mid, 1e-6, 1 - 1e-6)
    power = torch.clamp(power, min=1.0)
    y_lo = (x / mid) ** power * mid
    y_hi = 1.0 - ((1.0 - x) / (1.0 - mid)) ** power * (1.0 - mid)
    y = torch.where(x < mid, y_lo, y_hi)
    imp = dmin + y * (dmax - dmin)
    return torch.clamp(imp, 1e-5, 1.0 - 1e-5)


def kbi(solref, solimp, pos, tsmin=0.0):
    """Stiffness/damping/impedance from solref/solimp (MuJoCo formulas).
    tsmin: the refsafe floor 2 * opt.timestep on timeconst."""
    imp = impedance(solimp, pos)
    dmax = torch.clamp(solimp[1], 1e-5, 1.0 - 1e-5)
    timeconst, dampratio = solref
    timeconst = torch.maximum(timeconst, torch.as_tensor(
        tsmin, dtype=timeconst.dtype, device=timeconst.device))
    b_std = 2.0 / (dmax * torch.clamp(timeconst, min=1e-12))
    k_std = imp / (dmax * dmax * torch.clamp(timeconst, min=1e-12) ** 2
                   * torch.clamp(dampratio, min=1e-12) ** 2)
    direct = timeconst <= 0
    b = torch.where(direct, -dampratio, b_std)
    k = torch.where(direct, -timeconst * imp, k_std)
    return k, b, imp


@dataclasses.dataclass(frozen=True, eq=False)
class EfcMeta:
    """Static layout of selected constraint rows."""
    limit_ids: np.ndarray      # limited scalar joint ids
    limit_qadr: np.ndarray
    limit_dadr: np.ndarray
    groups: tuple              # ((condim, K) ...) full contact-row layout
    analytic_groups: tuple     # prefix fed by the analytic narrowphase;
    #                            the (3, budget) groups after it are fed by
    #                            the gated ccd stage


def _efc_meta(m: Model) -> EfcMeta:
    jl = np.asarray(m.jnt_limited, dtype=bool)
    jt = np.asarray(m.jnt_type)
    ids = np.nonzero(jl & ((jt == T.HINGE) | (jt == T.SLIDE)))[0]
    con_dim = np.asarray(m.con_dim)
    sel = dict(m.con_sel) if m.con_sel else {}
    groups = []
    for cd in sorted(set(con_dim.tolist())):
        n = int((con_dim == cd).sum())
        cap = sel.get(int(cd), MAX_ACTIVE.get(int(cd), 16))
        groups.append((int(cd), min(n, cap)))
    analytic = tuple(groups)
    for (_, _, _, _, budget) in m.ccd_classes:
        groups.append((3, int(budget)))
    return EfcMeta(limit_ids=ids,
                   limit_qadr=np.asarray(m.jnt_qposadr)[ids],
                   limit_dadr=np.asarray(m.jnt_dofadr)[ids],
                   groups=tuple(groups), analytic_groups=analytic)


def efc_meta(m: Model) -> EfcMeta:
    return m.plan("efc_meta", _efc_meta)


@dataclasses.dataclass
class Limits:
    """Implicit limit rows: J row = sign * e_dadr."""
    dadr: np.ndarray           # static (nl,)
    sign: torch.Tensor         # (nl, B)
    R: torch.Tensor            # regularizer
    active: torch.Tensor
    pos: torch.Tensor          # margin-adjusted limit distance
    k: torch.Tensor
    b: torch.Tensor


def limit_rows(m: Model, d: Data, meta: EfcMeta) -> Limits | None:
    if len(meta.limit_ids) == 0:
        return None
    ids = m.ix(meta.limit_ids)
    q = d.qpos[m.ix(meta.limit_qadr)]          # (nl, B)
    lo = m.jnt_range[ids, 0][:, None]
    hi = m.jnt_range[ids, 1][:, None]
    dist_lo = q - lo
    dist_hi = hi - q
    lower = dist_lo < dist_hi
    dist = torch.where(lower, dist_lo, dist_hi)
    sign = torch.where(lower, torch.ones_like(q), -torch.ones_like(q))
    pos = dist - m.jnt_margin[ids][:, None]
    solref = tuple(m.jnt_solref[ids, i][:, None] for i in range(2))
    solimp = tuple(m.jnt_solimp[ids, i][:, None] for i in range(5))
    k, b, imp = kbi(solref, solimp, pos, tsmin=2.0 * m.opt.timestep)
    invweight = m.dof_invweight0[m.ix(meta.limit_dadr)][:, None]
    R = torch.clamp((1.0 - imp) / imp * invweight, min=1e-12)
    return Limits(dadr=meta.limit_dadr, sign=sign, R=R,
                  active=(pos < 0.0).to(q.dtype), pos=pos, k=k, b=b)


def solve(m: Model, d: Data, iterations: int | None = None,
          fresh: bool = True) -> Data:
    """Constraint solve: qacc, qfrc_constraint from the smooth solution.

    ``fresh`` is False on the selection-persistent update substeps of the
    Model.col_refresh schedule: the fused solver then reuses its stored
    row selection and raw warm forces."""
    meta = efc_meta(m)
    if len(meta.limit_ids) == 0 and m.ncon_max == 0 and m.nccd == 0:
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qvel))
    if m.opt.contact_solver == "fused":
        from flybody_tpu_torch.physics import solver_fused
        return solver_fused.solve_fused(m, d, iterations=iterations,
                                        fresh=fresh)
    raise NotImplementedError(
        f"contact_solver={m.opt.contact_solver!r} is not ported yet (the "
        "apgd, admm and admm_kernel solvers are queued in ROADMAP.md)")
