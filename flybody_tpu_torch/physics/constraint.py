"""Constraints: joint limits + contacts, soft-constraint parameters and the
solve dispatch.

MuJoCo's soft-constraint model with static row counts: contacts are
grouped by condim with a top-K active island per group (selected inside
collision()), joint-limit rows are implicit (one nonzero per row). The
solve works in the dual over the product of friction cones. ``solve``
dispatches on ``m.opt.contact_solver`` to one of four solvers: "fused"
(the flat-row solver of physics/solver_fused.py, the production path of
the walking and flight envs), "apgd" (matrix-free, physics/solver.py),
"admm" and "admm_kernel" (dense, physics/solver_dense.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.physics.kinematics import joint_plan
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
    scalar = joint_plan(m).scalar[0]
    ids = scalar[np.asarray(m.jnt_limited, dtype=bool)[scalar]]
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
    aref: torch.Tensor         # (nl, B) reference acceleration
    R: torch.Tensor            # regularizer (1/D)
    active: torch.Tensor
    diag: torch.Tensor         # approx diag(A + R) (invweight + R)
    pos: torch.Tensor          # margin-adjusted limit distance
    k: torch.Tensor            # solref/solimp stiffness
    b: torch.Tensor            # solref/solimp damping


@dataclasses.dataclass
class ConGroup:
    """One condim group's selected contact island."""
    condim: int
    K: int
    sel: torch.Tensor          # (K, B) slot indices into contact arrays
    jac: torch.Tensor          # (K, dim, nv, B)
    aref: torch.Tensor         # (K, dim, B)
    R: torch.Tensor            # (K, dim, B) regularizer per row
    mu: torch.Tensor           # (K, B) sliding friction
    active: torch.Tensor       # (K, B)
    diag: torch.Tensor         # (K, B) approx diag(A + R) of the normal row


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
    dadr = m.ix(meta.limit_dadr)
    vel = sign * d.qvel[dadr]
    aref = -b * vel - k * pos
    invweight = m.dof_invweight0[dadr][:, None]
    R = torch.clamp((1.0 - imp) / imp * invweight, min=1e-12)
    return Limits(dadr=meta.limit_dadr, sign=sign, aref=aref, R=R,
                  active=(pos < 0.0).to(q.dtype), diag=invweight + R,
                  pos=pos, k=k, b=b)


def _contact_groups(m: Model, d: Data, meta: EfcMeta) -> list[ConGroup]:
    """Constraint rows of the SELECTED contacts (collision() already chose
    the top-K islands and evaluated solref/solimp), one ConGroup per
    (condim, K) of ``meta.groups``. The JAX package's one-hot body
    contraction is an index gather of the (nbody, nv) dof-support table."""
    if m.ncon_max == 0 and m.nccd == 0:
        return []
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    con = d.contact
    maskd = m.const(np.asarray(m.body_dof_mask, np.float64))  # (nbody, nv)

    comroot = d.subtree_com[joint_plan(m).dof_root]   # (nv, 3, B)
    ang = d.cdof[:, :3]                          # (nv, 3, B)
    base = d.cdof[:, 3:] - bq.cross(ang, comroot)

    out = []
    off = 0
    for cd, K in meta.groups:
        sl = slice(off, off + K)
        off += K
        pos_c = con.dist[sl] - con.margin[sl]    # (K, B)
        k_, b_, R_n = con.k[sl], con.b[sl], con.R[sl]
        # dof-support difference of the two bodies: (K, nv, B)
        mdiff = (maskd[con.b2[sl].long()]
                 - maskd[con.b1[sl].long()]).permute(0, 2, 1)
        ndim = min(cd, 3)
        # point jacobian rows: jacp[k, v] = base_v + ang_v x p_k
        jacp = base[None] + bq.cross(
            ang[None].expand((K,) + ang.shape),
            con.pos[sl][:, None].expand(K, m.nv, 3, B))
        jacp = jacp * mdiff[:, :, None, :]       # (K, nv, 3, B)
        # project onto the frame rows: J (K, dim, nv, B)
        jac = torch.einsum("kdcB,kvcB->kdvB", con.frame[sl][:, :ndim], jacp)

        vel = torch.einsum("kdvB,vB->kdB", jac, d.qvel)
        aref_n = -b_ * vel[:, 0] - k_ * pos_c
        if ndim > 1:
            R_f = R_n / torch.clamp(m.opt.impratio, min=1e-12)
            aref = torch.cat([aref_n[:, None],
                              -b_[:, None] * vel[:, 1:ndim]], dim=1)
            R = torch.cat([R_n[:, None],
                           R_f[:, None].expand(K, ndim - 1, B)], dim=1)
        else:
            aref = aref_n[:, None]
            R = R_n[:, None]
        out.append(ConGroup(
            condim=cd, K=K, sel=con.sel[sl], jac=jac, aref=aref, R=R,
            mu=con.mu[sl], active=(pos_c < 0.0).to(dtype),
            diag=con.invw[sl] + R_n))
    return out


def make_efc(m: Model, d: Data, meta: EfcMeta | None = None):
    """Assemble the selected constraint rows -> (Limits | None,
    [ConGroup])."""
    meta = meta or efc_meta(m)
    return limit_rows(m, d, meta), _contact_groups(m, d, meta)


def solve(m: Model, d: Data, iterations: int | None = None, efc=None,
          fresh: bool = True) -> Data:
    """Constraint solve: qacc, qfrc_constraint from the smooth solution.

    ``efc`` may be a prebuilt (Limits, [ConGroup]) pair. ``fresh`` is False
    on the selection-persistent update substeps of the Model.col_refresh
    schedule: the fused solver then reuses its stored row selection and
    raw warm forces (the other solvers ignore it)."""
    meta = efc_meta(m)
    if len(meta.limit_ids) == 0 and m.ncon_max == 0 and m.nccd == 0:
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qvel))
    solver = m.opt.contact_solver
    if solver == "fused":
        from flybody_tpu_torch.physics import solver_fused
        return solver_fused.solve_fused(m, d, iterations=iterations,
                                        fresh=fresh)
    if solver not in ("apgd", "admm", "admm_kernel"):
        raise ValueError(f"unknown contact_solver {solver!r}")
    lim, groups = efc if efc is not None else make_efc(m, d, meta)
    # fixed iteration counts; the per-method defaults reflect measured
    # warm-started convergence (dense ADMM reaches <1% qacc error in ~20
    # iterations, matrix-free APGD needs more; oracle comparisons pass
    # explicit higher counts)
    if solver in ("admm", "admm_kernel"):
        from flybody_tpu_torch.physics import solver_dense
        niter = iterations if iterations is not None else min(
            m.opt.solver_iterations, 20)
        f_lim, f_groups = solver_dense.solve_dual_dense(
            m, d, lim, groups, iterations=niter,
            noslip_iterations=m.opt.noslip_iterations,
            use_kernel=solver == "admm_kernel")
    else:
        from flybody_tpu_torch.physics import solver as SV
        niter = iterations if iterations is not None else min(
            m.opt.solver_iterations, 16)
        f_lim, f_groups = SV.solve_dual(
            m, d, lim, groups, iterations=niter,
            noslip_iterations=m.opt.noslip_iterations)

    # qfrc_constraint = J^T f
    qfrc = torch.zeros_like(d.qvel)
    if lim is not None:
        qfrc.index_add_(0, m.ix(lim.dadr), lim.sign * f_lim)
    for g, f in zip(groups, f_groups):
        qfrc = qfrc + torch.einsum("kdvB,kdB->vB", g.jac, f)
    from flybody_tpu_torch.physics import smooth as S
    qacc = d.qacc_smooth + S.solve_m(m, d, qfrc)

    # finiteness guard: a degenerate solve falls back to the smooth
    # solution for that env
    ok = torch.all(torch.isfinite(qacc), dim=0)      # (B,)
    qacc = torch.where(ok, qacc, d.qacc_smooth)
    qfrc = torch.where(ok, qfrc, torch.zeros_like(qfrc))
    okf = ok.to(qacc.dtype)

    # compact selected-force bookkeeping (warm start + force consumers)
    if groups:
        warm_sel = torch.cat([g.sel for g in groups], dim=0)
        warm_f = torch.cat([
            torch.cat([f, f.new_zeros((g.K, 3 - f.shape[1], f.shape[-1]))],
                      dim=1) * okf
            for g, f in zip(groups, f_groups)], dim=0)
    else:
        warm_sel, warm_f = d.warm_sel, d.warm_f
    warm_lim = f_lim * okf if lim is not None else d.warm_lim
    return d.replace(qacc=qacc, qfrc_constraint=qfrc,
                     warm_sel=warm_sel.to(torch.int32), warm_f=warm_f,
                     warm_lim=warm_lim)
