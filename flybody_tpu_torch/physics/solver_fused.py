"""Fused flat-row dual contact solver (the production path).

The soft-constraint dual QP of MuJoCo's model, in four parts:

1. Solver-active row selection: the top ``fused_sel[0]`` limit rows by
   margin-adjusted distance, all condim-1 contact rows, and the top
   ``fused_sel[1]`` friction cones across all cone groups by effective
   penetration.
2. The compact row form J[r, v] = mdiff[r, v] * (u6_r . D6_v) (+ the limit
   rows' sign * e_dadr), built for the selected rows only.
3. The whole dual solve in one kernel (ops/solver_kernels.solve_rows): J
   build, up-solve Yd = D^{-1/2} L^{-T} J^T, APGD with its noslip pass and
   the two output tree sweeps. The profiling stage split (``_stage``) runs
   the same solve as two kernels with Yd in device memory between them.
4. Within a col_refresh window (fresh=False) the row selection persists
   (Data.sol_lim_sel / sol_cone_sel) and APGD warm-starts from the raw
   previous forces (Data.sol_f) with 2 power iterations instead of 3.

Selections are stable sorts (ties to the lower index, as lax.top_k) and
the JAX package's one-hot row moves are index gathers (ops/rows).
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import bquat as bq
from flybody_tpu_torch.ops import rows
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.physics.kinematics import joint_plan
from flybody_tpu_torch.physics.types import Data, Model


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def fused_layout(m: Model, meta) -> dict:
    """Static row layout of the fused solver for this model: n_lim
    (selected limit rows), c1 / cone (row ranges in the Contact arrays),
    k1, s_cone (cone candidates), k_cone (selected), kl (nonneg segment
    incl. padding), kc, R = kl + 3 kc."""
    sel = m.fused_sel if m.fused_sel is not None else (24, 24)
    n_lim = min(int(sel[0]), len(meta.limit_ids))
    c1_ranges, cone_ranges = [], []
    off = 0
    for cd, K in meta.groups:
        (c1_ranges if cd == 1 else cone_ranges).append((off, off + K))
        off += K
    k1 = sum(b - a for a, b in c1_ranges)
    s_cone = sum(b - a for a, b in cone_ranges)
    k_cone = min(int(sel[1]), s_cone)
    kl = _round_up(n_lim + k1, 8)
    kc = _round_up(k_cone, 8) if k_cone else 0
    return dict(n_lim=n_lim, c1=tuple(c1_ranges), cone=tuple(cone_ranges),
                k1=k1, s_cone=s_cone, k_cone=k_cone, kl=kl, kc=kc,
                R=kl + 3 * kc)


def dof_basis(m: Model, d: Data) -> torch.Tensor:
    """D6 (nv, 6, B): [base (3), ang (3)] with base = lin - ang x comroot,
    so that J[r, v] = u6_r . D6_v on the dof-support mask."""
    comroot = d.subtree_com[joint_plan(m).dof_root]
    ang = d.cdof[:, :3]
    lin = d.cdof[:, 3:]
    return torch.cat([lin - bq.cross(ang, comroot), ang], dim=-2)


def _match(sel, warm_sel, warm_f):
    """Previous forces of the rows whose slot id reappears: for each row
    k, warm_f[j] where warm_sel[j] == sel[k], else 0. sel (K, B),
    warm_sel (J, B), warm_f (J, C, B) -> (K, C, B)."""
    hit = sel[:, None, :] == warm_sel[None, :, :]        # (K, J, B)
    src = torch.argmax(hit.to(torch.int8), dim=1)       # (K, B)
    got = rows.take(warm_f, src)
    return torch.where(hit.any(dim=1)[:, None, :], got,
                       torch.zeros_like(got))


def assemble(m: Model, d: Data, iterations: int | None = None,
             fresh: bool = True) -> dict | None:
    """Row assembly: the selected rows in compact form. Returns None when
    the model has no solver rows, else a dict with ``args`` (the tensors
    of ``solve_rows`` by name), ``kw`` (its static keywords) and the
    selection bookkeeping ``solve_fused`` writes back into Data."""
    from flybody_tpu_torch.physics import constraint as C
    meta = C.efc_meta(m)
    dtype = d.qpos.dtype
    dev = d.qpos.device
    B = d.qpos.shape[-1]
    lay = fused_layout(m, meta)
    n_lim, k1, k_cone = lay["n_lim"], lay["k1"], lay["k_cone"]
    kl, kc, R = lay["kl"], lay["kc"], lay["R"]
    if R == 0:
        return None
    niter = iterations if iterations is not None else min(
        m.opt.solver_iterations, 20)
    con = d.contact
    i32 = torch.int32

    u6_l, b1_l, b2_l, ls_l, la_l = [], [], [], [], []
    k_l, b_l, pos_l, r_l, act_l, f0_l = [], [], [], [], [], []
    zeros = lambda n: d.qpos.new_zeros((n, B))

    def plain_rows(n):
        ls_l.append(zeros(n))
        la_l.append(torch.full((n, B), -1, dtype=i32, device=dev))

    # ---- limit rows (top-n_lim by margin-adjusted distance) ----------
    lim = C.limit_rows(m, d, meta)
    idx_lim = None
    if n_lim:
        nl = lim.sign.shape[0]
        if n_lim < nl:
            if fresh or d.sol_lim_sel.shape[0] != n_lim:
                idx = rows.smallest_k(lim.pos, n_lim)
            else:
                idx = d.sol_lim_sel.long()
        else:
            idx = torch.arange(nl, device=dev)[:, None].expand(nl, B)
        idx_lim = idx
        pay = torch.stack([x.expand(nl, B) for x in (
            lim.sign, lim.k, lim.b, lim.pos, lim.R, lim.active,
            d.warm_lim.to(dtype))], dim=1)
        sl = rows.take(pay, idx)                          # (n_lim, 7, B)
        u6_l.append(d.qpos.new_zeros((n_lim, 6, B)))
        b1_l.append(torch.zeros((n_lim, B), dtype=i32, device=dev))
        b2_l.append(torch.zeros((n_lim, B), dtype=i32, device=dev))
        ls_l.append(sl[:, 0])
        la_l.append(m.ix(lim.dadr)[idx].to(i32))
        k_l.append(sl[:, 1])
        b_l.append(sl[:, 2])
        pos_l.append(sl[:, 3])
        r_l.append(sl[:, 4])
        act_l.append(sl[:, 5])
        f0_l.append(sl[:, 6])

    def con_slice(ranges, field):
        return torch.cat([field[a:b] for a, b in ranges], dim=0)

    def u6_of(frame_d, pos):
        """[frame row (3), p x frame row (3)] -> (..., 6, B)."""
        return torch.cat([frame_d, bq.cross(pos, frame_d)], dim=-2)

    # warm start: within a refresh window the row order is unchanged and
    # the previous substep's raw forces (sol_f) are the start; otherwise
    # rows are matched by slot id to the previous compact forces
    use_sol_f = not fresh and d.sol_f.shape[0] == R
    k_warm = k1 + kc
    warm_sel = d.warm_sel[:k_warm]
    warm_f = d.warm_f[:k_warm].to(dtype)

    # ---- condim-1 rows: all of them ----------------------------------
    sel_c1 = None
    if k1:
        rng = lay["c1"]
        u6_l.append(u6_of(con_slice(rng, con.frame)[:, 0],
                          con_slice(rng, con.pos)))
        b1_l.append(con_slice(rng, con.b1))
        b2_l.append(con_slice(rng, con.b2))
        plain_rows(k1)
        pos_c1 = con_slice(rng, con.dist) - con_slice(rng, con.margin)
        k_l.append(con_slice(rng, con.k))
        b_l.append(con_slice(rng, con.b))
        pos_l.append(pos_c1)
        r_l.append(con_slice(rng, con.R))
        act_l.append((pos_c1 < 0.0).to(dtype))
        sel_c1 = con_slice(rng, con.sel)
        if not use_sol_f:
            f0_l.append(_match(sel_c1, warm_sel, warm_f)[:, 0])

    # pad the nonneg segment to kl rows (rreg 1, inactive)
    pad_nn = kl - n_lim - k1
    if pad_nn:
        u6_l.append(d.qpos.new_zeros((pad_nn, 6, B)))
        b1_l.append(torch.zeros((pad_nn, B), dtype=i32, device=dev))
        b2_l.append(torch.zeros((pad_nn, B), dtype=i32, device=dev))
        plain_rows(pad_nn)
        for lst in (k_l, b_l, pos_l, act_l, f0_l):
            lst.append(zeros(pad_nn))
        r_l.append(d.qpos.new_ones((pad_nn, B)))

    # ---- cone selection (top-k_cone by effective penetration) --------
    mu_sel = d.qpos.new_zeros((max(kc, 1), B))
    sel_cone = None
    idx_cone = None
    if kc:
        rng = lay["cone"]
        s_cone = lay["s_cone"]
        eff = con_slice(rng, con.dist) - con_slice(rng, con.margin)
        payload = torch.cat([
            con_slice(rng, con.pos),                          # 0:3
            con_slice(rng, con.frame).reshape(s_cone, 9, B),  # 3:12
            con_slice(rng, con.k)[:, None],                   # 12
            con_slice(rng, con.b)[:, None],                   # 13
            con_slice(rng, con.R)[:, None],                   # 14
            con_slice(rng, con.mu)[:, None],                  # 15
            eff[:, None],                                     # 16
        ], dim=1)
        ids = torch.stack([con_slice(rng, con.b1), con_slice(rng, con.b2),
                           con_slice(rng, con.sel)], dim=1)   # (s, 3, B)
        if k_cone < s_cone:
            if fresh or d.sol_cone_sel.shape[0] != k_cone:
                idx = rows.smallest_k(eff, k_cone)
            else:
                idx = d.sol_cone_sel.long()
            idx_cone = idx
            pay = rows.take(payload, idx)
            pid = rows.take(ids, idx)
        else:
            pay, pid = payload, ids
        if kc > k_cone:   # pad cones (inactive)
            pad = d.qpos.new_zeros((kc - k_cone, pay.shape[1], B))
            pad[:, 16] = 1.0
            pay = torch.cat([pay, pad], dim=0)
            pid_pad = torch.zeros((kc - k_cone, 3, B), dtype=pid.dtype,
                                  device=dev)
            pid_pad[:, 2] = -1
            pid = torch.cat([pid, pid_pad], dim=0)
        posc = pay[:, 0:3]
        frame = pay[:, 3:12].reshape(kc, 3, 3, B)
        k_c, b_c, r_c = pay[:, 12], pay[:, 13], pay[:, 14]
        pos_cc = pay[:, 16]
        b1_c, b2_c = pid[:, 0].to(i32), pid[:, 1].to(i32)
        sel_cone = pid[:, 2].to(i32)
        act_c = (pos_cc < 0.0).to(dtype)
        u6c = u6_of(frame, posc[:, None])                 # (kc, 3, 6, B)
        # segment-major cone rows: [normals | tangent1 | tangent2]
        for j in range(3):
            u6_l.append(u6c[:, j])
            b1_l.append(b1_c)
            b2_l.append(b2_c)
            plain_rows(kc)
        zero = torch.zeros_like(k_c)
        r_t = r_c / torch.clamp(m.opt.impratio, min=1e-12)
        k_l += [k_c, zero, zero]
        b_l += [b_c, b_c, b_c]
        pos_l += [pos_cc, zero, zero]
        r_l += [r_c, r_t, r_t]
        act_l += [act_c, act_c, act_c]
        mu_sel = pay[:, 15]
        if not use_sol_f:
            fprev = _match(sel_cone, warm_sel, warm_f)    # (kc, 3, B)
            f0_l += [fprev[:, 0], fprev[:, 1], fprev[:, 2]]

    f0 = d.sol_f.to(dtype) if use_sol_f else torch.cat(f0_l, dim=0)
    warm_v = d.apgd_v.to(dtype) if d.apgd_v.shape[0] == R else None
    cat = lambda lst: torch.cat(lst, dim=0).contiguous()
    args = dict(
        d6=dof_basis(m, d).contiguous(), u6=cat(u6_l), b1=cat(b1_l),
        b2=cat(b2_l), lim_sign=cat(ls_l), lim_dadr=cat(la_l),
        maskd=m.const(np.asarray(m.body_dof_mask, np.float64)),
        ld=d.qLD.contiguous(), dinv=d.qLDiagInv.contiguous(),
        qacc_smooth=d.qacc_smooth.contiguous(), qvel=d.qvel.contiguous(),
        kcoef=cat(k_l), bcoef=cat(b_l), posr=cat(pos_l), rreg=cat(r_l),
        active=cat(act_l), mu=mu_sel.contiguous(), f0=f0.contiguous(),
        v0=(warm_v.contiguous() if warm_v is not None else None))
    kw = dict(kl=kl, kc=kc, iterations=int(niter),
              noslip_iterations=int(m.opt.noslip_iterations),
              power_iters=(4 if warm_v is None else (3 if fresh else 2)))
    return dict(args=args, kw=kw, lay=lay, idx_lim=idx_lim,
                idx_cone=idx_cone, sel_c1=sel_c1, sel_cone=sel_cone)


def _probe(d: Data, probe: torch.Tensor) -> Data:
    """The smooth solution plus 0 * probe: a profiling stage's result
    depends on what it computed, as in the JAX package."""
    return d.replace(qacc=d.qacc_smooth + 0.0 * probe[None, :])


_STAGES = ("assembly", "yd", "apgd", "full")


def solve_fused(m: Model, d: Data, iterations: int | None = None,
                _stage: str = "full", fresh: bool = True) -> Data:
    """constraint.solve for contact_solver='fused' (see module doc).

    ``_stage`` is a profiling knob: "assembly" stops after the row
    assembly, "yd" after the ``upsolve_build_yd`` kernel, "apgd" after the
    ``apgd_iterate`` kernel (the two-kernel stage split of the same
    solve); each returns the smooth qacc plus 0 * a probe of what it
    computed. "full" (the default) is the production path: one
    ``solve_rows`` kernel."""
    if _stage not in _STAGES:
        raise ValueError(f"_stage must be one of {_STAGES}, not {_stage!r}")
    prob = assemble(m, d, iterations=iterations, fresh=fresh)
    if prob is None:
        return d.replace(qacc=d.qacc_smooth,
                         qfrc_constraint=torch.zeros_like(d.qvel))
    args, kw = prob["args"], prob["kw"]
    if _stage == "assembly":
        return _probe(d, torch.sum(args["u6"], dim=(0, 1))
                      + torch.sum(args["kcoef"], dim=0)
                      + torch.sum(args["f0"], dim=0)
                      + torch.sum(args["active"], dim=0))
    if _stage in ("yd", "apgd"):
        yd, bvec = SK.upsolve_build_yd(
            m.tree, *(args[k] for k in (
                "d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd",
                "ld", "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef",
                "posr")))
        if _stage == "yd":
            return _probe(d, torch.sum(yd, dim=(0, 1))
                          + torch.sum(bvec, dim=0))
        f, ystar, _ = SK.apgd_iterate(
            yd, bvec, args["rreg"], args["active"], args["mu"], args["f0"],
            args["v0"], **kw)
        return _probe(d, torch.sum(f, dim=0) + torch.sum(ystar, dim=0))

    lay = prob["lay"]
    n_lim, k1, kl, kc, R = (lay["n_lim"], lay["k1"], lay["kl"], lay["kc"],
                            lay["R"])
    dtype = d.qpos.dtype
    B = d.qpos.shape[-1]
    f, v_new, qfrc, dqacc = SK.solve_rows(m.tree, **args, **kw)
    qacc = d.qacc_smooth + dqacc

    # finiteness guard (physics semantics: a degenerate solve falls back
    # to the smooth solution for that env)
    ok = torch.all(torch.isfinite(qacc), dim=0)
    qacc = torch.where(ok, qacc, d.qacc_smooth)
    qfrc = torch.where(ok, qfrc, torch.zeros_like(qfrc))
    okf = ok.to(dtype)

    # ---- warm bookkeeping (compact selected forces) --------------------
    ksum = d.warm_sel.shape[0]
    sel_parts, f3_parts = [], []
    if k1:
        sel_parts.append(prob["sel_c1"])
        f1 = f[n_lim:n_lim + k1]
        f3_parts.append(torch.stack(
            [f1, torch.zeros_like(f1), torch.zeros_like(f1)], dim=1))
    if kc:
        sel_parts.append(prob["sel_cone"])
        f3_parts.append(torch.stack(
            [f[kl:kl + kc], f[kl + kc:kl + 2 * kc], f[kl + 2 * kc:]], dim=1))
    if sel_parts:
        warm_sel = torch.cat(sel_parts, dim=0)
        warm_f = torch.cat(f3_parts, dim=0) * okf
        npad = ksum - warm_sel.shape[0]
        if npad > 0:
            warm_sel = torch.cat([warm_sel, torch.full(
                (npad, B), -1, dtype=torch.int32, device=f.device)], dim=0)
            warm_f = torch.cat([warm_f, f.new_zeros((npad, 3, B))], dim=0)
    else:
        warm_sel, warm_f = d.warm_sel, d.warm_f
    idx_lim = prob["idx_lim"]
    if n_lim:
        nl = d.warm_lim.shape[0]
        warm_lim = rows.add_rows((f[:n_lim] * okf)[:, None], idx_lim,
                                 nl)[:, 0]
    else:
        warm_lim = d.warm_lim
    # an env whose solve failed keeps its power vector: a non-finite one
    # would start every later solve of the env (auto-reset keeps it)
    apgd_v = torch.where(ok, v_new.to(d.apgd_v.dtype), d.apgd_v) \
        if d.apgd_v.shape[0] == R else d.apgd_v
    # persist the row selection + raw forces for the window's update
    # substeps (consumed when fresh=False)
    if idx_lim is None or idx_lim.shape[0] != d.sol_lim_sel.shape[0]:
        idx_lim = d.sol_lim_sel
    idx_cone = prob["idx_cone"]
    k_cone = lay["k_cone"]
    if idx_cone is None or idx_cone.shape[0] != d.sol_cone_sel.shape[0]:
        idx_cone = (torch.arange(k_cone, device=f.device)[:, None]
                    .expand(k_cone, B)
                    if kc and d.sol_cone_sel.shape[0] == k_cone
                    else d.sol_cone_sel)
    sol_f = (f * okf).to(d.sol_f.dtype) if d.sol_f.shape[0] == R \
        else d.sol_f
    return d.replace(qacc=qacc, qfrc_constraint=qfrc,
                     warm_sel=warm_sel.to(torch.int32), warm_f=warm_f,
                     warm_lim=warm_lim, apgd_v=apgd_v,
                     sol_lim_sel=idx_lim.to(torch.int32),
                     sol_cone_sel=idx_cone.to(torch.int32), sol_f=sol_f)
