"""Sparse kinematic-tree LDL^T factorization, batched over trailing envs.

The joint-space inertia M of a kinematic tree is nonzero only where dof j
is an ancestor of dof i (or i == j): 586 values for the fly's 105 dofs.
The factorization runs as a level-parallel schedule over the tree: all dofs
of one subtree height eliminate at once, so each level is a few gathers and
scatter-adds over the compressed (nM, ..., B) values.

Convention: M = L^T D L with L unit-lower ("row i holds entries at its
ancestor columns j"), MuJoCo's qLD convention. Solves:
    M^{-1} b = L^{-1} D^{-1} L^{-T} b.

Scatter-adds use ``index_add_``: an index repeats whenever two dofs of a
level share an ancestor, and plain indexed assignment would drop all but
one of the updates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True, eq=False)
class TreeMeta:
    """Static sparse layout + elimination schedule for one tree."""

    nv: int
    nM: int
    # entry e -> (row dof i, col dof j<=i); grouped by i
    entry_i: np.ndarray        # (nM,)
    entry_j: np.ndarray        # (nM,)
    diag_entry: np.ndarray     # (nv,) entry index of (i, i)
    levels: tuple              # factor schedule: dicts of index arrays
    solve_up: tuple            # leaves->root levels: (i_arr, e_arr, j_arr)
    solve_down: tuple          # root->leaves levels: same triplets
    anc_lists: tuple           # per dof: ancestor dofs, nearest first
    # device copies of the index arrays, built on first use per device
    _dev: dict = dataclasses.field(default_factory=dict, repr=False)

    def on(self, device) -> dict:
        """The schedule's index arrays as int64 tensors on ``device``."""
        key = str(torch.device(device))
        t = self._dev.get(key)
        if t is None:
            ix = lambda a: torch.as_tensor(np.asarray(a, np.int64),
                                           device=device)
            off = self.entry_i != self.entry_j
            t = dict(
                entry_i=ix(self.entry_i), entry_j=ix(self.entry_j),
                diag_entry=ix(self.diag_entry),
                off_i=ix(self.entry_i[off]), off_j=ix(self.entry_j[off]),
                off_e=ix(np.nonzero(off)[0]),
                levels=tuple({k: ix(v) for k, v in lev.items()}
                             for lev in self.levels),
                up=tuple(tuple(ix(a) for a in trip)
                         for trip in self.solve_up),
                down=tuple(tuple(ix(a) for a in trip)
                           for trip in self.solve_down),
            )
            self._dev[key] = t
        return t


def build_tree_meta(dof_parentid: np.ndarray) -> TreeMeta:
    dp = np.asarray(dof_parentid)
    nv = len(dp)

    anc = []  # ancestors excluding self, nearest first
    for i in range(nv):
        lst = []
        j = dp[i]
        while j >= 0:
            lst.append(int(j))
            j = dp[j]
        anc.append(lst)

    # entry table: for each i, columns j in ancestors+self, ascending j
    entry_i, entry_j = [], []
    eidx = {}
    for i in range(nv):
        for j in sorted(anc[i]) + [i]:
            eidx[(i, j)] = len(entry_i)
            entry_i.append(i)
            entry_j.append(j)
    nM = len(entry_i)
    diag_entry = np.array([eidx[(i, i)] for i in range(nv)], dtype=np.int32)

    # subtree height per dof: 0 for dofs with no dof-children
    children = [[] for _ in range(nv)]
    for i in range(nv):
        if dp[i] >= 0:
            children[dp[i]].append(i)
    height = np.zeros(nv, dtype=np.int32)
    for i in range(nv - 1, -1, -1):  # children have larger indices
        for c in children[i]:
            height[i] = max(height[i], height[c] + 1)

    levels = []
    for h in range(int(height.max()) + 1 if nv else 0):
        dofs = np.nonzero(height == h)[0]
        if len(dofs) == 0:
            continue
        diag_e = diag_entry[dofs]
        row_e, row_of = [], []
        for k, i in enumerate(dofs):
            for j in sorted(anc[i]):
                row_e.append(eidx[(i, j)])
                row_of.append(k)
        # Schur updates: M[a, b] -= (M[i, a] / D[i]) * M[i, b] for each
        # ancestor pair (a, b) of i with b <= a
        row_pos = {int(e): k for k, e in enumerate(row_e)}
        upd_t, upd_a_pos, upd_b = [], [], []
        for i in dofs:
            cols = sorted(anc[i])
            for x, a_ in enumerate(cols):
                for b_ in cols[: x + 1]:
                    upd_t.append(eidx[(a_, b_)] if a_ >= b_ else
                                 eidx[(b_, a_)])
                    upd_a_pos.append(row_pos[eidx[(i, a_)]])
                    upd_b.append(eidx[(i, b_)])
        levels.append(dict(
            dofs=np.asarray(dofs, np.int32),
            diag_e=np.asarray(diag_e, np.int32),
            row_e=np.asarray(row_e, np.int32),
            row_of=np.asarray(row_of, np.int32),
            upd_t=np.asarray(upd_t, np.int32),
            upd_a_pos=np.asarray(upd_a_pos, np.int32),
            upd_b=np.asarray(upd_b, np.int32),
        ))

    # solve schedules: triplets (i, e, j): x[j] -= L[e] x[i] (up) or
    # x[i] -= L[e] x[j] (down), grouped by the processed dof's level
    up_levels, down_levels = [], []
    for h in range(int(height.max()) + 1 if nv else 0):
        dofs = np.nonzero(height == h)[0]
        if len(dofs) == 0:
            continue
        ii, ee, jj = [], [], []
        for i in dofs:
            for j in anc[i]:
                ii.append(i); ee.append(eidx[(i, j)]); jj.append(j)
        up_levels.append((np.asarray(ii, np.int32), np.asarray(ee, np.int32),
                          np.asarray(jj, np.int32)))
    depth = np.zeros(nv, dtype=np.int32)
    for i in range(nv):
        depth[i] = 0 if dp[i] < 0 else depth[dp[i]] + 1
    for dlev in range(int(depth.max()) + 1 if nv else 0):
        dofs = np.nonzero(depth == dlev)[0]
        if len(dofs) == 0:
            continue
        ii, ee, jj = [], [], []
        for i in dofs:
            for j in anc[i]:
                ii.append(i); ee.append(eidx[(i, j)]); jj.append(j)
        if ii:
            down_levels.append((np.asarray(ii, np.int32),
                                np.asarray(ee, np.int32),
                                np.asarray(jj, np.int32)))

    return TreeMeta(
        nv=nv, nM=nM,
        entry_i=np.asarray(entry_i, np.int32),
        entry_j=np.asarray(entry_j, np.int32),
        diag_entry=diag_entry, levels=tuple(levels),
        solve_up=tuple(up_levels), solve_down=tuple(down_levels),
        anc_lists=tuple(tuple(a) for a in anc),
    )


def flat_up(tree: TreeMeta) -> np.ndarray:
    """(n, 3) int32 up-sweep triplets (i, e, j), leaves-first order."""
    return np.concatenate([np.stack(t, axis=1) for t in tree.solve_up]
                          ).astype(np.int32)


def flat_down(tree: TreeMeta) -> np.ndarray:
    """(n, 3) int32 down-sweep triplets (i, e, j), root-first order."""
    return np.concatenate([np.stack(t, axis=1) for t in tree.solve_down]
                          ).astype(np.int32)


def _expand(ld: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Insert unit axes after dim 0 of ``ld`` so it broadcasts against x's
    extra middle dims ((nM, B) vs x (nv, R, B))."""
    extra = x.ndim - ld.ndim
    if extra <= 0:
        return ld
    return ld.reshape(ld.shape[:1] + (1,) * extra + ld.shape[1:])


def sparse_to_dense(meta: TreeMeta, Ms: torch.Tensor) -> torch.Tensor:
    """(nM, B) -> symmetric dense (nv, nv, B)."""
    t = meta.on(Ms.device)
    out = Ms.new_zeros((meta.nv, meta.nv) + Ms.shape[1:])
    out[t["entry_i"], t["entry_j"]] = Ms
    out[t["entry_j"], t["entry_i"]] = Ms
    return out


def factor(meta: TreeMeta, Ms: torch.Tensor):
    """LDL^T factorization of compressed M (nM, ...B).

    Returns (LD, Dinv): LD (nM, ...B) holds L off-diagonals at off-diagonal
    entries and D at diagonal entries; Dinv (nv, ...B) = 1 / D."""
    t = meta.on(Ms.device)
    buf = Ms.clone()
    for lev in t["levels"]:
        Di = buf[lev["diag_e"]]
        if len(lev["row_e"]):
            Li = buf[lev["row_e"]] / Di[lev["row_of"]]
            if len(lev["upd_t"]):
                upd = -Li[lev["upd_a_pos"]] * buf[lev["upd_b"]]
                buf.index_add_(0, lev["upd_t"], upd)
            buf[lev["row_e"]] = Li
    Dinv = 1.0 / buf[t["diag_entry"]]
    return buf, Dinv


def solve(meta: TreeMeta, LD: torch.Tensor, Dinv: torch.Tensor,
          b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b. b: (nv, ...B) or (nv, R, ...B)."""
    t = meta.on(b.device)
    x = b.clone()
    ld = _expand(LD, x)
    # x <- L^{-T} x : push descendant values into ancestors (leaves first)
    for ii, ee, jj in t["up"]:
        x.index_add_(0, jj, -ld[ee] * x[ii])
    x = x * _expand(Dinv, x)
    # x <- L^{-1} x : subtract ancestor values (root first)
    for ii, ee, jj in t["down"]:
        x.index_add_(0, ii, -ld[ee] * x[jj])
    return x


def solve_down(meta: TreeMeta, LD: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """x <- L^{-1} x (root-first sweep only). x (nv, ...B)."""
    t = meta.on(x.device)
    x = x.clone()
    ld = _expand(LD, x)
    for ii, ee, jj in t["down"]:
        x.index_add_(0, ii, -ld[ee] * x[jj])
    return x


def mul_lt(meta: TreeMeta, LD: torch.Tensor, x: torch.Tensor):
    """L^T @ x with unit-diagonal L from the factor. x (nv, ...B).

    (L^T x)[j] = x[j] + sum over off-diag entries (i, e, j) of L[e] x[i]."""
    t = meta.on(x.device)
    ld = _expand(LD, x)
    out = x.clone()
    for ii, ee, jj in t["up"]:
        out.index_add_(0, jj, ld[ee] * x[ii])
    return out


def matmul(meta: TreeMeta, Ms: torch.Tensor, v: torch.Tensor):
    """M @ v with compressed symmetric M. v: (nv, ...B) -> (nv, ...B)."""
    t = meta.on(v.device)
    ms = _expand(Ms, v)
    out = torch.zeros_like(v)
    out.index_add_(0, t["entry_i"], ms * v[t["entry_j"]])
    out.index_add_(0, t["off_j"], ms[t["off_e"]] * v[t["off_i"]])
    return out
