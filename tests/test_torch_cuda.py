"""The port's CUDA kernels on the card, and the wrappers' refusal to fall
back anywhere else. JAX-free, so a GPU machine without JAX can run it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py imports JAX).
The tests marked ``cuda`` skip where no CUDA device is present."""

import os
import shutil

import numpy as np
import pytest
import torch

from flybody_tpu_torch.ops import admm_kernel as AK
from flybody_tpu_torch.ops import cuda_build
from flybody_tpu_torch.ops import linalg as LA
from flybody_tpu_torch.ops import solver_kernels as SK
from flybody_tpu_torch.ops import tree_ldl as TL
from flybody_tpu_torch.physics import solver_dense as SD
from flybody_tpu_torch import profile_solve_rows as PS

KW = dict(kl=32, kc=40, iterations=20, noslip_iterations=3, power_iters=4)
ROW_ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
            "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr")
UP_ARGS = ROW_ARGS[7:]
APGD_ARGS = ("rreg", "active", "mu", "f0", "v0")
ADMM_KW = dict(kl=40, kc=62, iterations=20)     # wob-admm: 226 rows


def _imitation_parent():
    """walk_imitation's dof tree: the free root's six dofs above every
    hinge (from the committed model; numpy only)."""
    from flybody_tpu_torch.tasks import walk_imitation as WI
    return WI.load_model()["dof_parentid"]


def _flight_parent():
    """flight_imitation's dof tree: the free root above the wing and the
    remaining body joints, 42 dofs (from the committed model)."""
    from flybody_tpu_torch.tasks import flight_imitation as FI
    return FI.load_model()["dof_parentid"]


def _problem(device, dtype, B=8, **shape):
    if shape.pop("imitation_tree", False):
        shape["parent"] = _imitation_parent()
    if shape.pop("flight_tree", False):
        shape["parent"] = _flight_parent()
    p = SK.random_rows_problem(B=B, seed=1, **shape)
    tree = TL.build_tree_meta(p["parent"])
    ld, dinv = TL.factor(tree, torch.as_tensor(p["Ms"], device=device).to(
        dtype))
    args = {k: torch.as_tensor(p[k], device=device).to(
        torch.int32 if p[k].dtype == np.int32 else dtype)
        for k in ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd",
                  "qacc_smooth", "qvel", "kcoef", "bcoef", "posr", "rreg",
                  "active", "mu", "f0", "v0")}
    args.update(ld=ld, dinv=dinv)
    return tree, args


def _admm_problem(device, dtype, B=8, seed=2, kl=ADMM_KW["kl"],
                  kc=ADMM_KW["kc"], extra=0):
    """W = (A_s + rho I)^-1 of a random unit-diagonal SPD A_s, laid out as
    solver_dense.inverse_operator returns it (a (rows, rows, B) view of a
    contiguous (B, rows, rows) tensor), and the rest of admm_iterate's
    inputs, at wob-admm's layout by default."""
    rng = np.random.RandomState(seed)
    rows = kl + 3 * kc + extra
    G = rng.randn(B, rows, 2 * rows) / np.sqrt(2 * rows)
    A = G @ G.transpose(0, 2, 1)
    dg = 1.0 / np.sqrt(np.einsum("bii->bi", A))
    A = A * dg[:, :, None] * dg[:, None, :]
    W = torch.as_tensor(np.linalg.inv(A + 10.0 * np.eye(rows)),
                        device=device).to(dtype).contiguous()
    p = dict(b=rng.randn(rows, B), z0=rng.randn(rows, B),
             mu=rng.rand(kc, B) * 0.8 + 0.2,
             active=(rng.rand(rows, B) > 0.2).astype(np.float64))
    return dict(W=W.permute(1, 2, 0),
                **{k: torch.as_tensor(v, device=device).to(dtype)
                   for k, v in p.items()})


def _stage_calls(tree, a, kw=KW):
    """(wrapper, call) of the three stage kernels on _problem's inputs."""
    jt = SK.build_jt_reference(*(a[k] for k in ROW_ARGS[:7])).contiguous()
    yd, b = (x.contiguous() for x in SK.upsolve_build_yd_reference(
        tree, *(a[k] for k in ROW_ARGS)))
    return [
        (SK.upsolve_build_yd, lambda f: f(tree, *(a[k] for k in ROW_ARGS))),
        (SK.upsolve_yd, lambda f: f(tree, jt, *(a[k] for k in UP_ARGS))),
        (SK.apgd_iterate,
         lambda f: f(yd, b, *(a[k] for k in APGD_ARGS), **kw)),
    ]


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device is
    refused by every wrapper; nothing falls back to the plain version."""
    tree, args = _problem("meta", torch.float32)
    with pytest.raises(ValueError, match="no kernel"):
        SK.solve_rows(tree, **args, **KW)
    for fn, call in _stage_calls(tree, args):
        with pytest.raises(ValueError, match="no kernel"):
            call(fn)
    with pytest.raises(ValueError, match="no kernel"):
        AK.admm_iterate(*_admm_problem("meta", torch.float32).values(),
                        **ADMM_KW)


def test_library_hash_covers_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh header changes the library path of every
    source, so a stale library is never loaded (on a copy of csrc/)."""
    in_tree = cuda_build.lib_path("solve_rows")
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, csrc)
    monkeypatch.setattr(cuda_build, "CSRC", str(csrc))
    before = cuda_build.lib_path("solve_rows")
    assert before == in_tree
    (csrc / "shared.cuh").write_text("// a header\n")
    added = cuda_build.lib_path("solve_rows")
    (csrc / "shared.cuh").write_text("// an edited header\n")
    edited = cuda_build.lib_path("solve_rows")
    assert len({before, added, edited}) == 3


def test_build_needs_nvcc():
    """Without the CUDA toolkit the build raises instead of skipping."""
    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("nvcc is present")
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_all(["solve_rows"])


# ---- host-side helpers of the kernels (run anywhere) ----------------------


def _unpack(p):
    return p & 127, p >> 14, (p >> 7) & 127          # i, e, j


@pytest.mark.parametrize("nv", [105, 10], ids=["fly_sized", "small"])
def test_pack_tables_drive_the_sweeps(nv):
    """The packed tables, walked as the kernel walks them, give the tree
    sweeps of tree_ldl: the up-sweep L^{-T} (pulled into each dof, last
    to first), L^T x (one thread per target dof) and L^{-1} x (pushed
    root first, one step per depth, each dof taking its ancestor at that
    depth), float64."""
    p = SK.random_rows_problem(B=3, seed=4, nv=nv, nbody=5, kl=2, kc=2)
    tree = TL.build_tree_meta(p["parent"])
    ld, _ = TL.factor(tree, torch.as_tensor(p["Ms"]))
    t = SK.pack_tables(tree)
    tab, n_up, n_head = t["tab"], t["n_up"], t["n_head"]
    cptr, cidx = tab[:nv + 1], tab[nv + 1:n_head]
    push = tab[n_head:].reshape(t["ndepth"], nv)
    assert n_head == nv + 1 + n_up and t["n_tab"] == len(tab)
    x = torch.as_tensor(np.random.RandomState(5).randn(nv, 3))

    ref = x.clone()                                  # L^{-T} x, by level
    for ii, ee, jj in tree.on("cpu")["up"]:
        ref.index_add_(0, jj, -ld[ee] * ref[ii])
    got = x.clone()
    for j in range(nv - 1, -1, -1):
        for pk in cidx[cptr[j]:cptr[j + 1]]:
            i, e, _ = _unpack(pk)
            assert i > j
            got[j] -= ld[e] * got[i]
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)

    got = x.clone()                                  # L^T x
    for j in range(nv):
        for pk in cidx[cptr[j]:cptr[j + 1]]:
            i, e, jj = _unpack(pk)
            assert jj == j
            got[j] += ld[e] * x[i]
    torch.testing.assert_close(got, TL.mul_lt(tree, ld, x), rtol=1e-12,
                               atol=1e-12)

    got = x.clone()                                  # L^{-1} x
    for lev in range(t["ndepth"]):
        written = set()
        for i in range(nv):
            pk = push[lev, i]
            if pk >= 0:
                a, e = pk & 127, pk >> 7
                assert len(tree.anc_lists[a]) == lev and a not in written
                got[i] -= ld[e] * got[a]
                written.add(i)
    torch.testing.assert_close(got, TL.solve_down(tree, ld, x), rtol=1e-12,
                               atol=1e-12)


def test_mask_bits():
    """The body-dof mask as bits, bit v % 32 of word v // 32; anything but
    0 and 1 is refused."""
    rng = np.random.RandomState(6)
    maskd = torch.as_tensor((rng.rand(69, 105) < 0.3).astype(np.float32))
    bits = SK.mask_bits(maskd)
    assert bits.dtype == torch.int32 and tuple(bits.shape) == (69, 4)
    words = bits.numpy().view(np.uint32)
    got = (words[:, np.arange(105) // 32] >> (np.arange(105) % 32)) & 1
    np.testing.assert_array_equal(got, maskd.numpy())
    bad = maskd.clone()
    bad[3, 7] = 0.5
    with pytest.raises(ValueError, match="0 and 1"):
        SK.mask_bits(bad)


def test_shape_limits():
    """The kernels hold Yd in registers: nv <= 112 and R <= 192. R <= 160
    takes the narrow instance (5 columns per lane), 161 to 192 the wide one
    (6)."""
    assert (SK.MAX_NV, SK.MAX_R_NARROW, SK.MAX_R) == (112, 160, 192)
    SK.check_shape("solve_rows", SK.MAX_NV, SK.MAX_R)
    assert [SK.tile_cpl(R) for R in (152, 160, 161, 176, 192)] == \
        [5, 5, 6, 6, 6]
    for nv, R in ((SK.MAX_NV + 1, 152), (105, SK.MAX_R + 1)):
        with pytest.raises(ValueError, match="nv <= 112 and R <= 192"):
            SK.check_shape("solve_rows", nv, R)


def test_smem_at_walk_imitation():
    """solve_rows' shared memory per block on walk_imitation's tree at its
    176 rows (the wide instance, with the top chain's 648 L values) and on
    walk_on_ball's at 152 (the narrow one; no top chain: its 13 trees):
    both let two blocks share an SM's 228 KB (each block reserves 1 KB)."""
    from flybody_tpu_torch.tasks import walk_on_ball as WOB
    for parent, R, want in ((_imitation_parent(), 176, 114032),
                            (WOB.load_model()["dof_parentid"], 152, 89136)):
        tree = TL.build_tree_meta(np.asarray(parent, np.int32))
        t = SK.pack_tables(tree)
        smem = SK.smem_bytes(tree.nv, R, tree.nM, t["n_head"], t["n_up"],
                             t["n_chain"])
        assert smem == want
        assert 2 * (smem + 1024) <= 233472
    assert (tree.nv, t["n_up"], t["n_chain"]) == (105, 481, 0)


def test_smem_at_flight():
    """flight_imitation's 42-dof tree at its 64 rows takes the narrow
    instance: the register tile's 160 columns cover 64 rows, and the
    block's shared memory is a third of walk_on_ball's."""
    tree = TL.build_tree_meta(np.asarray(_flight_parent(), np.int32))
    t = SK.pack_tables(tree)
    assert (tree.nv, tree.nM, t["n_up"]) == (42, 421, 379)
    assert SK.tile_cpl(64) == SK.CPL_NARROW == 5
    SK.check_shape("solve_rows", tree.nv, 64)
    assert SK.smem_bytes(tree.nv, 64, tree.nM, t["n_head"], t["n_up"],
                         t["n_chain"]) == 31800


def test_admm_w_layout():
    """admm_iterate's kernel reads W in place: inverse_operator's layout
    passes, a batch-minor contiguous W is refused."""
    a = _admm_problem("cpu", torch.float32, B=3, kl=2, kc=3)
    rows = a["W"].shape[0]
    AK.check_w_layout(a["W"])
    with pytest.raises(ValueError, match="env-major"):
        AK.check_w_layout(a["W"].contiguous())
    M = a["W"].permute(2, 0, 1).double()
    W = SD.inverse_operator(LA.cho_factor(M + M.transpose(1, 2)
                                          + rows * torch.eye(rows)))
    AK.check_w_layout(W)
    AK.check_w_layout(W.to(torch.float32))   # solver_dense's cast keeps it
    assert tuple(W.shape) == (rows, rows, 3)


def test_profile_cuts_apply():
    """profile_solve_rows' cuts still find their places in the kernel's
    source: the output sweeps end in a return; the up-sweep's pull, the
    top chain's sums and its resolution go, in both instances (one
    device function), and nothing else of the steps 1-3 path."""
    with open(os.path.join(cuda_build.CSRC, "solve_rows.cu")) as fh:
        src = fh.read()
    no_sweeps = PS.cut(src, PS.CUTS["no_sweeps"])
    assert "    return;\n    // ---- 7." in no_sweeps
    no_up = PS.cut(src, PS.CUTS["no_upsweep"])
    for call in ("pull(p, cptr, cidx, S, r", "chain_sums(p, S, r",
                 "chain_resolve(p, S, r"):
        assert call in src and call not in no_up
    for kept in ("build_col(p, S, r, v0, v1", "scale_col(p, S, r, 0, v1)",
                 "    __syncthreads();\n    if (!upper) return;"):
        assert kept in no_up
    with pytest.raises(ValueError, match="no cut matches"):
        PS.cut("// another kernel", PS.CUTS["no_sweeps"])


def _trees():
    """The three fly trees: walk_imitation's (a free root: the six-dof top
    chain above 102 dofs), walk_on_ball's (13 trees, no chain) and
    flight_imitation's (a free root above 36 dofs)."""
    from flybody_tpu_torch.tasks import walk_on_ball as WOB
    return {"imitation": _imitation_parent(),
            "walk_on_ball": WOB.load_model()["dof_parentid"],
            "flight": _flight_parent()}


@pytest.mark.parametrize("split", ["dsplit", "ysplit", "one"])
@pytest.mark.parametrize("name,nch", [("imitation", 6), ("walk_on_ball", 0),
                                      ("flight", 6)])
def test_chain_tables_drive_the_upsweep(name, nch, split):
    """The top chain's tables, walked as the kernels walk a column (the
    pull of the dofs below the chain in parts: solve_rows' two at dsplit,
    upsolve_yd's four at ysplit, or one; the chain's sums over them from
    the dense L table; the chain's resolution), give tree_ldl's up-sweep
    L^{-T} x, float64; each part's pull reads only its own part."""
    tree = TL.build_tree_meta(np.asarray(_trees()[name], np.int32))
    nv = tree.nv
    rng = np.random.RandomState(7)
    A = rng.randn(nv, nv, 3) * 0.1
    M = np.eye(nv)[:, :, None] + np.einsum("ikb,jkb->ijb", A, A)
    ld, _ = TL.factor(tree, torch.as_tensor(M[tree.entry_i, tree.entry_j]))
    t = SK.pack_tables(tree)
    m = t["nch"]
    cuts = {"dsplit": [t["dsplit"]], "ysplit": list(t["ysplit"]),
            "one": []}[split]
    bounds = [m] + cuts + [nv]
    assert m == nch and t["n_chain"] == len(t["chain"])
    assert len(t["ysplit"]) == SK.YD_PARTS - 1
    assert all(a <= b for a, b in zip(bounds, bounds[1:])) and m < bounds[1]
    parent = SK._parents(tree)
    for d in cuts:
        assert bool(((parent[d:] < m) | (parent[d:] >= d)).all())
    ch = t["chain"]
    lch = torch.where(torch.as_tensor(ch >= 0)[:, None],
                      ld[np.maximum(ch, 0)], torch.zeros(()))
    cptr, cidx = t["tab"][:nv + 1], t["tab"][nv + 1:nv + 1 + t["n_up"]]
    x0 = torch.as_tensor(rng.randn(nv, 3))
    ref = x0.clone()
    for ii, ee, jj in tree.on("cpu")["up"]:
        ref.index_add_(0, jj, -ld[ee] * ref[ii])
    x = x0.clone()
    acc = torch.zeros(SK.CHAIN, 3, dtype=torch.float64)
    for lo, hi in zip(bounds, bounds[1:]):
        for j in range(hi - 1, lo - 1, -1):          # pull
            for pk in cidx[cptr[j]:cptr[j + 1]]:
                i, e, _ = _unpack(pk)
                assert lo <= i < hi
                x[j] -= ld[e] * x[i]
        for i in range(lo, hi):                      # the chain's sums
            if m:
                acc += lch[(i - m) * SK.CHAIN:(i - m + 1) * SK.CHAIN] * x[i]
    lcc = lch[(nv - m) * SK.CHAIN:] if m else None
    for j in range(m - 1, -1, -1):                   # the chain resolves
        x[j] -= acc[j]
        for i in range(j + 1, m):
            x[j] -= lcc[i * SK.CHAIN + j] * x[i]
    torch.testing.assert_close(x, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B", [1, 7, 129, 4097])
@pytest.mark.parametrize("R", [64, 152, 176])
def test_upsolve_yd_tiles_cover_each_pair_once(R, B):
    """upsolve_yd's (and upsolve_build_yd's: one kernel) grid of env tiles
    by column tiles, each thread's (env, column) as the kernel computes
    it: every pair of a ragged B and R is taken by exactly YD_PARTS
    threads (one per part of the dofs), and the threads left over are
    exactly those the kernel masks (past B or R)."""
    gx, gy = SK.upsolve_yd_grid(R, B)
    bx, by, t = np.meshgrid(np.arange(gx), np.arange(gy),
                            np.arange(SK.YD_THREADS), indexing="ij")
    b, r = SK.upsolve_yd_pair(bx, by, t)
    live = (b < B) & (r < R)
    seen = np.zeros((R, B), np.int64)
    np.add.at(seen, (r[live], b[live]), 1)
    assert (seen == SK.YD_PARTS).all()
    assert int((~live).sum()) == gx * gy * SK.YD_THREADS - SK.YD_PARTS * R * B
    assert gx * SK.YD_ENVS - B < SK.YD_ENVS and gy * SK.YD_COLS - R < \
        SK.YD_COLS


def test_upsolve_yd_smem():
    """upsolve_yd's block at walk_on_ball's tree: the 128 pairs' columns,
    8 envs' dof vectors, then in their place the L entries, and the table
    head fit three blocks in an SM's 228 KB (each block reserves 1 KB);
    walk_imitation's fit two."""
    for name, want, blocks in (("walk_on_ball", 74860, 3),
                               ("imitation", 98968, 2)):
        tree = TL.build_tree_meta(np.asarray(_trees()[name], np.int32))
        smem = SK.upsolve_yd_smem(tree.nv, SK.pack_tables(tree)["n_up"])
        assert smem == want
        assert 233472 // (smem + 1024) == blocks


_TREE_OF_R = {64: "flight", 152: "walk_on_ball", 176: "imitation"}


@pytest.mark.parametrize("B", [1, 7, 129, 4097])
@pytest.mark.parametrize("R", [64, 152, 176])
def test_upsolve_build_yd_builds_each_entry_once(R, B):
    """upsolve_build_yd's grid at the tree of each task's R (flight's 64,
    walk_on_ball's 152, walk_imitation's 176 rows): the YD_PARTS threads
    of each (env, column) pair build disjoint parts of the dofs that
    together are all nv of them, so every entry of J^T (dof, column, env)
    of a ragged B is built exactly once; the parts' boundaries are
    pack_tables' ysplit, above the top chain."""
    tree = TL.build_tree_meta(np.asarray(_trees()[_TREE_OF_R[R]], np.int32))
    t = SK.pack_tables(tree)
    parts = SK.upsolve_yd_dof_parts(tree.nv, t["ysplit"])
    assert len(parts) == SK.YD_PARTS and t["nch"] < parts[0][1]
    assert parts[0][0] == 0 and parts[-1][1] == tree.nv
    assert all(p[1] == q[0] and p[0] <= p[1] for p, q in zip(parts,
                                                              parts[1:]))
    gx, gy = SK.upsolve_yd_grid(R, B)
    bx, by, th = np.meshgrid(np.arange(gx), np.arange(gy),
                             np.arange(SK.YD_THREADS), indexing="ij")
    b, r = SK.upsolve_yd_pair(bx, by, th)
    live = (b < B) & (r < R)
    size = np.array([hi - lo for lo, hi in parts])[th // SK.YD_PAIRS]
    built = np.zeros((R, B), np.int64)
    np.add.at(built, (r[live], b[live]), size[live])
    assert (built == tree.nv).all()


@pytest.mark.parametrize("B", [1, 7, 4097])
def test_upsolve_build_yd_stages_d6_in_sectors(B):
    """upsolve_build_yd's staging of its env tile's d6, as the kernel
    strides it over the block's threads: in the last (ragged) tile every
    word of every env under B lands once, in its own slot of the dof
    records, nothing past B is read, and each 8 consecutive copies read
    one word of 8 consecutive envs (one 32-byte sector)."""
    nv = 105
    b0 = (SK.upsolve_yd_grid(152, B)[0] - 1) * SK.YD_ENVS
    k = np.arange(6 * nv * SK.YD_ENVS)
    env, word, slot = SK.upsolve_build_yd_d6_copy(k, b0)
    live = env < B
    assert int(live.sum()) == 6 * nv * (B - b0)
    assert len(set(slot[live].tolist())) == int(live.sum())
    assert slot.max() < 8 * nv * SK.YD_ENVS and not bool(
        ((slot % 8) >= 6).any())
    pairs = set(zip(env[live].tolist(), word[live].tolist()))
    assert pairs == {(e, w) for e in range(b0, B) for w in range(6 * nv)}
    g_env, g_word = env.reshape(-1, 8), word.reshape(-1, 8)
    assert (g_word == g_word[:, :1]).all()
    assert (g_env - g_env[:, :1] == np.arange(8)).all()


def test_upsolve_build_yd_smem():
    """upsolve_build_yd's block at the three trees: upsolve_yd's carve-up
    with each dof's d6 staged beside its qvel and qacc_smooth (8 words a
    record). Two blocks share an SM at walk_on_ball's and walk_imitation's
    trees (each block reserves 1 KB of the SM's 228 KB), five at
    flight's; at walk_imitation's the L entries, not the records, size the
    region, so it needs no more than upsolve_yd."""
    for name, want, blocks in (("walk_on_ball", 89420, 2),
                               ("imitation", 98968, 2),
                               ("flight", 38360, 5)):
        tree = TL.build_tree_meta(np.asarray(_trees()[name], np.int32))
        n_up = SK.pack_tables(tree)["n_up"]
        smem = SK.upsolve_build_yd_smem(tree.nv, n_up)
        assert smem == want
        assert 233472 // (smem + 1024) == blocks
        assert smem >= SK.upsolve_yd_smem(tree.nv, n_up)
        if name == "imitation":
            assert smem == SK.upsolve_yd_smem(tree.nv, n_up)


@pytest.mark.parametrize("B", [1, 7, 129, 4097])
def test_apgd_cluster_grid_loads_each_word_once(B):
    """apgd_iterate's grid of whole clusters, and the maps by which each
    block loads its share of Yd for its cluster's envs and stores it into
    their blocks, as the kernel computes them: block b takes env b, the
    padded blocks (b >= B) only load; every word of every env under B is
    loaded exactly once, by a lane of the env's own cluster, and nothing
    past B is read; each 8 consecutive lanes of a load read one word of 8
    consecutive envs (one sector); each store takes the word that its
    shuffle's source lane loaded, and a warp's store goes to one env, 32
    consecutive words. nw = 600 words: the last run is ragged. Past 17
    clusters, the first and the last two (the maps repeat per cluster)."""
    nw, ac, runs = 600, SK.APGD_CLUSTER, SK.APGD_RUNS
    grid = SK.apgd_grid(B)
    assert grid % ac == 0 and B <= grid < B + ac
    blocks = np.arange(grid)
    if grid > 17 * ac:
        blocks = np.concatenate([blocks[:ac], blocks[-2 * ac:]])
    envs = blocks[blocks < B]
    steps = -(-nw // (32 * ac * (SK.THREADS // 32) * runs))
    blk, i, a, j, t = np.meshgrid(blocks, np.arange(steps),
                                  np.arange(runs), np.arange(8),
                                  np.arange(SK.THREADS), indexing="ij")
    env, k = SK.apgd_load(blk, t, i, a, j)
    assert (env // ac == blk // ac).all()
    live = (env < B) & (k < nw)
    seen = np.zeros((nw, B), np.int64)
    np.add.at(seen, (k[live], env[live]), 1)
    assert (seen[:, envs] == 1).all() and int(seen.sum()) == nw * len(envs)
    g_env, g_k = env.reshape(-1, 8), k.reshape(-1, 8)
    assert (g_k == g_k[:, :1]).all()
    assert (g_env - g_env[:, :1] == np.arange(8)).all()
    # the stores: lane t % 32 of the same warp, load j of the same run
    e = j                                   # one destination env per store
    d_env, d_k, s_lane, s_j = SK.apgd_store(blk, t, i, a, e)
    s_env, s_k = SK.apgd_load(blk, t - t % 32 + s_lane, i, a, s_j)
    assert (s_env == d_env).all() and (s_k == d_k).all()
    w_k = d_k.reshape(-1, 32)
    assert (w_k - w_k[:, :1] == np.arange(32)).all()
    assert (d_env.reshape(-1, 32) == d_env.reshape(-1, 32)[:, :1]).all()


def test_upsolve_dense_factor_gives_yd():
    """The library yardstick's factor U = L^T D^{1/2} (dense, upper,
    env-major): one solve_triangular on it gives upsolve_yd's Yd on
    walk_imitation's tree, float64."""
    tree, a = _problem("cpu", torch.float64, B=3, nbody=20,
                       imitation_tree=True, kl=32, kc=48)
    jt = SK.build_jt_reference(*(a[k] for k in ROW_ARGS[:7]))
    yd, _ = SK.upsolve_yd_reference(tree, jt, *(a[k] for k in UP_ARGS))
    U = SK.upsolve_dense_factor(tree, a["ld"], a["dinv"])
    assert tuple(U.shape) == (3, tree.nv, tree.nv)
    assert torch.equal(U, torch.triu(U))
    got = torch.linalg.solve_triangular(U, jt.permute(2, 0, 1), upper=True)
    torch.testing.assert_close(got.permute(1, 2, 0), yd, rtol=1e-10,
                               atol=1e-10)


# ---- on the card -----------------------------------------------------------

RAGGED = {   # nv, kl, kc: the fly's shapes and ragged register tiles
    "fly": dict(nv=105, kl=32, kc=40),
    "imitation": dict(imitation_tree=True, kl=32, kc=48),
    "flight": dict(flight_tree=True, kl=16, kc=16),
    "wide_min": dict(nv=105, kl=2, kc=53),
    "wide_max": dict(nv=112, kl=0, kc=64),
    "ragged": dict(nv=37, kl=5, kc=11),
    "kl0": dict(nv=50, kl=0, kc=20),
    "max": dict(nv=112, kl=0, kc=53),
    "small": dict(nv=10, kl=8, kc=8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(RAGGED), ids=list(RAGGED))
def test_kernel_matches_plain_on_card(shape):
    """The CUDA kernel against its plain version (float32, B=256), at the
    fly's shapes, at walk_imitation's (the free-root tree, R = 176), at
    flight_imitation's (its 42-dof tree, R = 64, the narrow instance's
    tile padded over 96 empty columns) and at shapes that leave ragged
    register tiles: nv and R not multiples of the tile, kl = 0, nv = 112
    and R = 159 (just under the narrow instance's 160), R = 161 and 192
    (the wide instance's first and last)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    sh = RAGGED[shape]
    tree, args = _problem("cuda", torch.float32, B=256, nbody=20, **sh)
    kw = dict(KW, kl=sh["kl"], kc=sh["kc"])
    n0 = SK.solve_rows.launches
    got = SK.solve_rows(tree, **args, **kw)
    want = SK.solve_rows_reference(tree, **args, **kw)
    torch.cuda.synchronize()
    assert SK.solve_rows.launches == n0 + 1
    # float32, other summation order: see chip_smoke.py's tolerances
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-3


@pytest.mark.cuda
def test_kernel_refuses_large_shapes_and_masks_on_card():
    """nv over 112 or R over 192, or a maskd that is not 0/1, raise and
    launch nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    n0 = SK.solve_rows.launches
    for sh in (dict(nv=113, kl=32, kc=40), dict(nv=105, kl=2, kc=64)):
        tree, args = _problem("cuda", torch.float32, **sh)
        with pytest.raises(ValueError, match="nv <= 112 and R <= 192"):
            SK.solve_rows(tree, **args, **dict(KW, kl=sh["kl"],
                                               kc=sh["kc"]))
    tree, args = _problem("cuda", torch.float32)
    args["maskd"] = args["maskd"] * 0.5
    with pytest.raises(ValueError, match="0 and 1"):
        SK.solve_rows(tree, **args, **KW)
    torch.cuda.synchronize()
    assert SK.solve_rows.launches == n0


@pytest.mark.cuda
def test_kernel_refuses_float64_on_card():
    """The kernel takes float32 only; float64 CUDA tensors raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float64)
    n0 = SK.solve_rows.launches
    with pytest.raises(TypeError, match="float32"):
        SK.solve_rows(tree, **args, **KW)
    assert SK.solve_rows.launches == n0


def _max_rel(g, w):
    return ((g - w).abs().max() / w.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["fly", "imitation"])
def test_stage_kernels_match_plain_on_card(shape):
    """upsolve_build_yd, upsolve_yd and apgd_iterate against their plain
    versions (float32, B=256), in the narrow instance (walk_on_ball's
    shapes) and the wide one (walk_imitation's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    sh = RAGGED[shape]
    tree, args = _problem("cuda", torch.float32, B=256, nbody=20, **sh)
    kw = dict(KW, kl=sh["kl"], kc=sh["kc"])
    plain = {SK.upsolve_build_yd: SK.upsolve_build_yd_reference,
             SK.upsolve_yd: SK.upsolve_yd_reference,
             SK.apgd_iterate: SK.apgd_iterate_reference}
    for fn, call in _stage_calls(tree, args, kw):
        n0 = fn.launches
        got = call(fn)
        want = call(plain[fn])
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        # float32, other summation order: see chip_smoke.py's tolerances
        for g, w in zip(got, want):
            assert _max_rel(g, w) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kl,kc,extra", [(40, 62, 0), (8, 6, 3)],
                         ids=["rows226", "rows29_odd"])
def test_admm_kernel_matches_plain_on_card(kl, kc, extra):
    """admm_iterate against its plain version (float32, B=256) with W in
    inverse_operator's layout: wob-admm's 226 rows (16-byte loads of W)
    and 29 rows (odd: 4-byte loads, three rows past the cones)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    a = _admm_problem("cuda", torch.float32, B=256, kl=kl, kc=kc,
                      extra=extra)
    kw = dict(ADMM_KW, kl=kl, kc=kc)
    n0 = AK.admm_iterate.launches
    got = AK.admm_iterate(*a.values(), **kw)
    want = AK.admm_iterate_reference(*a.values(), **kw)
    torch.cuda.synchronize()
    assert AK.admm_iterate.launches == n0 + 1
    # The plain version takes the kernel's roundings in the kernel's
    # order, so every env is held on its own scale, as chip_smoke.py
    # holds it: see TOL_ADMM_ENV there.
    err = (got - want).abs().amax(dim=0)
    assert bool((err <= 1e-4 * want.abs().amax(dim=0)).all())


@pytest.mark.cuda
def test_admm_kernel_refuses_batch_minor_w_on_card():
    """A W whose permute(2, 0, 1) is not contiguous (here the batch-minor
    contiguous copy) raises and launches nothing: the kernel copies
    nothing."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    a = _admm_problem("cuda", torch.float32)
    a["W"] = a["W"].contiguous()
    n0 = AK.admm_iterate.launches
    with pytest.raises(ValueError, match="env-major"):
        AK.admm_iterate(*a.values(), **ADMM_KW)
    assert AK.admm_iterate.launches == n0


@pytest.mark.cuda
def test_new_kernels_refuse_float64_on_card():
    """The kernels take float32 only; float64 CUDA tensors raise and
    nothing is launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    tree, args = _problem("cuda", torch.float64)
    for fn, call in _stage_calls(tree, args):
        n0 = fn.launches
        with pytest.raises(TypeError, match="float32"):
            call(fn)
        assert fn.launches == n0
    n0 = AK.admm_iterate.launches
    with pytest.raises(TypeError, match="float32"):
        AK.admm_iterate(*_admm_problem("cuda", torch.float64).values(),
                        **ADMM_KW)
    assert AK.admm_iterate.launches == n0


@pytest.mark.cuda
def test_flight_imitation_on_card():
    """fly_envs.flight_imitation() builds on "cuda" by default and one
    control step of 64 envs launches solve_rows once per substep (4),
    with the wing fluid acting in every env and finite observations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    from flybody_tpu_torch.fly_envs import flight_imitation
    env = flight_imitation()
    assert env.device.type == "cuda" and env.n_substeps == 4
    state = env.reset(64, torch.Generator("cuda").manual_seed(0))
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=torch.float32,
                          device="cuda")[None].expand(64, -1)
    n0 = SK.solve_rows.launches
    state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    assert SK.solve_rows.launches == n0 + 4
    assert bool((state.data.qfrc_fluid.abs().amax(dim=0) > 0).all())
    for v in state.obs.values():
        assert bool(torch.isfinite(v).all())
    assert sum(v.shape[1] for v in state.obs.values()) == 80


@pytest.mark.cuda
def test_kernel_occupancy_on_card():
    """Both instances run two blocks of 8 warps per SM (16 warps), the
    narrow one at walk_on_ball's shapes and the wide one at
    walk_imitation's, neither spilling its register tile to local memory;
    so does apgd_iterate, in clusters of APGD_CLUSTER blocks that fill
    at least three quarters of the card's two blocks per SM. upsolve_yd
    runs three 512-thread blocks at walk_on_ball's tree, upsolve_build_yd
    at least two at all three trees, neither spilling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, R, cpl in (("walk_on_ball", 152, 5), ("imitation", 176, 6)):
        tree = TL.build_tree_meta(np.asarray(_trees()[name], np.int32))
        for kernel in ("solve_rows", "apgd_iterate"):
            info = SK.kernel_info(kernel, tree.nv, R, tree.nM,
                                  SK.pack_tables(tree))
            assert info["cpl"] == cpl
            assert (info["blocks_per_sm"], info["warps_per_sm"]) == (2, 16)
            assert info["local_bytes"] == 0
        assert info["clusters"] * SK.APGD_CLUSTER >= 0.75 * 2 * n_sm
    for name, R in (("walk_on_ball", 152), ("imitation", 176),
                    ("flight", 64)):
        tree = TL.build_tree_meta(np.asarray(_trees()[name], np.int32))
        info = SK.kernel_info("upsolve_build_yd", tree.nv, R, tree.nM,
                              SK.pack_tables(tree))
        assert info["blocks_per_sm"] >= 2 and info["local_bytes"] == 0
    tree = TL.build_tree_meta(np.asarray(_trees()["walk_on_ball"],
                                         np.int32))
    info = SK.kernel_info("upsolve_yd", tree.nv, 152, tree.nM,
                          SK.pack_tables(tree))
    assert (info["blocks_per_sm"], info["local_bytes"]) == (3, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B", [("fly", 1), ("fly", 7), ("fly", 4097),
                                     ("imitation", 129),
                                     ("imitation", 4097)])
def test_upsolve_yd_matches_plain_on_card(shape, B):
    """upsolve_yd against its plain version (float32) at B that are no
    multiple of its 8-env tile (and R 152 and 176, no multiple of its
    16-column tile), each launch counted once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    sh = RAGGED[shape]
    tree, a = _problem("cuda", torch.float32, B=B, nbody=20, **sh)
    jt = SK.build_jt_reference(*(a[k] for k in ROW_ARGS[:7])).contiguous()
    up = [a[k] for k in UP_ARGS]
    n0 = SK.upsolve_yd.launches
    got = SK.upsolve_yd(tree, jt, *up)
    want = SK.upsolve_yd_reference(tree, jt, *up)
    torch.cuda.synchronize()
    assert SK.upsolve_yd.launches == n0 + 1
    # float32, other summation order: see chip_smoke.py's tolerances
    for g, w in zip(got, want):
        assert _max_rel(g, w) < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 7, 129, 4097])
@pytest.mark.parametrize("shape", ["fly", "imitation", "flight"])
def test_build_and_apgd_match_plain_on_card(shape, B):
    """upsolve_build_yd (its env tiles ragged past B and R) and
    apgd_iterate (its clusters padded past B) against their plain versions
    (float32) at B that are no multiple of 8, at walk_on_ball's,
    walk_imitation's and flight_imitation's shapes; each launch counted
    once."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    sh = RAGGED[shape]
    tree, a = _problem("cuda", torch.float32, B=B, nbody=20, **sh)
    kw = dict(KW, kl=sh["kl"], kc=sh["kc"])
    row = [a[k] for k in ROW_ARGS]
    n0 = SK.upsolve_build_yd.launches
    got = SK.upsolve_build_yd(tree, *row)
    want = SK.upsolve_build_yd_reference(tree, *row)
    torch.cuda.synchronize()
    assert SK.upsolve_build_yd.launches == n0 + 1
    # float32, other summation order: see chip_smoke.py's tolerances
    for g, w in zip(got, want):
        assert _max_rel(g, w) < 1e-3
    yd, b = (x.contiguous() for x in want)
    ap = [a[k] for k in APGD_ARGS]
    n0 = SK.apgd_iterate.launches
    got = SK.apgd_iterate(yd, b, *ap, **kw)
    want = SK.apgd_iterate_reference(yd, b, *ap, **kw)
    torch.cuda.synchronize()
    assert SK.apgd_iterate.launches == n0 + 1
    for g, w in zip(got, want):
        assert _max_rel(g, w) < 1e-3
