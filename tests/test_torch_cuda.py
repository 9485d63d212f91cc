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
    to first), L^T x (one thread per target dof) and L^{-1} x (level by
    level, one lane per dof), float64."""
    p = SK.random_rows_problem(B=3, seed=4, nv=nv, nbody=5, kl=2, kc=2)
    tree = TL.build_tree_meta(p["parent"])
    ld, _ = TL.factor(tree, torch.as_tensor(p["Ms"]))
    t = SK.pack_tables(tree)
    tab, n_up, n_down, nseg = t["tab"], t["n_up"], t["n_down"], t["nseg"]
    cptr, cidx = tab[:nv + 1], tab[nv + 1:nv + 1 + n_up]
    o = nv + 1 + n_up
    dn, sptr = tab[o:o + n_down], tab[o + n_down:o + n_down + nseg + 1]
    lptr = tab[o + n_down + nseg + 1:]
    assert len(lptr) == t["nlev"] + 1 and t["n_tab"] == len(tab)
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
    for lev in range(t["nlev"]):
        for sg in range(lptr[lev], lptr[lev + 1]):
            i0 = _unpack(dn[sptr[sg]])[0]
            for pk in dn[sptr[sg]:sptr[sg + 1]]:
                i, e, j = _unpack(pk)
                assert i == i0
                got[i] -= ld[e] * got[j]
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
    176 rows (the wide instance) stays under the 227 KB a block may use;
    walk_on_ball's 152 rows keep the narrow instance's 91,072 bytes."""
    from flybody_tpu_torch.tasks import walk_on_ball as WOB
    limit = 232448
    for parent, R, want in ((_imitation_parent(), 176, 118056),
                            (WOB.load_model()["dof_parentid"], 152, 91072)):
        tree = TL.build_tree_meta(np.asarray(parent, np.int32))
        t = SK.pack_tables(tree)
        smem = SK.smem_bytes(tree.nv, R, tree.nM, t["n_tab"], t["n_up"])
        assert smem == want < limit
    assert (tree.nv, t["n_up"]) == (105, 481)


def test_smem_at_flight():
    """flight_imitation's 42-dof tree at its 64 rows takes the narrow
    instance: the register tile's 160 columns cover 64 rows, and the
    block's shared memory is a third of walk_on_ball's."""
    tree = TL.build_tree_meta(np.asarray(_flight_parent(), np.int32))
    t = SK.pack_tables(tree)
    assert (tree.nv, tree.nM, t["n_up"]) == (42, 421, 379)
    assert SK.tile_cpl(64) == SK.CPL_NARROW == 5
    SK.check_shape("solve_rows", tree.nv, 64)
    assert SK.smem_bytes(tree.nv, 64, tree.nM, t["n_tab"],
                         t["n_up"]) == 31984


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
    source: the output sweeps end in a return, the up-sweep loop goes."""
    with open(os.path.join(cuda_build.CSRC, "solve_rows.cu")) as fh:
        src = fh.read()
    no_sweeps = PS.cut(src, PS.CUTS["no_sweeps"])
    assert "    return;\n    // ---- 7." in no_sweeps
    no_up = PS.cut(src, PS.CUTS["no_upsweep"])
    assert "for (int j = nv - 1" in src and "for (int j = nv - 1" not in no_up
    with pytest.raises(ValueError, match="no cut matches"):
        PS.cut("// another kernel", PS.CUTS["no_sweeps"])


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
    """The narrow instance keeps two blocks per SM at walk_on_ball's
    shapes; the wide one runs one at walk_imitation's, without spilling
    its register tile to local memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    from flybody_tpu_torch.tasks import walk_on_ball as WOB
    for parent, R, cpl, blocks in (
            (WOB.load_model()["dof_parentid"], 152, 5, 2),
            (_imitation_parent(), 176, 6, 1)):
        tree = TL.build_tree_meta(np.asarray(parent, np.int32))
        info = SK.kernel_info("solve_rows", tree.nv, R, tree.nM,
                              SK.pack_tables(tree))
        assert info["cpl"] == cpl
        assert info["blocks_per_sm"] == blocks
        assert info["local_bytes"] == 0
