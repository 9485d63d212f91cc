"""The port's vision_guided_flight against the JAX package (float64 on the
CPU, inputs seeded with numpy): the terrains, the committed assets and the
cameras, the four heightfield pair makers, the eye raycaster piece by
piece, reset from JAX's draws, one autoreset_step, reward and termination
on both terrains and in terrain contact, the vision networks with carried
flax weights and two learner updates with them, the CLI with
``--network vision``, and remove_vision.

The port's eyes depart from the JAX package's on purpose: each casts
against the scene's primitives less those that contain it (the head's),
where the JAX package's eyes see the inside of the head at every pixel.
So the eyes are compared with the JAX raycaster run at the JAX state on
the port's geom set of each eye; every other field with the JAX task."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu.agents import dmpo as j_dmpo
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.math import quaternions as JMQ
from flybody_tpu.ops import raycast as JRC
from flybody_tpu.physics import collision as JCOL
from flybody_tpu.physics import constraint as JC
from flybody_tpu.physics import solver_fused as JSF
from flybody_tpu.tasks import arenas as JAR
from flybody_tpu.tasks.vision_flight import VisionFlightState as JVState
from flybody_tpu.tasks.vision_flight import make_vision_flight as jax_env
from flybody_tpu_torch import fly_envs
from flybody_tpu_torch.agents import dmpo as p_dmpo
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.agents import params as p_params
from flybody_tpu_torch.envs import wrappers as W
from flybody_tpu_torch.ops import raycast as RC
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import constraint as C
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import solver_fused as SF
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.tasks import arenas as AR
from flybody_tpu_torch.tasks import pattern_generators as PG
from flybody_tpu_torch.tasks import vision_flight as VF

from torch_jax_state import close, to_jax, to_port

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 2
# the same float64 closed forms in another operation order
TOL_FORM = 1e-12
# heightfield pairs: bilinear lookups, tangent planes and support points
# composed two or three times, float64
TOL_PAIR = 1e-10
# eye intensities: the same march and closed forms, float64; a pixel whose
# first-hit sample lies within 1e-9 of the surface could flip its first
# hit by one sample, so such pixels are counted (0 on these inputs)
TOL_EYE = 1e-9
# reset: the same float64 kinematics in another summation order
TOL_RESET = 1e-10
# one control step = 4 substeps of wing dynamics with the fused solver's
# iterations and the convex narrowphase (test_torch_flight_imitation)
TOL_STEP = 1e-5
# networks and learner updates (test_torch_agents)
TOL_NET = 1e-10
TOL_UPDATE = 1e-8


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _jax_draws(jstate, keys):
    """The five per-env values the JAX reset drew from ``keys``: target
    height and speed (its task state), x0 and y0 (its root position) and
    the wing-beat phase (FlyEnv.reset splits each key, init_state splits
    the second half five ways and draws the phase from the fifth)."""
    init_keys = jax.vmap(jax.random.split)(keys)[:, 1]
    k = jax.vmap(lambda kk: jax.random.split(kk, 5))(init_keys)
    phase = jax.vmap(jax.random.uniform)(k[:, 4])
    q = np.asarray(jstate.data.qpos)
    ts = jstate.task_state
    return dict(target_height=_t(ts.target_height),
                target_speed=_t(ts.target_speed), x0=_t(q[0]), y0=_t(q[1]),
                initial_phase=_t(phase))


def _jax_eyes(envs, jdata):
    """{eye key: (B, H, W)} of the JAX package's raycaster at the JAX
    state ``jdata``, each eye cast against the port's geoms of that eye
    (``eye_geoms``) and posed in its body as the JAX task's compiled step
    poses it (the rotation by a jitted quat_to_mat, whose float32 products
    XLA contracts into fused multiply-adds)."""
    jt, jm = envs["jenv"].task, envs["jenv"].model
    pt = envs["penv"].task
    jh = jt._height_fn(jm)
    quat_to_mat = jax.jit(JMQ.quat_to_mat)
    eyes = []
    for (key, _, _, _), cam, ids in zip(pt.eyes, jt.eye_ids, pt.eye_geoms):
        body, pos, quat = jt.walker.model.names["cam_pose"][cam]
        eyes.append((key, body, jnp.asarray(pos),
                     quat_to_mat(jnp.asarray(quat)),
                     JRC.make_scene_raycaster(jm, ids)[0]))

    def one(d):
        out = {}
        for key, body, pos, rot, cast in eyes:
            cam_pos = d.xpos[body] + d.xmat[body] @ pos
            cam_mat = d.xmat[body] @ rot
            out[key] = JRC.render_eye(
                cam_pos, cam_mat, jt.rays, jh, scene_cast=cast,
                geom_xpos=d.geom_xpos, geom_xmat=d.geom_xmat)
        return out
    return jax.jit(jax.vmap(one, in_axes=-1))(jdata)


def _task_state(jts):
    """The port's VisionFlightState of a JAX one."""
    w = jts.wbpg
    return VF.VisionFlightState(
        wbpg=PG.WBPGState(freq_idx=_t(w.freq_idx).long(),
                          step=_t(w.step).long(),
                          ctrl_freq=_t(w.ctrl_freq)),
        target_height=_t(jts.target_height),
        target_speed=_t(jts.target_speed))


@pytest.fixture(scope="module")
def envs():
    """Both trench envs, a JAX reset from seeded keys, and one JAX
    autoreset_step from it with seeded actions."""
    jenv = jax_env("trench", dtype=jnp.float64)
    penv = VF.make_vision_flight("cpu", "trench", dtype=torch.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jstate = jax.jit(jenv.reset)(keys)
    lo, hi = jenv.action_spec()
    action = lo + (hi - lo) * np.random.RandomState(0).rand(B, len(lo))
    jnext = jax.jit(jenv.autoreset_step)(jstate, jnp.asarray(action))
    return dict(jenv=jenv, penv=penv, jstate=jstate, jnext=jnext,
                action=action, draws=_jax_draws(jstate, keys))


# ---- terrains, assets, cameras ----------------------------------------------


def test_arenas_equal_to_jax():
    """The terrains bit for bit, the trench's RandomState(0) draw and its
    specs included."""
    assert AR.WINGSPAN == JAR.WINGSPAN
    data, specs = AR.sine_trench()
    jdata, jspecs = JAR.sine_trench()
    np.testing.assert_array_equal(data, jdata)
    for f in ("center_y", "width", "depth"):
        np.testing.assert_array_equal(getattr(specs, f), getattr(jspecs, f))
    np.testing.assert_array_equal(AR.sine_bumps(), JAR.sine_bumps())
    np.testing.assert_array_equal(AR.random_hills(), JAR.random_hills())
    rng = lambda: np.random.RandomState(3)
    np.testing.assert_array_equal(AR.sine_trench(rng=rng())[0],
                                  JAR.sine_trench(rng=rng())[0])
    assert data.dtype == np.float32 and 0 < data.mean() < 1


@pytest.mark.parametrize("terrain", ["trench", "bumps"])
def test_committed_asset_is_a_fresh_export(terrain, tmp_path):
    fresh = VF.export_model(terrain, str(tmp_path / "m.npz"))
    committed = VF.load_model(terrain)
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


def test_builder_matches_jax_mjmodel(envs):
    """The port's MjModel build is the JAX package's field for field, the
    heightfield and the cameras included: the flight fly (nq 43, nv 42,
    nu 11, 9 cameras) over a 100 x 400 heightfield, six pair groups with
    all four heightfield pairs, 393 analytic slots and a fused solve of
    88 rows."""
    mine, amap = VF.build_mj_model("trench")
    theirs = envs["jenv"].mj_model
    a, b = io_mj.export_mj(mine), io_mj.export_mj(theirs)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for k in ("cam_bodyid", "cam_pos", "cam_quat"):
        np.testing.assert_array_equal(VF.load_model("trench")[k],
                                      getattr(theirs, k), err_msg=k)
    assert (mine.nq, mine.nv, mine.nu, mine.ncam) == (43, 42, 11, 9)
    assert (mine.hfield_nrow[0], mine.hfield_ncol[0]) == (100, 400)
    np.testing.assert_array_equal(mine.hfield_size[0], [12, 3, 0.6, 0.1])
    assert json.dumps(amap, sort_keys=True) == json.dumps(
        envs["jenv"].task.walker.action_maps, sort_keys=True)
    pm, jm = envs["penv"].model, envs["jenv"].model
    assert pm.ncon_max == jm.ncon_max == 393
    assert pm.ccd_classes == jm.ccd_classes
    groups = {}
    for t1, t2 in np.asarray(pm.pair_type):
        groups[(int(t1), int(t2))] = groups.get((int(t1), int(t2)), 0) + 1
    H = T.GEOM_HFIELD
    assert groups == {(H, T.GEOM_CAPSULE): 47, (H, T.GEOM_ELLIPSOID): 16,
                      (H, T.GEOM_CYLINDER): 6, (H, T.GEOM_SPHERE): 1,
                      (T.GEOM_CAPSULE, T.GEOM_CAPSULE): 217,
                      (T.GEOM_SPHERE, T.GEOM_CAPSULE): 47}
    lay = SF.fused_layout(pm, C.efc_meta(pm))
    jlay = JSF.fused_layout(jm, JC.efc_meta(jm))
    for L in (lay, jlay):
        assert (L["R"], L["n_lim"], L["k_cone"]) == (88, 8, 24)


def test_camera_rotations_equal_to_jax(envs):
    """Each eye's body, offset and float32 rotation are the JAX task's
    (the rotation bit for bit with its compiled quat_to_mat, whose float32
    products XLA contracts into fused multiply-adds), and the rays too."""
    jt, pt = envs["jenv"].task, envs["penv"].task
    assert [e[0] for e in pt.eyes] == ["left_eye", "right_eye"]
    quat_to_mat = jax.jit(JMQ.quat_to_mat)
    for (_, body, pos, mat), cam in zip(pt.eyes, jt.eye_ids):
        jbody, jpos, jquat = jt.walker.model.names["cam_pose"][cam]
        assert body == jbody
        np.testing.assert_array_equal(pos.numpy(), jpos)
        want = np.asarray(quat_to_mat(jnp.asarray(jquat)))
        assert want.dtype == np.float32
        np.testing.assert_array_equal(mat.numpy(), want)
    np.testing.assert_array_equal(pt.rays.numpy(), np.asarray(jt.rays))


# ---- the heightfield pairs -----------------------------------------------


def _hfield_placements(jm, geom_type, seed, P=5, Bp=4):
    """Seeded geoms of ``geom_type`` over the trench terrain: centres
    within +-0.1 of the terrain height, half of them on cell edges or
    nodes of the grid; random rotations and fly-sized geoms."""
    rng = np.random.RandomState(seed)
    nr, nc = jm.hfield_nrow, jm.hfield_ncol
    sx, sy = 12.0, 3.0
    x = rng.uniform(-0.9, 0.9, (P, Bp)) * sx
    y = rng.uniform(-0.9, 0.9, (P, Bp)) * sy
    on_edge = rng.rand(P, Bp) < 0.5
    x = np.where(on_edge, np.round((x / sx + 1) * 0.5 * (nc - 1))
                 / (0.5 * (nc - 1)) - 1, x / sx) * sx
    y = np.where(rng.rand(P, Bp) < 0.5, np.round((y / sy + 1) * 0.5
                 * (nr - 1)) / (0.5 * (nr - 1)) - 1, y / sy) * sy
    h = JRC.hfield_height_fn(jm.hfield_data[0], jm.hfield_size[0],
                             jnp.zeros(3))(jnp.asarray(x), jnp.asarray(y))
    z = np.asarray(h) + rng.uniform(-0.1, 0.1, (P, Bp))
    p2 = np.stack([x + 8.0, y, z], axis=1)                  # (P, 3, Bp)
    q = rng.normal(size=(P, Bp, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    m2 = np.moveaxis(np.asarray(JMQ.quat_to_mat(jnp.asarray(q))), 1, -1)
    size = {T.GEOM_SPHERE: [0.03, 0, 0], T.GEOM_CAPSULE: [0.02, 0.05, 0],
            T.GEOM_ELLIPSOID: [0.05, 0.03, 0.02],
            T.GEOM_CYLINDER: [0.03, 0.04, 0]}[geom_type]
    s2 = (np.asarray(size)[None, :, None]
          * rng.uniform(0.5, 1.5, (P, 1, 1)))               # (P, 3, 1)
    p1 = np.broadcast_to(np.array([8.0, 0, 0])[None, :, None], (P, 3, Bp))
    m1 = np.broadcast_to(np.eye(3)[None, :, :, None], (P, 3, 3, Bp))
    s1 = np.broadcast_to(np.array([12.0, 3, 0.6])[None, :, None], (P, 3, 1))
    return [np.ascontiguousarray(a) for a in (p1, m1, s1, p2, m2, s2)]


@pytest.mark.parametrize("geom_type", [T.GEOM_SPHERE, T.GEOM_CAPSULE,
                                       T.GEOM_ELLIPSOID, T.GEOM_CYLINDER],
                         ids=["sphere", "capsule", "ellipsoid", "cylinder"])
def test_hfield_pair_equal_to_jax(envs, geom_type):
    """The heightfield pair maker through both packages' _dispatch on
    seeded placements over the trench (dist, contact points, normals);
    every placement evaluated, penetrating or not."""
    jm, pm = envs["jenv"].model, envs["penv"].model
    args = _hfield_placements(jm, geom_type, seed=geom_type)
    want = jax.jit(JCOL._dispatch(jm, T.GEOM_HFIELD, geom_type))(
        *(jnp.asarray(a) for a in args))
    got = COL._dispatch(pm, T.GEOM_HFIELD, geom_type)(*(_t(a) for a in args))
    k = io_mj.PAIR_NCON[(T.GEOM_HFIELD, geom_type)]
    for name, g, w in zip(("dist", "pos", "normal"), got, want):
        assert g.shape[1] == k
        close(name, g, w, TOL_PAIR)
    assert (np.asarray(want[0]) < 0).any() and (np.asarray(want[0]) > 0).any()


# ---- the raycaster ----------------------------------------------------------


def _rot(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return np.asarray(JMQ.quat_to_mat(jnp.asarray(q)))


def test_rays_height_and_terrain_hit(envs):
    """camera_rays bit for bit; hfield_height_fn on points inside and
    outside the terrain, on grid nodes and at NaN; terrain_hit of three
    seeded cameras."""
    jm, pm = envs["jenv"].model, envs["penv"].model
    for fovy, w, h in ((150.0, 32, 32), (90.0, 7, 5)):
        np.testing.assert_array_equal(
            RC.camera_rays(fovy, w, h, dtype=torch.float64).numpy(),
            np.asarray(JRC.camera_rays(fovy, w, h, dtype=jnp.float64)))
    np.testing.assert_array_equal(RC.camera_rays(150.0, 32, 32).numpy(),
                                  np.asarray(JRC.camera_rays(150.0, 32, 32)))
    rng = np.random.RandomState(7)
    pos = np.array(VF.HFIELD_POS, np.float32)
    x = rng.uniform(-6, 22, 400)
    y = rng.uniform(-4, 4, 400)
    x[:50] = 8.0 + 12.0 * (np.arange(50) * 8 / 399.0 * 2 - 1)
    y[50:60] = np.nan
    jh = JRC.hfield_height_fn(jm.hfield_data[0], jm.hfield_size[0],
                              jnp.asarray(pos))
    ph = RC.hfield_height_fn(pm.hfield_data[0], pm.hfield_size[0], pos)
    want = np.asarray(jax.jit(jh)(jnp.asarray(x), jnp.asarray(y)))
    got = ph(_t(x), _t(y))
    assert np.isfinite(want).all() and (want[50:60] == 0).all()
    close("height", got, want, TOL_FORM, scale=1.0)

    cam = np.stack([rng.uniform(-2, 12, 3), rng.uniform(-1, 1, 3),
                    rng.uniform(0.3, 1.5, 3)], axis=1)
    rays = JRC.camera_rays(150.0, 32, 32, dtype=jnp.float64)
    d_world = np.einsum("bij,hwj->bhwi", _rot(rng, 3), np.asarray(rays))
    want = jax.jit(jax.vmap(lambda c, d: JRC.terrain_hit(c, d, jh)))(
        jnp.asarray(cam), jnp.asarray(d_world))
    got = RC.terrain_hit(_t(cam), _t(d_world), ph)
    fin = np.isfinite(np.asarray(want))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    assert fin.any() and (~fin).any()
    close("terrain_hit", got.numpy()[fin], np.asarray(want)[fin], TOL_FORM)


class _FakeModel:
    """geom types and sizes, all make_scene_raycaster reads."""

    def __init__(self, types, sizes):
        self.geom_type = np.asarray(types)
        self.geom_size = np.asarray(sizes, np.float64)


def test_ray_primitives_and_scene_raycaster():
    """Each ray-primitive function on seeded rays, then
    make_scene_raycaster over all five primitive types (two geoms each)
    at B=3 against the JAX raycaster under vmap."""
    rng = np.random.RandomState(11)
    o = rng.uniform(-2, 2, (64, 3))
    d = rng.normal(size=(64, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    size = rng.uniform(0.2, 1.0, (64, 3))
    jo, jd, js = jnp.asarray(o), jnp.asarray(d), jnp.asarray(size)
    po, pd, ps = _t(o), _t(d), _t(size)
    for name, got, want in (
            ("sphere", RC._ray_sphere_t(po, pd, ps[:, 0]),
             JRC._ray_sphere_t(jo, jd, js[:, 0])),
            ("ellipsoid", RC._ray_ellipsoid_t(po, pd, ps),
             JRC._ray_ellipsoid_t(jo, jd, js)),
            ("capsule", RC._ray_capsule_t(po, pd, ps[:, 0], ps[:, 1]),
             JRC._ray_capsule_t(jo, jd, js[:, 0], js[:, 1])),
            ("box", RC._ray_box_t(po, pd, ps), JRC._ray_box_t(jo, jd, js))):
        want = np.asarray(want)
        assert (want < JRC._INF).any() and (want == JRC._INF).any(), name
        close(name, got, want, TOL_FORM)

    types = [T.GEOM_SPHERE, T.GEOM_CAPSULE, T.GEOM_ELLIPSOID, T.GEOM_BOX,
             T.GEOM_CYLINDER] * 2 + [T.GEOM_PLANE]
    sizes = rng.uniform(0.1, 0.4, (len(types), 3))
    fake = _FakeModel(types, sizes)
    ids = list(range(len(types)))
    jcast, jany = JRC.make_scene_raycaster(fake, ids)
    pcast, pany = RC.make_scene_raycaster(fake, ids)
    assert jany and pany
    Bs, ng = 3, len(types)
    gpos = rng.uniform(-1.5, 1.5, (Bs, ng, 3)) + np.array([0, 0, -2.0])
    gmat = _rot(rng, Bs * ng).reshape(Bs, ng, 3, 3)
    cam = rng.uniform(-0.2, 0.2, (Bs, 3))
    rays = np.asarray(JRC.camera_rays(120.0, 24, 24, dtype=jnp.float64))
    d_world = np.einsum("bij,hwj->bhwi", _rot(rng, Bs), rays)
    d_world[..., 2] = -np.abs(d_world[..., 2])       # look down at them
    d_world /= np.linalg.norm(d_world, axis=-1, keepdims=True)
    want = np.asarray(jax.jit(jax.vmap(jcast))(
        jnp.asarray(cam), jnp.asarray(d_world), jnp.asarray(gpos),
        jnp.asarray(gmat)))
    got = pcast(_t(cam), _t(d_world), _t(gpos), _t(gmat))
    assert (want < JRC._INF).mean() > 0.05 and (want == JRC._INF).any()
    close("scene", got, want, TOL_FORM)


def test_render_eye_equal_to_jax(envs):
    """render_eye of three seeded cameras near the fly over the trench,
    with the fly's primitive geoms in view (the JAX reset state's frames),
    in chunks of 2 envs: intensities within TOL_EYE of 255 where the first
    hit is not within 1e-9 of the terrain (no such pixel here)."""
    jt, pt = envs["jenv"].task, envs["penv"].task
    jm, pm = envs["jenv"].model, envs["penv"].model
    rng = np.random.RandomState(12)
    jd = envs["jstate"].data
    idx = np.array([0, 1, 0])
    gpos = np.moveaxis(np.asarray(jd.geom_xpos)[..., idx], -1, 0)
    gmat = np.moveaxis(np.asarray(jd.geom_xmat)[..., idx], -1, 0)
    root = np.asarray(jd.qpos)[:3, idx].T
    cam = root + rng.uniform(-0.6, 0.6, (3, 3)) + np.array([0, 0, 0.2])
    cmat = _rot(rng, 3)
    jh = jt._height_fn(jm)
    scene_cast = RC.make_scene_raycaster(pm, pt.scene_geoms)[0]
    jrender = jax.jit(jax.vmap(lambda c, m, gp, gm: JRC.render_eye(
        c, m, jt.rays.astype(jnp.float64), jh, scene_cast=jt.scene_cast,
        geom_xpos=gp, geom_xmat=gm)))
    want = np.asarray(jrender(*(jnp.asarray(a)
                                for a in (cam, cmat, gpos, gmat))))
    got = RC.render_eye(_t(cam), _t(cmat), pt.rays, pt.height_fn,
                        scene_cast=scene_cast, geom_xpos=_t(gpos),
                        geom_xmat=_t(gmat), chunk=2)
    # pixels whose march passes within 1e-9 of the surface
    d_world = torch.einsum("bij,hwj->bhwi", _t(cmat), pt.rays)
    ts = torch.linspace(0.05, 10.0, 48, dtype=torch.float64)
    pts = _t(cam)[:, None, None, None] + ts[:, None] * d_world[..., None, :]
    gap = (pts[..., 2] - pt.height_fn(pts[..., 0], pts[..., 1])).abs()
    assert int((gap.amin(dim=-1) < 1e-9).sum()) == 0
    # every kind of pixel: sky, terrain and the fly's geoms
    t_prim = scene_cast(_t(cam), d_world, _t(gpos), _t(gmat))
    t_ter = RC.terrain_hit(_t(cam), d_world, pt.height_fn)
    assert bool((t_prim < 10).any()) and bool((t_ter < t_prim).any())
    assert bool(((t_ter > 10) & (t_prim > 10)).any())
    close("eye", got, want, TOL_EYE)


def test_eyes_see_out_of_the_head(envs):
    """At reset (64 envs drawn from a seed) each eye casts against the
    scene less exactly the geoms that contain it in every env (the head's
    two ellipsoids), so no pixel's nearest hit is such a geom; the terrain
    is the nearest hit of at least 15 % of each eye's pixels in every env
    and of 30-50 % in the median env, and terrain and sky together of
    most of them."""
    penv = envs["penv"]
    pt, pm = penv.task, penv.model
    st = penv.reset(64, torch.Generator().manual_seed(0))
    d = st.data
    gx = d.geom_xpos.permute(2, 0, 1)
    gm = d.geom_xmat.permute(3, 0, 1, 2)
    gt = np.asarray(pm.geom_type)
    gs = pm.geom_size.numpy()
    hits = pt.render_eyes(pm, d, distance=True)
    for (key, body, pos, mat), ids in zip(pt.eyes, pt.eye_geoms):
        cam_pos, cam_mat = pt.camera_pose(d, body, pos, mat)
        inside = {int(g) for g in pt.scene_geoms for b in range(64)
                  if VF.contains(gt[g], gs[g], _np(
                      gm[b, g].T @ (cam_pos[b] - gx[b, g])))}
        assert len(inside) == 2
        assert {int(gt[g]) for g in inside} == {T.GEOM_ELLIPSOID}
        assert set(pt.scene_geoms.tolist()) - set(ids.tolist()) == inside
        d_world = torch.einsum("bij,hwj->bhwi", cam_mat, pt.rays)
        t_ter = RC.terrain_hit(cam_pos, d_world, pt.height_fn)
        t_cast = RC.make_scene_raycaster(pm, ids)[0](cam_pos, d_world, gx,
                                                     gm)
        assert torch.equal(hits[key], torch.minimum(t_ter, t_cast))
        terrain = ((t_ter < t_cast) & (t_ter < 10.0)).flatten(1).double()
        sky = ((t_ter >= 10.0) & (t_cast >= 10.0)).flatten(1).double()
        share = terrain.mean(dim=1)
        assert float(share.min()) >= 0.15, key
        assert 0.30 <= float(share.median()) <= 0.50, key
        assert float((share + sky.mean(dim=1)).median()) > 0.9, key


# ---- reset, one control step ----------------------------------------------


def test_reset_with_jax_draws(envs):
    """reset from the JAX package's five draws gives its state, obs and
    task state; both eyes as the JAX raycaster renders them at its state
    on the port's geoms of each eye."""
    penv, jst = envs["penv"], envs["jstate"]
    pst = penv.reset(B, **envs["draws"])
    assert set(pst.obs) == set(jst.obs)
    want = {**jst.obs, **_jax_eyes(envs, jst.data)}
    for k in jst.obs:
        close("obs." + k, pst.obs[k], want[k], TOL_RESET, scale=1.0)
    for f in ("qpos", "qvel", "xpos", "xquat", "qM", "geom_xpos",
              "qfrc_fluid"):
        close(f, getattr(pst.data, f), getattr(jst.data, f), TOL_RESET,
              scale=1.0)
    want = _task_state(jst.task_state)
    for f in ("target_height", "target_speed"):
        np.testing.assert_array_equal(getattr(pst.task_state, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    for f in ("freq_idx", "step", "ctrl_freq"):
        np.testing.assert_array_equal(
            getattr(pst.task_state.wbpg, f).numpy(),
            getattr(want.wbpg, f).numpy(), err_msg="wbpg." + f)
    np.testing.assert_array_equal(np.sort(pst.data.contact.sel.numpy(), 0),
                                  np.sort(np.asarray(jst.data.contact.sel),
                                          0))


def test_observation_keys_and_sizes(envs):
    """11 keys, 40 floats beside the two 32 x 32 eyes, in both packages;
    the drawn starts lie in their ranges."""
    sizes = {"accelerometer": (3,), "actuator_activation": (11,),
             "gyro": (3,), "joints_pos": (6,), "joints_vel": (6,),
             "task_input": (2,), "velocimeter": (3,), "world_zaxis": (3,),
             "world_zaxis_hover": (3,), "left_eye": (32, 32),
             "right_eye": (32, 32)}
    pst = envs["penv"].reset(B, torch.Generator().manual_seed(0))
    for obs in (pst.obs, envs["jnext"].obs):
        assert {k: tuple(v.shape[1:]) for k, v in obs.items()} == sizes
    ti = pst.obs["task_input"].numpy()
    assert ((0.4 <= ti[:, 0]) & (ti[:, 0] <= 0.6)).all()
    assert ((20 <= ti[:, 1]) & (ti[:, 1] <= 40)).all()
    x0 = pst.data.qpos[0].numpy()
    assert ((-1.0 <= x0) & (x0 <= -0.5)).all()


def test_autoreset_step(envs):
    """One control step from the JAX reset state (no episode ends, so the
    auto-reset draw does not enter): obs, reward, done, discount and the
    state within TOL_STEP of scale, the WBPG state exactly, selections as
    sets; both eyes against the JAX raycaster at the JAX step's state on
    the port's geoms of each eye. The heightfield pairs run on both the
    fresh and the update collision paths."""
    penv, jst, jnext = envs["penv"], envs["jstate"], envs["jnext"]
    assert not bool(np.asarray(jnext.done).any())
    pst = penv.reset(B, **envs["draws"])
    pst = pst.replace(data=to_port(jst.data, penv.model),
                      task_state=_task_state(jst.task_state))
    nxt = penv.autoreset_step(pst, torch.as_tensor(envs["action"]))
    assert set(nxt.obs) == set(jnext.obs)
    want = {**jnext.obs, **_jax_eyes(envs, jnext.data)}
    for k in jnext.obs:
        close("obs." + k, nxt.obs[k], want[k], TOL_STEP, scale=1.0)
    for f in ("reward", "discount", "step_idx"):
        close(f, getattr(nxt, f), getattr(jnext, f), TOL_STEP, scale=1.0)
    np.testing.assert_array_equal(nxt.done.numpy(), np.asarray(jnext.done))
    for f in ("qpos", "qvel", "act", "ctrl", "time", "qfrc_fluid"):
        close(f, getattr(nxt.data, f), getattr(jnext.data, f), TOL_STEP,
              scale=1.0)
    want = _task_state(jnext.task_state)
    for f in ("freq_idx", "step", "ctrl_freq"):
        np.testing.assert_array_equal(
            getattr(nxt.task_state.wbpg, f).numpy(),
            getattr(want.wbpg, f).numpy(), err_msg="wbpg." + f)
    for f in ("warm_sel", "sol_cone_sel", "sol_lim_sel", "ccd_warm_id"):
        np.testing.assert_array_equal(
            np.sort(getattr(nxt.data, f).numpy(), axis=0),
            np.sort(np.asarray(getattr(jnext.data, f)), axis=0), err_msg=f)


def _reward_cases(jd, jts, hfn, trench):
    """Five envs of the stepped state: at the target height over the
    trench centre; lowered to 0.05 over the terrain (too low: fatal);
    0.1 off the centre (the trench factor); its root on the terrain (its
    body in terrain contact: fatal); as the first (its contact rows are
    replaced by the fourth env's below)."""
    idx = np.array([0, 1, 0, 1, 0])
    jd = jax.tree_util.tree_map(lambda x: x[..., idx], jd)
    qpos = np.array(jd.qpos)
    xs = np.linspace(-4.0, 20.0, len(trench.center_y))
    cy = trench.center_y[np.abs(xs[:, None] - qpos[0]).argmin(0)] * 3.0
    qpos[1] = np.where(idx == 0, cy, qpos[1]) + [0, 0, 0.1, 0, 0]
    ter = np.asarray(hfn(jnp.asarray(qpos[0]), jnp.asarray(qpos[1])))
    qpos[2] = ter + np.asarray(jts.target_height)[idx]
    qpos[2, 1] = ter[1] + 0.05
    qpos[2, 3] = ter[3]
    return jd.replace(qpos=jnp.asarray(qpos)), idx


@pytest.mark.parametrize("terrain", ["trench", "bumps"])
def test_reward_termination_discount(envs, terrain):
    """reward_term_discount of both packages' tasks on five envs placed
    over the terrain, their kinematics and contacts recomputed by the
    port: the reward factors with the trench centre, fatal height over the
    terrain, and the fatal terrain contact (an active contact of the world
    body) on the same contact rows, alone in the fifth env (a fly high
    above the terrain given the fourth env's contact rows)."""
    jenv = envs["jenv"] if terrain == "trench" else jax_env(
        terrain, dtype=jnp.float64)
    penv = envs["penv"] if terrain == "trench" else \
        VF.make_vision_flight("cpu", terrain, dtype=torch.float64)
    jm, pm, jt = jenv.model, penv.model, jenv.task
    jd, idx = _reward_cases(envs["jnext"].data, envs["jnext"].task_state,
                            jt._height_fn(jm), envs["jenv"].task.trench)
    pd = F.fwd_velocity(pm, F.fwd_position(pm, to_port(jd, pm)))
    con = pd.contact
    con = con.replace(**{
        f.name: torch.cat([getattr(con, f.name)[..., :4],
                           getattr(con, f.name)[..., 3:4]], dim=-1)
        for f in dataclasses.fields(con)})
    pd = pd.replace(contact=con)
    jd = to_jax(pd, jm)
    jts = jax.tree_util.tree_map(lambda x: x[..., idx],
                                 envs["jnext"].task_state)
    sensor = np.asarray(envs["jnext"].data.sensordata)[:, idx]
    want = jax.jit(jax.vmap(lambda d, s, sm: jt.reward_term_discount(
        jm, d, s, sm), in_axes=(-1, -1, -1)))(jd, jts, jnp.asarray(sensor))
    got = penv.task.reward_term_discount(pm, pd, _task_state(jts),
                                         _t(sensor))
    close("reward", got[0], want[0], TOL_FORM, scale=1.0)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # (the third env's wings may reach the trench wall)
    keep = [0, 1, 3, 4]
    np.testing.assert_array_equal(got[1].numpy()[keep],
                                  [False, True, True, True])
    np.testing.assert_array_equal(got[2].numpy()[keep], [1.0, 0.0, 0.0, 0.0])
    world = ((con.b1 == 0) | (con.b2 == 0)) & (con.dist < con.margin)
    np.testing.assert_array_equal(world.any(dim=0).numpy()[keep],
                                  [False, True, True, True])
    assert con.b1.shape == jd.contact.b1.shape
    assert float(got[0][0]) > 0 and float(got[0][4]) == float(got[0][0])
    if terrain == "trench":
        assert float(got[0][2]) < float(got[0][0])


def test_factory_needs_cuda_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fly_envs.vision_guided_flight()
    env = fly_envs.vision_guided_flight(device="cpu", bumps_or_trench="bumps")
    assert env.device == torch.device("cpu") and env.task.trench is None


def test_remove_vision(envs):
    """remove_vision drops both eyes from reset and step; the rest of the
    obs is the env's."""
    blind = W.remove_vision(envs["penv"])
    st = blind.reset(B, torch.Generator().manual_seed(1))
    assert not {"left_eye", "right_eye"} & set(st.obs)
    assert len(st.obs) == 9
    lo, hi = blind.action_spec()
    nxt = blind.autoreset_step(st, torch.as_tensor((lo + hi) / 2)[None]
                               .expand(B, -1))
    assert set(nxt.obs) == set(st.obs)


# ---- the vision networks ----------------------------------------------------

ACT = 12
NARROW = ((32, 32, 32), (64, 64, 32))


def _eye_layout(envs):
    keys, slices = p_nets.obs_layout(envs["jnext"].obs)
    obs_size = sum(s[1] for s in slices.values())
    eyes = tuple(slices[k] for k in ("left_eye", "right_eye"))
    return obs_size, eyes


def _obs_batch(rng, n, obs_size, eyes):
    obs = 3.0 * rng.normal(size=(n, obs_size))
    for s, sz, _ in eyes:
        obs[:, s:s + sz] = rng.uniform(0, 255, (n, sz))
    return obs


def _carried_vision(obs_size, eyes, seed, noise=0.3):
    """JAX vision networks with float64 params (flax init plus numpy
    noise) and the port's carrying the same weights."""
    jpol = j_nets.VisionPolicy(action_size=ACT, eye_slices=eyes,
                               layer_sizes=NARROW[0])
    jcrit = j_nets.VisionCritic(eye_slices=eyes, layer_sizes=NARROW[1])
    obs0, act0 = jnp.zeros((1, obs_size)), jnp.zeros((1, ACT))
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)
    noisy = lambda tree: jax.tree.map(
        lambda x: np.asarray(x, np.float64) + noise * rng.normal(
            size=x.shape), jax.device_get(tree))
    params = {"policy": noisy(jpol.init(k1, obs0)),
              "critic": noisy(jcrit.init(k2, obs0, act0))}
    ppol = p_nets.VisionPolicy(obs_size, ACT, eyes, NARROW[0]).double()
    pcrit = p_nets.VisionCritic(obs_size, ACT, eyes, NARROW[1]).double()
    ppol.load_state_dict(p_params.policy_state_dict(params["policy"]))
    pcrit.load_state_dict(p_params.critic_state_dict(params["critic"]))
    return jpol, jcrit, params, ppol, pcrit


def test_vision_networks_with_carried_weights(envs):
    """VisNetFly (flax "SAME" padding at stride 2: (0, 1) on 32, 16, 8
    and 4; flax's (H, W, C) flatten), VisionPolicy and VisionCritic on
    the env's obs layout with carried weights."""
    obs_size, eyes = _eye_layout(envs)
    assert obs_size == 2048 + 40
    jpol, jcrit, params, ppol, pcrit = _carried_vision(obs_size, eyes, 0)
    assert ppol.vis.pads == ((0, 1, 0, 1),) * 4
    rng = np.random.RandomState(1)
    obs = _obs_batch(rng, 8, obs_size, eyes)
    act = rng.uniform(-1.5, 1.5, (8, ACT))
    left = obs[:, eyes[0][0]:eyes[0][0] + 1024].reshape(8, 32, 32)
    right = obs[:, eyes[1][0]:eyes[1][0] + 1024].reshape(8, 32, 32)
    jvis = j_nets.VisNetFly()
    want = jvis.apply({"params": params["policy"]["params"]["VisNetFly_0"]},
                      jnp.asarray(left), jnp.asarray(right))
    jd = jpol.apply(params["policy"], jnp.asarray(obs))
    jz = jcrit.apply(params["critic"], jnp.asarray(obs), jnp.asarray(act))
    with torch.no_grad():
        feat = ppol.vis(_t(left), _t(right))
        pdist = ppol(_t(obs))
        pz = pcrit(_t(obs), _t(act))
        tiled = pcrit(_t(obs)[None].expand(3, -1, -1),
                      _t(act)[None].expand(3, -1, -1))
    close("VisNetFly", feat, want, TOL_NET)
    close("policy mean", pdist.mean, jd.mean, TOL_NET)
    close("policy stddev", pdist.stddev, jd.stddev, TOL_NET)
    close("critic logits", pz.logits, jz.logits, TOL_NET)
    close("critic logits, leading axes", tiled.logits[1], jz.logits, TOL_NET)


def test_two_learner_updates_with_vision_nets(envs):
    """Two consecutive DMPOLearner updates with the vision networks from
    the same carried state on the same batches and action normals
    (test_torch_agents' procedure)."""
    obs_size, eyes = _eye_layout(envs)
    Bt, N = 16, 20
    inits = [_carried_vision(obs_size, eyes, s, noise=0.05)[2]
             for s in range(2)]
    jpol, jcrit = _carried_vision(obs_size, eyes, 0)[:2]
    kw = dict(batch_size=Bt, num_samples=N, target_policy_update_period=1,
              target_critic_update_period=2)
    jlearner = j_dmpo.DMPOLearner(jpol, jcrit, ACT, obs_size,
                                  j_dmpo.DMPOConfig(**kw))
    f64 = lambda tree: jax.tree.map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
    jstate = f64(jlearner.init(jax.random.PRNGKey(0)))
    as_j = lambda tree: jax.tree.map(jnp.asarray, tree)
    jstate = jstate.replace(
        policy_params=as_j(inits[0]["policy"]),
        critic_params=as_j(inits[0]["critic"]),
        target_policy_params=as_j(inits[1]["policy"]),
        target_critic_params=as_j(inits[1]["critic"]))
    plearner = p_dmpo.DMPOLearner(
        p_nets.VisionPolicy(obs_size, ACT, eyes, NARROW[0]).double(),
        p_nets.VisionCritic(obs_size, ACT, eyes, NARROW[1]).double(),
        ACT, obs_size, p_dmpo.DMPOConfig(**kw))
    numpy_tree = lambda tree: jax.tree.map(np.asarray,
                                           jax.device_get(tree))
    carried = {f.name: numpy_tree(getattr(jstate, f.name))
               for f in dataclasses.fields(jstate)}
    carried["dual_params"] = dataclasses.asdict(carried["dual_params"])
    pstate = p_params.carry_train_state(plearner, carried)

    update = jax.jit(jlearner.update)
    rng = np.random.RandomState(4)
    for step in (1, 2):
        batch = j_dmpo.Transition(
            obs=_obs_batch(rng, Bt, obs_size, eyes),
            action=rng.uniform(-1.2, 1.2, (Bt, ACT)),
            reward=rng.uniform(0, 5, Bt),
            discount=0.99 ** 5 * (rng.uniform(size=Bt) > 0.2),
            next_obs=_obs_batch(rng, Bt, obs_size, eyes))
        _, key = jax.random.split(jstate.rng)
        eps = jax.random.normal(key, (N, Bt, ACT), dtype=jnp.float64)
        jstate, jstats = update(jstate, j_dmpo.Transition(
            *(jnp.asarray(x) for x in dataclasses.astuple(batch))))
        pstats = plearner.update(pstate, p_dmpo.Transition(
            *(_t(x) for x in dataclasses.astuple(batch))), eps=_t(eps))
        assert sorted(pstats) == sorted(jstats)
        for k in jstats:
            close(f"update {step} {k}", pstats[k], jstats[k], TOL_UPDATE)
        for name, carry in (("policy", p_params.policy_state_dict),
                            ("target_policy", p_params.policy_state_dict),
                            ("critic", p_params.critic_state_dict),
                            ("target_critic", p_params.critic_state_dict)):
            want = carry(numpy_tree(getattr(jstate, name + "_params")))
            got = getattr(pstate, name).state_dict()
            assert sorted(got) == sorted(want)
            for k in want:
                close(f"update {step} {name}.{k}", got[k], want[k],
                      TOL_UPDATE)
    assert (pstate.target_policy_copies, pstate.target_critic_copies) == (2, 1)


# ---- the CLI ----------------------------------------------------------------


def test_cli_vision_on_cpu():
    """The CLI trains vision_guided_flight with the vision networks in
    --test mode on the CPU: 2088 observation floats and 12 actions, and
    the first iteration's 80 updates give a finite critic loss."""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "flybody_tpu_torch.train_dmpo", "--task",
         "vision_guided_flight", "--network", "vision", "--test", "--device",
         "cpu", "--iterations", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
    assert "2088 observation floats, 12 actions" in res.stdout, res.stdout
    line = [x for x in res.stdout.splitlines() if x.startswith("[learner]")]
    assert len(line) == 1 and "learner_steps=80" in line[0], res.stdout
    assert "critic_loss=nan" not in line[0]
