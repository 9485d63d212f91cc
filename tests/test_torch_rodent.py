"""The port's rat against the JAX package, piece by piece (float64 on the
CPU, inputs seeded with numpy): the three box pairs, also on the rat's own
skull and jaw boxes head down on the floor; the arenas bit for bit; the
four committed assets (a fresh export, the JAX package's model, another
seed's heights written in); the walker's static tables and observables;
each task's reset from the JAX package's draws, reward and termination on
crafted states, the two-touch state machine through its phases; and the
observation layout the trainer flattens."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from flybody_tpu import rodent_envs as jre
from flybody_tpu.agents import networks as j_nets
from flybody_tpu.models import rodent as jrm
from flybody_tpu.physics import collision as JCOL
from flybody_tpu.physics import io_mj as jio
from flybody_tpu.tasks import rodent_arenas as JRA
from flybody_tpu.tasks import rodent_tasks as JRT
from flybody_tpu_torch import rodent_envs
from flybody_tpu_torch.agents import networks as p_nets
from flybody_tpu_torch.models import rodent as RM
from flybody_tpu_torch.physics import collision as COL
from flybody_tpu_torch.physics import forward as F
from flybody_tpu_torch.physics import io_mj
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.tasks import rodent_arenas as RA
from flybody_tpu_torch.tasks import rodent_tasks as RT

from torch_jax_state import close, to_jax

torch.set_num_threads(2)

B = 3
# the same float64 closed forms in another operation order
TOL_FORM = 1e-12
# kinematics and sensors of the same state, float64 (test_torch_physics)
TOL_KIN = 1e-10
KINDS = ("floor", "bowl", "gaps", "maze")
# each JAX factory with its arena kind
JAX_FACTORIES = {"floor": jre.rodent_two_touch, "bowl": jre.rodent_escape_bowl,
                 "gaps": jre.rodent_run_gaps, "maze": jre.rodent_maze_forage}
PORT_FACTORIES = {"floor": rodent_envs.rodent_two_touch,
                  "bowl": rodent_envs.rodent_escape_bowl,
                  "gaps": rodent_envs.rodent_run_gaps,
                  "maze": rodent_envs.rodent_maze_forage}


def _t(x):
    return torch.as_tensor(np.array(x))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@functools.lru_cache(maxsize=None)
def envs(kind):
    """(JAX env, port env) of ``kind``'s task, float64, built once."""
    return (JAX_FACTORIES[kind](dtype=jnp.float64),
            PORT_FACTORIES[kind](device="cpu", dtype=torch.float64))


def _rot(rng, n):
    """n random rotation matrices (n, 3, 3)."""
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], 1)


def _frames(rng, P, Bp, flat=()):
    """(P, 3, 3, Bp) rotations; the placements ``flat`` (pairs of (p, b))
    keep the identity."""
    m = np.moveaxis(_rot(rng, P * Bp).reshape(P, Bp, 3, 3), 1, -1).copy()
    for p, b in flat:
        m[p, :, :, b] = np.eye(3)
    return m


# ---- the box pairs ------------------------------------------------------


def _box_placements(pair, seed, P=6, Bp=5):
    """Seeded (p1, m1, s1, p2, m2, s2) of ``pair`` at the rat's sizes.
    plane-box: half the boxes lie flat on a level plane (exact corner
    ties), the rest are turned, all within a box size of the plane.
    sphere-box: centres inside the box (one at its very centre, where all
    three penetrations tie, one on a mid-plane), on a face and outside.
    capsule-box: capsules crossing, touching and missing turned boxes."""
    rng = np.random.RandomState(seed)
    box = rng.uniform(0.005, 0.02, (P, 3, 1))
    bpos = rng.uniform(-0.05, 0.05, (P, 3, Bp))
    if pair == "plane":
        flat = [(p, b) for p in range(P) for b in range(Bp) if (p + b) % 2]
        p1 = np.zeros((P, 3, Bp))
        m1 = np.broadcast_to(np.eye(3)[None, :, :, None], (P, 3, 3, Bp))
        bpos[:, 2] = rng.uniform(-1.5, 1.5, (P, Bp)) * box[:, 2]
        return [np.ascontiguousarray(a) for a in (
            p1, m1, np.zeros((P, 3, 1)), bpos, _frames(rng, P, Bp, flat),
            box)]
    m2 = _frames(rng, P, Bp)
    # offsets in the box frame, scaled by the box: inside, on and beyond
    u = rng.uniform(-1, 1, (P, 3, Bp)) * rng.choice(
        [0.5, 1.0, 1.5, 3.0], (P, 1, Bp))
    u[0, :, 0] = 0.0                                   # the very centre
    u[1, 0, 1] = 0.0                                   # on a mid-plane
    off = np.einsum("pijb,pjb->pib", m2, u * box)
    if pair == "sphere":
        s1 = np.concatenate([rng.uniform(0.002, 0.01, (P, 1, 1)),
                             np.zeros((P, 2, 1))], 1)
        return [np.ascontiguousarray(a) for a in (
            bpos + off, _frames(rng, P, Bp), s1, bpos, m2, box)]
    s1 = np.concatenate([rng.uniform(0.002, 0.008, (P, 1, 1)),
                         rng.uniform(0.005, 0.02, (P, 1, 1)),
                         np.zeros((P, 1, 1))], 1)
    return [np.ascontiguousarray(a) for a in (
        bpos + off, _frames(rng, P, Bp), s1, bpos, m2, box)]


_BOX_FN = {"plane": "_plane_box", "sphere": "_sphere_box",
           "capsule": "_capsule_box"}


@pytest.mark.parametrize("pair", ["plane", "sphere", "capsule"])
def test_box_pair_equal_to_jax(pair):
    """Each box pair against the JAX package's on seeded placements: dist,
    contact points and normals, slot for slot (the sorts' tie order
    included)."""
    args = _box_placements(pair, seed=len(pair))
    want = jax.jit(getattr(JCOL, _BOX_FN[pair]))(
        *(jnp.asarray(a) for a in args))
    got = getattr(COL, _BOX_FN[pair])(*(_t(a) for a in args))
    k = {"plane": 4, "sphere": 1, "capsule": 2}[pair]
    for name, g, w in zip(("dist", "pos", "normal"), got, want):
        assert g.shape[1] == k, name
        close(name, g, w, TOL_FORM)
    d = np.asarray(want[0])
    assert (d < 0).any() and (d > 0).any()
    if pair == "plane":
        # flat boxes: the four bottom corners tie, each at the same depth
        flat = np.asarray(args[4])[:, 2, 2] == 1.0
        dd = np.asarray(want[0]).transpose(0, 2, 1)[flat]
        assert np.all(dd == dd[:, :1])
    assert COL._dispatch(None, T.GEOM_PLANE, T.GEOM_BOX) is COL._plane_box


def lower_onto(pm, qpos, other=None, depth=0.002):
    """``qpos`` (nq, B) with the rat's root lowered (or raised) until its
    deepest contact with the ground (the arena's first geom type, the
    plane or the heightfield), among the rat's geoms of type ``other``
    (any by default), lies ``depth`` deep."""
    qpos = qpos.clone()
    g1, g2 = COL.slot_layout(pm).g1, COL.slot_layout(pm).g2
    gt = np.asarray(pm.geom_type)
    ground = (gt[g1] == T.GEOM_PLANE) | (gt[g1] == T.GEOM_HFIELD)
    slots = np.nonzero(ground & ((gt[g2] == other) if other is not None
                                 else True))[0]
    for _ in range(6):
        d = F.fwd_position(pm, io_mj.make_data(pm, qpos.shape[-1]).replace(
            qpos=qpos))
        dmin = COL._narrowphase(pm, d)[0][pm.ix(slots)].amin(dim=0)
        qpos[2] -= dmin + depth
    return qpos


def head_down(pm, qpos, depth=0.002, pitch=1.2):
    """``qpos`` (nq, B) with the rat's root pitched nose down by ``pitch``
    and lowered until its skull and jaw boxes reach ``depth`` into the
    floor (its deepest plane-box contact)."""
    qpos = qpos.clone()
    q = torch.tensor([np.cos(pitch / 2), 0.0, np.sin(pitch / 2), 0.0],
                     dtype=qpos.dtype)
    qpos[3:7] = q[:, None]
    return lower_onto(pm, qpos, T.GEOM_BOX, depth)


def test_box_pairs_on_the_rats_head():
    """The rat's 7 head boxes (skull and jaw) pitched nose down into the
    floor: every box pair of the model (plane-box, sphere-box and
    capsule-box) evaluated on those geoms' poses by both packages."""
    jenv, penv = envs("floor")
    pm = penv.model
    gt = np.asarray(pm.geom_type)
    boxes = [n for n, g in pm.names["geom"].items() if gt[g] == T.GEOM_BOX]
    assert sorted(boxes) == sorted(
        [f"walker/skull_P{i}_collision" for i in range(3)]
        + [f"walker/jaw_P{i}_collision" for i in range(4)])
    qpos = pm.qpos0[:, None].repeat(1, 2).clone()
    qpos[7:] += _t(0.05 * np.random.RandomState(3).randn(pm.nq - 7, 2))
    d = F.fwd_position(pm, io_mj.make_data(pm, 2).replace(
        qpos=head_down(pm, qpos)))
    groups = COL.slot_layout(pm).groups
    g1s, g2s = np.asarray(pm.pair_geom1), np.asarray(pm.pair_geom2)
    seen = {}
    for (t1, t2), idx in groups.items():
        if t2 != T.GEOM_BOX:
            continue
        a, b = pm.ix(g1s[idx]), pm.ix(g2s[idx])
        args = (d.geom_xpos[a], d.geom_xmat[a], pm.geom_size[a][..., None],
                d.geom_xpos[b], d.geom_xmat[b], pm.geom_size[b][..., None])
        got = COL._dispatch(pm, t1, t2)(*args)
        want = jax.jit(JCOL._dispatch(None, t1, t2))(
            *(jnp.asarray(_np(x)) for x in args))
        for name, g, w in zip(("dist", "pos", "normal"), got, want):
            close(f"{(t1, t2)} {name}", g, w, TOL_FORM)
        seen[(t1, t2)] = (len(idx), float(np.min(np.asarray(want[0]))))
    assert {k: v[0] for k, v in seen.items()} == {
        (T.GEOM_PLANE, T.GEOM_BOX): 7, (T.GEOM_SPHERE, T.GEOM_BOX): 79,
        (T.GEOM_CAPSULE, T.GEOM_BOX): 392}
    assert seen[(T.GEOM_PLANE, T.GEOM_BOX)][1] < -0.001


# ---- arenas, assets -----------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_arenas_equal_to_jax(seed):
    """Every arena bit for bit from the same seed: heights, sizes, the
    maze's spawn and target cells."""
    rs = lambda: np.random.RandomState(seed)
    np.testing.assert_array_equal(RA.terrain_bowl(rng=rs()),
                                  JRA.terrain_bowl(rng=rs()))
    for name, kw in (("bowl_arena", dict(seed=seed)),
                     ("gaps_corridor", dict(seed=seed)),
                     ("random_maze", dict(seed=seed)),
                     ("floor_arena", {})):
        mine, theirs = getattr(RA, name)(**kw), getattr(JRA, name)(**kw)
        for f in ("kind", "hfield_size", "hfield_pos", "size"):
            assert getattr(mine, f) == getattr(theirs, f), (name, f)
        for f in ("hfield_data", "spawn_positions", "target_positions"):
            a, b = getattr(mine, f), getattr(theirs, f)
            assert (a is None) == (b is None), (name, f)
            if a is not None:
                assert a.dtype == b.dtype, (name, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{name} {f}")


@pytest.mark.parametrize("kind", KINDS)
def test_committed_asset_is_a_fresh_export(kind):
    fresh = RM.export_model(kind, None)
    committed = RM.load_model(kind)
    assert sorted(fresh) == sorted(committed)
    for k in fresh:
        np.testing.assert_array_equal(np.asarray(fresh[k]), committed[k],
                                      err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_asset_matches_jax_model(kind):
    """The committed asset is the JAX package's MjModel field for field
    (the rat's tendons, sensors and filter / affine actuators included),
    and the port's put model has the JAX put model's sizes, candidate
    pairs, ccd classes and fused layout (R 96 = 16 + 8 + 3 x 24)."""
    jenv, penv = envs(kind)
    committed = RM.load_model(kind)
    theirs = io_mj.export_mj(jenv.mj_model)
    for k in committed:
        np.testing.assert_array_equal(committed[k], theirs[k], err_msg=k)
    pm, jm = penv.model, jenv.model
    assert (pm.nq, pm.nv, pm.nu, pm.na, pm.ntendon) == (74, 73, 38, 38, 8)
    for f in ("ncon_max", "nccd", "ccd_budget", "ccd_classes", "nefc",
              "nhfield", "hfield_nrow", "hfield_ncol"):
        assert getattr(pm, f) == getattr(jm, f), f
    for f in ("pair_geom1", "pair_geom2", "pair_type", "con_dim",
              "sensor_type", "ccd_geom1", "ccd_geom2"):
        np.testing.assert_array_equal(np.asarray(getattr(pm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    for f in ("body_mass", "geom_size", "actuator_gainprm",
              "actuator_biasprm", "actuator_dynprm", "hfield_data",
              "con_friction", "ccd_core"):
        np.testing.assert_array_equal(_np(getattr(pm, f)),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert io_mj.fused_dims(pm) == (96, 16, 24)
    counts = {}
    for t1, t2 in np.asarray(pm.pair_type):
        counts[(int(t1), int(t2))] = counts.get((int(t1), int(t2)), 0) + 1
    H, Bx = T.GEOM_HFIELD, T.GEOM_BOX
    assert counts[(T.GEOM_PLANE, Bx)] == 7
    assert sum(v for (a, _), v in counts.items() if a == H) == (
        0 if kind == "floor" else 93)
    assert (H, Bx) not in counts


@pytest.mark.parametrize("kind", ["bowl", "gaps", "maze"])
def test_another_seed_written_into_the_asset(kind):
    """Seed 1's heights written into the seed-0 asset give seed 1's fresh
    export, field for field, and the JAX package's seed-1 model's
    heightfield; the port's maze tables are seed 1's."""
    mj1 = RM.load_model(kind, seed=1)
    fresh = RM.export_model(kind, None, seed=1)
    for k in fresh:
        np.testing.assert_array_equal(mj1[k], fresh[k], err_msg=k)
    assert not np.array_equal(mj1["hfield_data"],
                              RM.load_model(kind)["hfield_data"])
    arena = {"bowl": lambda: JRA.bowl_arena(size=20.0, seed=1),
             "gaps": lambda: JRA.gaps_corridor(seed=1),
             "maze": lambda: JRA.random_maze(seed=1)}[kind]()
    spawn = (5.0, 0.0, 0.06) if kind == "gaps" else (0.0, 0.0, 0.06)
    jm, _ = jrm.make_rodent_model(arena, dtype=jnp.float64, spawn_pos=spawn,
                                  con_sel=jre._CON_SEL, **jre._FUSED)
    pm, parena = RM.make_rodent_model(kind, "cpu", torch.float64, seed=1,
                                      **rodent_envs.PUT_MODEL_KW)
    np.testing.assert_array_equal(_np(pm.hfield_data),
                                  np.asarray(jm.hfield_data))
    if kind == "maze":
        env = rodent_envs.rodent_maze_forage(device="cpu", seed=1)
        np.testing.assert_array_equal(env.task.spawn_positions,
                                      arena.spawn_positions)
        np.testing.assert_array_equal(env.task.target_positions,
                                      arena.target_positions)
        np.testing.assert_array_equal(parena.target_positions,
                                      arena.target_positions)


# ---- the walker ---------------------------------------------------------


def _state(penv, seed, qpos=None, Bs=B):
    """The port's Data of a seeded rat state with its kinematics and
    velocities done: hinge angles +-0.05 about qpos0, random qvel, act
    and ctrl (numpy), or the given ``qpos``."""
    pm = penv.model
    rng = np.random.RandomState(seed)
    d = io_mj.make_data(pm, Bs)
    if qpos is None:
        qpos = d.qpos.clone()
        qpos[7:] += _t(0.05 * rng.randn(pm.nq - 7, Bs))
    cr = _np(pm.actuator_ctrlrange)
    d = d.replace(qpos=qpos, qvel=_t(0.3 * rng.randn(pm.nv, Bs)),
                  act=_t(0.2 * rng.rand(pm.na, Bs)),
                  ctrl=_t(cr[:, :1] + (cr[:, 1:] - cr[:, :1])
                          * rng.rand(pm.nu, Bs)),
                  time=_t(rng.uniform(0, 1, Bs)))
    return F.fwd_velocity(pm, F.fwd_position(pm, d))


def test_walker_static_tables_and_observables():
    """The walker's tables equal the JAX walker's; its observables of a
    seeded state equal the JAX walker's of the same state (the JAX
    observables vmapped over the port's kinematics)."""
    jenv, penv = envs("floor")
    jw, pw = jenv.task.walker, penv.task.walker
    for f in ("root_body_id", "torso_id", "pelvis_id", "head_site",
              "head_body_id", "lhand_body", "rhand_body", "n_limb_tips",
              "root_qposadr", "sensor_adr", "action_size"):
        assert getattr(pw, f) == getattr(jw, f), f
    for f in ("end_effector_bodies", "end_effector_sites", "joint_qposadr",
              "joint_dofadr", "obs_joint_qposadr", "obs_joint_dofadr",
              "mocap_tracking_bodies", "walker_geoms", "nonfoot_geoms",
              "ground_geoms"):
        np.testing.assert_array_equal(getattr(pw, f), getattr(jw, f),
                                      err_msg=f)
    assert len(pw.nonfoot_geoms) > 0 and len(pw.ground_geoms) == 1
    for a, b in zip(pw.action_bounds(penv.model),
                    jw.action_bounds(jenv.model)):
        np.testing.assert_array_equal(a, b)
    pd = _state(penv, 4)
    jd = to_jax(pd, jenv.model)
    sm = pd.sensordata
    want = jax.jit(jax.vmap(
        lambda d, s: jw.observables(jenv.model, d, s), in_axes=(-1, -1)))(
            jd, jnp.asarray(_np(sm)))
    got = pw.observables(penv.model, pd, sm)
    assert sorted(got) == sorted(want)
    for k in want:
        close(k, got[k], want[k], TOL_KIN, scale=1.0)
    close("origin", pw.origin_obs(pd),
          jax.vmap(jw.origin_obs, in_axes=-1)(jd), TOL_KIN, scale=1.0)


def test_contact_flag_by_slot():
    """contact_flag reads ``warm_sel`` as candidate slot ids: a selected
    torso-floor slot with force flags the env, a walker-walker slot, a
    force-free torso-floor slot, a convex pair's slot and the -1 pad do
    not. (The slots' geoms come from the pair list, each pair repeated by
    its contact count.)"""
    _, penv = envs("floor")
    pm, w = penv.model, penv.task.walker
    ncon = [io_mj.PAIR_NCON[(int(a), int(b))]
            for a, b in np.asarray(pm.pair_type)]
    g1 = np.repeat(np.asarray(pm.pair_geom1), ncon)
    g2 = np.repeat(np.asarray(pm.pair_geom2), ncon)
    floor = pm.names["geom"]["floor"]
    torso = pm.names["geom"]["walker/collision_torso"]
    assert torso in w.nonfoot_geoms
    s_hit = int(np.nonzero((g1 == floor) & (g2 == torso))[0][0])
    s_self = int(np.nonzero((g1 != floor) & (g2 != floor))[0][0])
    d = io_mj.make_data(pm, 5)
    sel = torch.full_like(d.warm_sel, -1)
    f = torch.zeros_like(d.warm_f)
    sel[0, 0], f[0, 0, 0] = s_hit, 1.0      # flagged
    sel[0, 1], f[0, 0, 1] = s_self, 1.0     # walker-walker
    sel[0, 2] = s_hit                        # no force
    sel[0, 3], f[0, 0, 3] = pm.ncon_max + 5, 1.0   # a convex pair
    f[0, 0, 4] = 1.0                         # the pad
    flag = w.contact_flag(pm, d.replace(warm_sel=sel, warm_f=f),
                          w.nonfoot_geoms, w.ground_geoms)
    np.testing.assert_array_equal(flag.numpy(), [1, 0, 0, 0, 0])


# ---- the tasks ----------------------------------------------------------


def _jax_init(jenv, keys):
    """The JAX package's reset draws (as FlyEnv.reset splits ``keys``) and
    its init_state outputs (qpos, task state) for them."""
    jm, task = jenv.model, jenv.task
    init_keys = jax.vmap(jax.random.split)(keys)[:, 1]
    jd = jio.make_data(jm, B=keys.shape[0], dtype=jnp.float64)
    d, ts = jax.vmap(lambda dd, k: task.init_state(jm, dd, k),
                     in_axes=(-1, 0), out_axes=-1)(jd, init_keys)
    pi2 = dict(minval=0.0, maxval=2 * np.pi)
    draws = {}
    if isinstance(task, JRT.EscapeBowl):
        draws["yaw"] = jax.vmap(lambda k: jax.random.uniform(k, (), **pi2))(
            init_keys)
    elif isinstance(task, JRT.ManyGoalsMaze):
        ks, ky = jax.vmap(jax.random.split, out_axes=1)(init_keys)
        S = len(task.spawn_positions)
        draws["spawn_idx"] = jax.vmap(
            lambda k: jax.random.randint(k, (), 0, S))(ks)
        draws["yaw"] = jax.vmap(lambda k: jax.random.uniform(k, (), **pi2))(
            ky)
    elif isinstance(task, JRT.TwoTouch):
        kt, ky = jax.vmap(jax.random.split, out_axes=1)(init_keys)
        draws["target"] = jax.vmap(
            lambda k: task._sample_target(k, jnp.float64), out_axes=-1)(kt)
        draws["yaw"] = jax.vmap(lambda k: jax.random.uniform(k, (), **pi2))(
            ky)
    return {k: _t(v) for k, v in draws.items()}, d, ts


@pytest.mark.parametrize("kind", KINDS)
def test_init_state_from_jax_draws(kind):
    """Each task's init_state from the JAX package's draws gives its
    spawn (position and yaw quaternion) and task state; with no draws
    given it draws from the generator in its fixed order (the same
    generator, the same state)."""
    jenv, penv = envs(kind)
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    draws, jd, jts = _jax_init(jenv, keys)
    pm = penv.model
    pd, pts = penv.task.init_state(pm, io_mj.make_data(pm, B), None,
                                   **draws)
    close("qpos", pd.qpos, jd.qpos, TOL_FORM, scale=1.0)
    assert sorted(pts) == sorted(k for k in jts if k != "rng")
    for k, v in pts.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(jts[k]),
                                      err_msg=k)
    gen = lambda: torch.Generator().manual_seed(1)
    a = penv.task.init_state(pm, io_mj.make_data(pm, B), gen())
    b = penv.task.init_state(pm, io_mj.make_data(pm, B), gen())
    assert torch.equal(a[0].qpos, b[0].qpos)
    quat = a[0].qpos[3:7]
    np.testing.assert_allclose(torch.linalg.vector_norm(quat, dim=0), 1.0)
    assert (kind == "gaps") == bool((quat[0] == 1.0).all())


def _reward_case(jenv, penv, pd, pts, jts, sm, **port_kw):
    """One reward_step of both packages on the same crafted state; returns
    the port's outputs after holding every output against JAX's."""
    jm, pm = jenv.model, penv.model
    jd = to_jax(pd, jm)
    want = jax.jit(jax.vmap(
        lambda d, ts, s: jenv.task.reward_step(jm, d, ts, s),
        in_axes=(-1, -1, -1), out_axes=(0, 0, 0, -1)))(
            jd, jts, jnp.asarray(_np(sm)))
    got = penv.task.reward_step(pm, pd, pts, sm, **port_kw)
    for name, g, w in zip(("reward", "terminated", "discount"), got, want):
        close(name, g.double() if name == "terminated" else g,
              np.asarray(w, np.float64), TOL_FORM, scale=1.0)
    for k, v in got[3].items():
        close(f"ts.{k}", v.double(), np.asarray(want[3][k], np.float64),
              TOL_FORM, scale=1.0)
    return got, want


def _ts_pair(pts):
    """The same task state for JAX (numpy leaves) and the port."""
    return pts, {k: jnp.asarray(_np(v)) for k, v in pts.items()}


@pytest.mark.parametrize("kind", ["bowl", "gaps", "maze"])
def test_reward_and_termination(kind):
    """reward_step of EscapeBowl, RunThroughCorridor and ManyGoalsMaze on
    crafted states: env 0 seeded, env 1 upside down (the maze's aliveness
    failure) with stale timers, env 2 with a NaN qpos (fatal) and its end
    effectors below the corridor's -0.3 m; the head on a maze target."""
    jenv, penv = envs(kind)
    pm = penv.model
    rng = np.random.RandomState(7)
    qpos = io_mj.make_data(pm, B).qpos.clone()
    qpos[7:] += _t(0.05 * rng.randn(pm.nq - 7, B))
    qpos[3:7, 1] = _t([0.0, 1.0, 0.0, 0.0])           # upside down
    qpos[2, 2] = -0.5                                  # below the floor
    pd = _state(penv, 8, qpos=qpos)
    qnan = pd.qpos.clone()
    qnan[10, 2] = float("nan")
    pd = pd.replace(qpos=qnan)
    sm = _t(rng.randn(pm.nsensordata, B))
    pts = penv.task.init_state(pm, io_mj.make_data(pm, B),
                               torch.Generator().manual_seed(0))[1]
    pts = dict(pts, timer=torch.tensor([3, 299, 149], dtype=torch.int32))
    if "prev_reward" in pts:
        pts["prev_reward"] = _t(rng.uniform(0, 0.2, B))
    if "prev_escape" in pts:
        pts["prev_escape"] = _t(rng.uniform(0, 0.1, B))
    if kind == "maze":
        # the second target under env 0's head (at the targets' height);
        # env 1 has reached every target but that one
        t = penv.task.target_positions.copy()
        t[1] = _np(penv.task.walker.head_pos(pd)[0, :2])
        args = (penv.task.spawn_positions, t)
        penv = _Env(penv.model, RT.ManyGoalsMaze(penv.task.walker, *args))
        jenv = _Env(jenv.model, JRT.ManyGoalsMaze(jenv.task.walker, *args))
        rew = torch.ones_like(pts["rewarded"])
        rew[:, 0] = False
        rew[1, 1] = False
        pts["rewarded"] = rew
    got, want = _reward_case(jenv, penv, pd, *_ts_pair(pts), sm)
    term = got[1].numpy()
    assert term[2] and np.isfinite(got[0].numpy()).all()
    if kind == "maze":
        assert got[0][0] > 50 and term[1] and got[2][1] == 0


class _Env:
    """A model and a task, as _reward_case reads an env."""

    def __init__(self, model, task):
        self.model, self.task = model, task


def _two_touch_state(penv, target, t, **kw):
    """The port's TwoTouch task state (3 envs) at ``target``, with the
    state-machine fields of ``kw``."""
    pts = penv.task.init_state(penv.model, io_mj.make_data(penv.model, B),
                               torch.Generator().manual_seed(0),
                               target=target)[1]
    pts.update({k: torch.as_tensor(v, dtype=pts[k].dtype)
                for k, v in kw.items()})
    return pts


def test_two_touch_state_machine():
    """The TwoTouch state machine through its phases, each step held
    against the JAX package's reward_step on the same state: a first
    touch (env 0, +25), a touch held (env 1, no event), a second touch too
    soon (env 2, timeout on), then a second touch in time, the window
    passing with no second touch, the timeout running out, and the
    respawn taking JAX's new target (drawn from its carried key) in place
    of the generator's draw."""
    jenv, penv = envs("floor")
    pm, jt, pt = penv.model, jenv.task, penv.task
    pd = _state(penv, 9)
    hand = pd.xpos[pt.walker.lhand_body]                    # (3, B)
    far = hand + 1.0
    sm = pd.sensordata
    keys = jax.random.split(jax.random.PRNGKey(2), B)

    def run(target, time, **kw):
        pts = _two_touch_state(penv, target, time, **kw)
        jts = {k: jnp.asarray(_np(v)) for k, v in pts.items()}
        jts["rng"] = jnp.moveaxis(keys, 0, -1)
        k1 = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        new = jax.vmap(lambda k: jt._sample_target(k, jnp.float64),
                       out_axes=-1)(k1)
        d = pd.replace(time=_t(time))
        return _reward_case(jenv, penv, d, pts, jts, sm,
                            new_target=_t(new))[0]

    P, O = RT.PRE_TOUCH, RT.TOUCHED_ONCE
    # a first touch; a touch held over; a second touch 0.3 s after the
    # first (too soon)
    r, _, _, ts = run(torch.stack([hand[:, 0], hand[:, 1], hand[:, 2]], 1),
                      [1.0, 1.0, 1.0], state=[P, O, O],
                      touching_prev=[False, True, False],
                      first_t=[0.0, 0.9, 0.7])
    np.testing.assert_array_equal(ts["state"].numpy(),
                                  [O, O, RT.TOUCHED_TOO_SOON])
    assert r[0] > 25 and r[2] < 25 and bool(ts["do_time_out"][2])
    # a second touch in time (env 0), the window over (env 1), the
    # timeout over (env 2)
    r, _, _, ts = run(torch.stack([hand[:, 0], far[:, 1], far[:, 2]], 1),
                      [2.0, 2.0, 3.0], state=[O, O, RT.TOUCHED_TOO_SOON],
                      first_t=[1.2, 1.0, 1.0], second_t=[0.0, 0.0, 1.5],
                      do_time_out=[False, False, True])
    np.testing.assert_array_equal(
        ts["state"].numpy(),
        [RT.TOUCHED_TWICE, RT.NO_SECOND_TOUCH, RT.TOUCHED_TOO_SOON])
    assert r[0] > 25 and not bool(ts["do_time_out"][2])
    # TOUCHED_TWICE at once respawns; TOUCHED_TOO_SOON with its timeout
    # over respawns; NO_SECOND_TOUCH within its timeout waits
    r, _, _, ts = run(far, [3.0, 3.0, 3.0],
                      state=[RT.TOUCHED_TWICE, RT.TOUCHED_TOO_SOON,
                             RT.NO_SECOND_TOUCH],
                      second_t=[2.0, 1.0, 2.5],
                      do_time_out=[False, False, True], timer=[0, 5, 299])
    np.testing.assert_array_equal(ts["state"].numpy(),
                                  [P, P, RT.NO_SECOND_TOUCH])
    assert not torch.equal(ts["target"][:, 0], far[:, 0])
    assert torch.equal(ts["target"][:, 2], far[:, 2])


def test_two_touch_draws_in_the_step():
    """The env passes its generator to TwoTouch.reward_step: one
    control step from the same generator state draws the same new
    targets; reward_factors draws nothing (the global generator is left
    as it was)."""
    _, penv = envs("floor")
    pm, task = penv.model, penv.task
    assert task.step_draws and not RT.EscapeBowl.step_draws
    pd = _state(penv, 10)
    pts = _two_touch_state(penv, pd.xpos[task.walker.lhand_body] + 1.0,
                           None, state=[RT.TOUCHED_TWICE] * B)
    outs = [task.reward_step(pm, pd, pts, pd.sensordata,
                             generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(outs[0][3]["target"], outs[1][3]["target"])
    assert (outs[0][3]["state"] == RT.PRE_TOUCH).all()
    before = torch.get_rng_state()
    task.reward_factors(pm, pd, pts, pd.sensordata)
    assert torch.equal(before, torch.get_rng_state())


# ---- what the trainer flattens ------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_observations_and_flat_layout(kind):
    """Each task's observations of its reset state (from JAX's draws)
    equal the JAX task's observations of the same state, key for key,
    and both packages' obs_layout give the same keys, sizes and order;
    the flattened rows agree."""
    jenv, penv = envs(kind)
    keys = jax.random.split(jax.random.PRNGKey(6), B)
    draws = _jax_init(jenv, keys)[0]
    st = penv.reset(B, **draws)
    jd = to_jax(st.data, jenv.model)
    jts = {k: jnp.asarray(_np(v)) for k, v in st.task_state.items()}
    if isinstance(jenv.task, JRT.TwoTouch):
        jts["rng"] = jnp.moveaxis(keys, 0, -1)
    want = jax.jit(jax.vmap(
        lambda d, ts, s: jenv.task.observations(jenv.model, d, ts, s),
        in_axes=(-1, -1, -1)))(jd, jts, jnp.asarray(_np(st.data.sensordata)))
    assert sorted(st.obs) == sorted(want)
    for k in want:
        close(k, st.obs[k], want[k], TOL_KIN, scale=1.0)
    pkeys, pslices = p_nets.obs_layout(st.obs)
    jkeys, jslices = j_nets.obs_layout(want)
    assert pkeys == jkeys and pslices == jslices
    close("flat", p_nets.batch_concat(st.obs, pkeys, num_batch_dims=1),
          j_nets.batch_concat(want, jkeys, num_batch_dims=1), TOL_KIN,
          scale=1.0)
    size = sum(s[1] for s in pslices.values())
    assert size == (165 if kind == "floor" else 162)
