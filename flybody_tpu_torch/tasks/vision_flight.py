"""Vision-guided flight over procedural terrain.

The winged fly of flight_imitation, driven by the wing-beat pattern
generator (WBPG), flies over a sine-trench or sine-bumps heightfield
(reference vnl_ray/tasks/vision_flight.py). Its two 32x32 eyes are
rendered on the device every control step by the raycaster of
``ops/raycast.py``. Each eye casts against the largest primitive geoms of
the model less those that contain it (geoms of the head, the body the eye
rides on), so that it sees the terrain, the sky and the fly's other geoms,
not the inside of the head. ``task_input`` is the env's (target height,
target speed); the reward is the product of height-over-terrain, x-speed,
speed, side-speed, body-axis and (over the trench) trench-centre tolerance
factors (reference :155-214). Any active contact with the terrain (the
world body) is fatal (reference :216-228), as is flying too low, an
exploding qacc or a NaN state.

The model comes from ``models/assets/vision_flight_<terrain>_model.npz``,
written by ``export_model`` where mujoco is installed (``python -m
flybody_tpu_torch.tasks.vision_flight`` rewrites both). Besides the fields
``put_model`` reads, the asset carries the cameras' bodies, offsets and
rotations, which the eye renderer needs. Loading needs only numpy, so the
env builds on machines without mujoco.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from flybody_tpu_torch.envs.core import FlyEnv, Task
from flybody_tpu_torch.envs.walker import FlyWalker
from flybody_tpu_torch.math.quaternions import quat_to_mat
from flybody_tpu_torch.ops import raycast
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.tasks import arenas
from flybody_tpu_torch.tasks import constants as C
from flybody_tpu_torch.tasks.pattern_generators import (
    WBPGState, WingBeatPatternGenerator)
from flybody_tpu_torch.utils import rewards as rwu
from flybody_tpu_torch.utils import telemetry as tm

_ASSETS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "models",
                       "assets")
MODEL_PATHS = {t: os.path.join(_ASSETS, f"vision_flight_{t}_model.npz")
               for t in ("trench", "bumps")}

# the wing actuators' filter time constant the committed models are built
# with
JOINT_FILTER = 0.0002
HFIELD_POS = (8.0, 0.0, 0.0)

# Engine budgets of the env (the JAX package's): condim-1 self-contact
# sensing (8), 16 analytic condim-3 contacts (the terrain's and the
# self-collision capsules'), 32 convex lanes; the fused solver's (limit
# rows, cones) and one contact selection per control step (4 substeps).
# The fused solve has 8 limit + 8 condim-1 + 3 x 24 cone = 88 rows.
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 16}, ccd_budget=32,
                    contact_solver="fused", fused_sel=(8, 24),
                    col_refresh=4)

_WING_JOINTS = [f"wing_{axis}_{side}" for side in ("left", "right")
                for axis in ("yaw", "roll", "pitch")]
# the eyes' field of view (FlyConfig.eye_camera_fovy) and the number of
# primitive geoms they see, the largest of the model
EYE_FOVY = 150.0
EYE_GEOMS = 16
# samples of the terrain march a ray (ops/raycast.terrain_hit's default)
MARCH_SAMPLES = 48


@dataclasses.dataclass
class VisionFlightState:
    wbpg: WBPGState
    target_height: torch.Tensor  # (B,)
    target_speed: torch.Tensor   # (B,)


def terrain(bumps_or_trench: str):
    """(heightfield data (nrow, ncol) float32, TrenchSpecs or None)."""
    if bumps_or_trench == "trench":
        return arenas.sine_trench()
    if bumps_or_trench == "bumps":
        return arenas.sine_bumps(), None
    raise ValueError(f"unknown terrain {bumps_or_trench!r}")


def build_mj_model(bumps_or_trench: str = "trench",
                   joint_filter: float = JOINT_FILTER):
    """Compile the vision_guided_flight MjModel (needs mujoco): the flight
    fly of flight_imitation (wings on, legs off, free root, hover pitch,
    one user action, the wing fluid and the flying-base edits) over the
    terrain heightfield. Returns (mj_model, action_maps)."""
    from flybody_tpu_torch.models import fruitfly as ff
    wp = C.WING_PARAMS
    cfg = ff.FlyConfig(
        use_legs=False, use_wings=True, joint_filter=joint_filter,
        root_joint="free", body_pitch_angle=C.BODY_PITCH_ANGLE,
        physics_timestep=C.FLY_PHYSICS_TIMESTEP,
        control_timestep=C.FLY_CONTROL_TIMESTEP,
        num_user_actions=1, wing_fluid=True)
    morph = ff.apply_surgery(ff.load_morphology(), cfg)
    for b in morph.bodies:
        for j in b.joints:
            if j.name in _WING_JOINTS:
                j.stiffness = wp["stiffness"]
                j.damping = wp["damping"]
        for g in b.geoms:
            if g.fluidshape:
                g.fluidcoef = wp["fluidcoef"]
    for a in morph.actuators:
        if a.name.startswith("wing_"):
            a.gainprm = a.gainprm.copy()
            a.gainprm[0] = wp["gainprm"][0]
    data_hf, _ = terrain(bumps_or_trench)
    spec = ff.to_spec(morph, cfg, arena_fn=lambda s: arenas.add_heightfield(
        s, data_hf, pos=HFIELD_POS))
    return spec.compile(), ff.action_indices(morph, cfg)


def export_model(bumps_or_trench: str = "trench", path: str | None = "",
                 **build_kw) -> dict:
    """Build the model with mujoco and return the mapping ``put_model``
    reads, plus the action maps and the cameras' poses in their bodies
    (``cam_bodyid``, ``cam_pos``, ``cam_quat``); write it to ``path``
    (the committed asset with "", nowhere with None)."""
    from flybody_tpu_torch.physics import io_mj
    mj_model, amap = build_mj_model(bumps_or_trench, **build_kw)
    out = io_mj.export_mj(mj_model)
    out["action_maps_json"] = np.asarray(json.dumps(amap, sort_keys=True))
    out["cam_bodyid"] = np.asarray(mj_model.cam_bodyid, np.int32).copy()
    out["cam_pos"] = np.asarray(mj_model.cam_pos).copy()
    out["cam_quat"] = np.asarray(mj_model.cam_quat).copy()
    if path is not None:
        np.savez_compressed(path or MODEL_PATHS[bumps_or_trench], **out)
    return out


def load_model(bumps_or_trench: str = "trench") -> dict:
    """The committed model mapping of the terrain (numpy only)."""
    with np.load(MODEL_PATHS[bumps_or_trench], allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def contains(geom_type: int, size, p) -> bool:
    """True where the point ``p`` (3,), in a geom's frame, lies inside the
    geom as the raycaster casts it (a cylinder as a capsule)."""
    p, size = np.asarray(p, np.float64), np.asarray(size, np.float64)
    if geom_type == T.GEOM_SPHERE:
        return bool(p @ p < size[0] ** 2)
    if geom_type == T.GEOM_ELLIPSOID:
        return bool(np.sum((p / size) ** 2) < 1.0)
    if geom_type in (T.GEOM_CAPSULE, T.GEOM_CYLINDER):
        axis = np.clip(p[2], -size[1], size[1])
        return bool(p[0] ** 2 + p[1] ** 2 + (p[2] - axis) ** 2
                    < size[0] ** 2)
    if geom_type == T.GEOM_BOX:
        return bool(np.all(np.abs(p) < size))
    return False


def eye_geoms(model: Model, geom_ids, body: int, pos) -> np.ndarray:
    """``geom_ids`` less the geoms that contain the point ``pos`` (3,) of
    body ``body``'s frame. Only the body's own geoms are fixed relative to
    the point, so only they are tested, once."""
    gb = np.asarray(model.geom_bodyid)
    gt = np.asarray(model.geom_type)
    gpos = model.geom_pos.detach().cpu().double().numpy()
    gmat = quat_to_mat(model.geom_quat.detach().cpu().double()).numpy()
    gsize = model.geom_size.detach().cpu().double().numpy()
    pos = np.asarray(pos, np.float64)
    return np.asarray([
        g for g in geom_ids
        if not (gb[g] == body and contains(
            gt[g], gsize[g], gmat[g].T @ (pos - gpos[g])))], np.int64)


def _fma32(a, b, c) -> np.float32:
    """float32 a * b + c with one rounding (the product is exact in
    float64)."""
    return np.float32(np.float64(a) * np.float64(b) + np.float64(c))


def camera_rotation(quat) -> np.ndarray:
    """A camera's unit quaternion (4,) -> its 3x3 rotation in float32, as
    the JAX package's compiled step computes it from the float32
    quaternion: XLA contracts each a b + c d into fma(a, b, c d)."""
    w, x, y, z = np.asarray(quat, np.float32)
    s = lambda a, b, c, d: _fma32(a, b, c * d)          # a b + c d
    m = lambda a, b, c, d: _fma32(a, b, -(c * d))       # a b - c d
    return np.array([
        [1 - 2 * s(y, y, z, z), 2 * m(x, y, w, z), 2 * s(x, z, w, y)],
        [2 * s(x, y, w, z), 1 - 2 * s(x, x, z, z), 2 * m(y, z, w, x)],
        [2 * m(x, z, w, y), 2 * s(y, z, w, x), 1 - 2 * s(x, x, y, y)],
    ], np.float32)


class VisionFlightWBPG(Task):
    ctrl_dt = C.FLY_CONTROL_TIMESTEP
    phys_dt = C.FLY_PHYSICS_TIMESTEP
    # every reset draws targets, a start and a wing-beat phase per env
    deterministic_init = False

    def __init__(self, walker: FlyWalker, wbpg: WingBeatPatternGenerator,
                 hfield_pos, trench: arenas.TrenchSpecs | None, cam_pose,
                 time_limit: float = 0.4, target_height_range=(0.4, 0.6),
                 target_speed_range=(20.0, 40.0),
                 init_pos_x_range=(-1.0, -0.5),
                 init_pos_y_range=(-0.2, 0.2), eye_size: int = 32):
        """``cam_pose``: (bodyid (ncam,), pos (ncam, 3), quat (ncam, 4)) of
        the model's cameras in their bodies."""
        self.walker = walker
        self.wbpg = wbpg
        self.time_limit = time_limit
        self.action_size = walker.action_size  # includes 1 user action
        self.target_height_range = target_height_range
        self.target_speed_range = target_speed_range
        self.init_pos_x_range = init_pos_x_range
        self.init_pos_y_range = init_pos_y_range
        self.trench = trench
        model = walker.model
        dev, dtype = model.device, model.dtype
        names = model.names
        self.hfield_pos = np.asarray(hfield_pos, np.float32)
        wing_ids = np.array([names["joint"][n] for n in _WING_JOINTS])
        self.wing_qposadr = np.asarray(model.jnt_qposadr)[wing_ids]
        self.wing_dofadr = np.asarray(model.jnt_dofadr)[wing_ids]
        amap = walker.action_maps
        self.wing_action_idx = np.asarray(amap["action"]["wings"], np.int64)
        self.user_action_idx = int(amap["action"]["user"][0])
        self.root_qposadr = int(np.asarray(model.jnt_qposadr)[0])
        self.rel_range = float(wbpg.beat_freqs[-1] / wbpg.base_beat_freq
                               - 1.0)
        # each eye's body, offset and float32 rotation in it
        bodyid, pos, quat = cam_pose
        self.eyes, eye_pos = [], []
        for key, cam in (("left_eye", "eye_left"), ("right_eye", "eye_right")):
            c = names["camera"].get(cam)
            if c is not None:
                eye_pos.append(pos[c])
                self.eyes.append((
                    key, int(bodyid[c]),
                    torch.as_tensor(np.asarray(pos[c], np.float32),
                                    device=dev).to(dtype),
                    torch.as_tensor(camera_rotation(quat[c]),
                                    device=dev).to(dtype)))
        theta = np.deg2rad(C.BODY_PITCH_ANGLE)
        self.target_zaxis = torch.as_tensor(
            np.array([np.sin(theta), 0.0, np.cos(theta)], np.float32),
            device=dev).to(dtype)
        # float32 rays, as the JAX package's camera_rays default
        self.rays = raycast.camera_rays(EYE_FOVY, eye_size, eye_size,
                                        device=dev).to(dtype)
        # the primitive geoms in view (the fly's own body and any obstacle
        # geom): the largest EYE_GEOMS bound the cost per pixel. Each eye
        # casts against them less the geoms that contain it, which it
        # would see from the inside at every pixel
        gt = np.asarray(model.geom_type)
        gs = model.geom_size.detach().cpu().numpy()
        prim = np.nonzero((gt != T.GEOM_PLANE) & (gt != T.GEOM_HFIELD))[0]
        if len(prim):
            order = np.argsort(-gs[prim].max(axis=-1))
            prim = prim[order[:EYE_GEOMS]]
        self.scene_geoms = prim
        self.eye_geoms = [eye_geoms(model, prim, body, p)
                          for (_, body, _, _), p in zip(self.eyes, eye_pos)]
        self.eye_casts = []
        for ids in self.eye_geoms:
            cast, has_scene = raycast.make_scene_raycaster(model, ids)
            self.eye_casts.append(cast if has_scene else None)
        self.march_samples = MARCH_SAMPLES
        # the hover orientation: the body pitched at BODY_PITCH_ANGLE
        self.init_quat = torch.as_tensor(np.array(
            [np.cos(-theta / 2), 0.0, np.sin(-theta / 2), 0.0], np.float32),
            device=dev).to(dtype)
        self.height_fn = raycast.hfield_height_fn(
            model.hfield_data[0], model.hfield_size[0], self.hfield_pos)
        if trench is not None:
            # the trench centre per heightfield column, float32 as in JAX
            self.trench_xs = torch.as_tensor(np.linspace(
                self.hfield_pos[0] - 12.0, self.hfield_pos[0] + 12.0,
                len(trench.center_y)).astype(np.float32), device=dev)
            self.trench_cy = (torch.as_tensor(trench.center_y, device=dev)
                              * 3.0 + float(self.hfield_pos[1]))

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def init_state(self, model: Model, data: Data, generator,
                   target_height=None, target_speed=None, x0=None, y0=None,
                   initial_phase=None):
        """Each env starts level at its target height over the terrain at
        (x0, y0), flying at its target speed along x, its wings at a point
        of the beat. Each of the five (B,) values is drawn from
        ``generator`` (on the env's device) in that order unless given."""
        B = data.qpos.shape[-1]
        dev, dtype = data.qpos.device, data.qpos.dtype

        def draw(given, rng):
            if given is not None:
                return torch.as_tensor(given, device=dev).to(dtype)
            u = torch.rand((B,), generator=generator, device=dev,
                           dtype=dtype)
            return rng[0] + (rng[1] - rng[0]) * u

        th = draw(target_height, self.target_height_range)
        tv = draw(target_speed, self.target_speed_range)
        x0 = draw(x0, self.init_pos_x_range)
        y0 = draw(y0, self.init_pos_y_range)
        initial_phase = draw(initial_phase, (0.0, 1.0))
        z0 = self.height_fn(x0, y0) + th
        angles, wing_qvel, wbpg_state = self.wbpg.reset(initial_phase)
        a = self.root_qposadr
        qpos = data.qpos.clone()
        qpos[a:a + 3] = torch.stack([x0, y0, z0])
        qpos[a + 3:a + 7] = self.init_quat[:, None]
        qpos[model.ix(self.wing_qposadr)] = angles.T.to(dtype)
        qvel = data.qvel.clone()
        qvel[0] = tv
        qvel[model.ix(self.wing_dofadr)] = wing_qvel.T.to(dtype)
        ts = VisionFlightState(wbpg=wbpg_state, target_height=th,
                               target_speed=tv)
        return data.replace(qpos=qpos, qvel=qvel), ts

    def before_step(self, model: Model, data: Data, ts: VisionFlightState,
                    action):
        """The user action sets the requested beat frequency; the WBPG's
        target minus the wings' angles is added to the wing actions."""
        act = torch.clamp(action[:, self.user_action_idx], -1.0, 1.0)
        ctrl_freq = self.wbpg.base_beat_freq * (1.0 + self.rel_range * act)
        target, wbpg_state = self.wbpg.step(ts.wbpg, ctrl_freq)
        wing = model.ix(self.wing_action_idx)
        wing_qpos = data.qpos[model.ix(self.wing_qposadr)].T
        action = action.clone()
        action[:, wing] = action[:, wing] + (target - wing_qpos)
        data = self.walker.apply_action(data, action)
        return data, dataclasses.replace(ts, wbpg=wbpg_state)

    def camera_pose(self, data: Data, bodyid: int, pos, mat):
        """World position (B, 3) and rotation (B, 3, 3) of a camera at
        ``pos`` / ``mat`` in body ``bodyid``."""
        base_pos = data.xpos[bodyid].T
        base_mat = data.xmat[bodyid].permute(2, 0, 1)
        return (base_pos + torch.einsum("bij,j->bi", base_mat, pos),
                base_mat @ mat)

    def render_eyes(self, model: Model, data: Data,
                    distance: bool = False) -> dict:
        """{eye key: (B, H, W) intensity} of both eyes (with ``distance``,
        each pixel's nearest hit distance), in the span ``render.eyes``,
        timed on the device; its counters: the rays, the march's samples
        a ray and the primitives cast, summed over the eyes."""
        gx = data.geom_xpos.permute(2, 0, 1)
        gm = data.geom_xmat.permute(3, 0, 1, 2)
        out = {}
        with tm.span("render.eyes", device=gx.device):
            for (key, body, pos, mat), cast in zip(self.eyes,
                                                   self.eye_casts):
                cam_pos, cam_mat = self.camera_pose(data, body, pos, mat)
                out[key] = raycast.render_eye(
                    cam_pos, cam_mat, self.rays, self.height_fn,
                    n_steps=self.march_samples, scene_cast=cast,
                    geom_xpos=gx, geom_xmat=gm, distance=distance)
        tm.count("render.rays", gx.shape[0] * self.rays.shape[0]
                 * self.rays.shape[1] * len(self.eyes))
        tm.count("render.march_samples", self.march_samples)
        tm.count("render.primitives", sum(len(g) for g in self.eye_geoms))
        return out

    def observations(self, model: Model, data: Data, ts: VisionFlightState,
                     sensor_mean) -> dict:
        w = self.walker
        obs = w.observables(model, data, sensor_mean)
        obs["world_zaxis_hover"] = w.world_zaxis_hover(model, data)
        obs["task_input"] = torch.stack([ts.target_height, ts.target_speed],
                                        dim=1)
        # the flight observes its wing joints only
        obs["joints_pos"] = data.qpos[model.ix(self.wing_qposadr)].T
        obs["joints_vel"] = data.qvel[model.ix(self.wing_dofadr)].T
        obs.update(self.render_eyes(model, data))
        return obs

    def reward_term_discount(self, model: Model, data: Data,
                             ts: VisionFlightState, sensor_mean):
        a = self.root_qposadr
        dtype = data.qpos.dtype
        xpos = data.qpos[a:a + 3]                          # (3, B)
        terrain_h = self.height_fn(xpos[0], xpos[1])
        lin = dict(sigmoid="linear", value_at_margin=0.0)
        height = rwu.tolerance(xpos[2] - terrain_h,
                               bounds=(ts.target_height, ts.target_height),
                               margin=0.15, **lin)
        vel_world = data.qvel[:3]
        x_speed = rwu.tolerance(vel_world[0],
                                bounds=(ts.target_speed, float("inf")),
                                margin=1.1 * ts.target_speed, **lin)
        speed = rwu.tolerance(torch.linalg.vector_norm(vel_world, dim=0),
                              bounds=(ts.target_speed, ts.target_speed),
                              margin=1.1 * ts.target_speed, **lin)
        vel_ego = self.walker.sensor_obs(sensor_mean, "velocimeter")
        side_speed = rwu.tolerance(vel_ego[:, 1], bounds=(0.0, 0.0),
                                   margin=10.0, **lin)
        zaxis = data.xmat[self.walker.thorax_id, 2]        # (3, B)
        angle = torch.arccos(torch.clamp(
            torch.sum(self.target_zaxis[:, None] * zaxis, dim=0), -1.0, 1.0))
        world_zaxis = rwu.tolerance(angle, bounds=(0.0, 0.0), margin=np.pi,
                                    **lin)
        reward = height * x_speed * speed * side_speed * world_zaxis
        if self.trench is not None:
            idx = torch.argmin(torch.abs(self.trench_xs[:, None]
                                         - xpos[0][None]), dim=0)
            cy = self.trench_cy[idx].to(dtype)
            reward = reward * rwu.tolerance(xpos[1], bounds=(cy, cy),
                                            margin=0.15, **lin)

        # fatal terrain contact: any active contact of the world body
        floor_hit = torch.zeros_like(reward, dtype=torch.bool)
        if model.ncon_max:
            con = data.contact
            world = (con.b1 == 0) | (con.b2 == 0)
            floor_hit = torch.any(world & (con.dist < con.margin), dim=0)
        qacc = torch.linalg.vector_norm(data.qacc, dim=0)
        terminated = (floor_hit
                      | (xpos[2] - terrain_h < C.TERMINAL_HEIGHT)
                      | (qacc > C.TERMINAL_QACC)
                      | torch.any(torch.isnan(data.qpos), dim=0))
        discount = torch.where(terminated, torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, terminated, discount


def make_vision_flight(device, bumps_or_trench: str = "trench",
                       time_limit: float = 0.4,
                       joint_filter: float = JOINT_FILTER,
                       eye_size: int = 32, dtype=torch.float32) -> FlyEnv:
    """The vision_guided_flight FlyEnv on ``device`` over the "trench" or
    "bumps" terrain. The model is the committed asset; another
    ``joint_filter`` rebuilds it (needs mujoco)."""
    from flybody_tpu_torch.physics import io_mj
    _, trench = terrain(bumps_or_trench)
    mj = (load_model(bumps_or_trench) if joint_filter == JOINT_FILTER
          else export_model(bumps_or_trench, None, joint_filter=joint_filter))
    model = io_mj.put_model(mj, device=device, dtype=dtype, **PUT_MODEL_KW)
    walker = FlyWalker(model, json.loads(str(mj["action_maps_json"])))
    wbpg = WingBeatPatternGenerator(device=model.device)
    task = VisionFlightWBPG(
        walker, wbpg, HFIELD_POS, trench,
        (mj["cam_bodyid"], mj["cam_pos"], mj["cam_quat"]),
        time_limit=time_limit, eye_size=eye_size)
    return FlyEnv(model, task, dtype=dtype)


if __name__ == "__main__":
    for t in MODEL_PATHS:
        export_model(t)
        print("wrote", MODEL_PATHS[t])
