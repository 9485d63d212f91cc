"""Vision-guided flight over the sine trench.

The winged fly, driven by the wing-beat pattern generator (WBPG), flies
over the trench heightfield at a target height and speed (reference
vnl_ray/tasks/vision_flight.py). Its two 32x32 eyes are rendered every
control step by the plain raycaster of ``ops/raycast.py``: a march of the
terrain and closed-form hits against the model's largest primitive geoms,
less the geoms that contain the eye. The reward is the product of
height-over-terrain, x-speed, speed, side-speed, body-axis and
trench-centre tolerance factors (reference :155-214); any active contact
of the world body, flying too low, an exploding qacc or a NaN state ends
the episode with discount 0.

The model is the committed ``models/assets/vision_flight_trench_model.npz``,
which carries the cameras' bodies and poses; loading needs only numpy.
Random draws are made in float32 and cast, so that a float64 reference
reads the draws of a float32 run of the same generator.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from benchmark.reference.envs.core import FlyEnv, Task
from benchmark.reference.envs.walker import FlyWalker
from benchmark.reference.math import quaternions as mq
from benchmark.reference.ops import raycast
from benchmark.reference.physics import types as T
from benchmark.reference.physics.types import Data, Model
from benchmark.reference.tasks import arenas
from benchmark.reference.tasks import constants as C
from benchmark.reference.tasks.pattern_generators import (
    WBPGState, WingBeatPatternGenerator)
from benchmark.reference.utils import rewards as rwu

MODEL_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "assets",
                          "vision_flight_trench_model.npz")

HFIELD_POS = (8.0, 0.0, 0.0)

# Engine budgets of the env: condim-1 self-contact sensing (8), 16
# analytic condim-3 contacts, 32 convex lanes, the fused solver's (limit
# rows, cones) and one contact selection per control step (4 substeps).
# The fused solve has 8 + 8 + 3 x 24 = 88 rows.
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 16}, ccd_budget=32,
                    contact_solver="fused", fused_sel=(8, 24),
                    col_refresh=4)

_WING_JOINTS = [f"wing_{axis}_{side}" for side in ("left", "right")
                for axis in ("yaw", "roll", "pitch")]
EYE_FOVY = 150.0
# the largest primitive geoms of the model, the eyes' scene
EYE_GEOMS = 16
MARCH_SAMPLES = 48
# the dtype of the draws: the configuration's
DRAW_DTYPE = torch.float32


@dataclasses.dataclass
class VisionFlightState:
    wbpg: WBPGState
    target_height: torch.Tensor  # (B,)
    target_speed: torch.Tensor   # (B,)


def load_model(path: str = MODEL_PATH) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def camera_rotation(quat) -> np.ndarray:
    """A camera's unit quaternion (4,) -> its float32 3x3 rotation, each
    a b + c d formed as one rounding of a b + (c d rounded), as the
    program's cameras are."""
    w, x, y, z = np.asarray(quat, np.float32)

    def s(a, b, c, d, sign=1.0):
        return np.float32(np.float64(a) * np.float64(b)
                          + sign * np.float64(np.float32(c * d)))

    return np.array([
        [1 - 2 * s(y, y, z, z), 2 * s(x, y, w, z, -1), 2 * s(x, z, w, y)],
        [2 * s(x, y, w, z), 1 - 2 * s(x, x, z, z), 2 * s(y, z, w, x, -1)],
        [2 * s(x, z, w, y, -1), 2 * s(y, z, w, x), 1 - 2 * s(x, x, y, y)],
    ], np.float32)


def _inside(geom_type: int, size: torch.Tensor, p: torch.Tensor) -> bool:
    """Whether ``p`` (3,), in a geom's frame, is inside the geom's shape
    as the raycaster sees it: a cylinder is cast as a capsule."""
    if geom_type == T.GEOM_SPHERE:
        return bool(torch.linalg.vector_norm(p) < size[0])
    if geom_type == T.GEOM_ELLIPSOID:
        return bool(torch.linalg.vector_norm(p / size) < 1.0)
    if geom_type in (T.GEOM_CAPSULE, T.GEOM_CYLINDER):
        nearest = torch.stack([p.new_zeros(()), p.new_zeros(()),
                               torch.clamp(p[2], -size[1], size[1])])
        return bool(torch.linalg.vector_norm(p - nearest) < size[0])
    if geom_type == T.GEOM_BOX:
        return bool((p.abs() < size).all())
    return False


def visible_geoms(model: Model, scene, body: int, eye_pos) -> list:
    """The geoms of ``scene`` an eye at ``eye_pos`` in body ``body``'s
    frame sees from outside: every geom of another body, and each geom of
    its own body that does not contain it (both fixed in that frame)."""
    gt = np.asarray(model.geom_type)
    gb = np.asarray(model.geom_bodyid)
    eye = torch.as_tensor(np.asarray(eye_pos), dtype=torch.float64)
    keep = []
    for g in scene:
        if gb[g] == body:
            q = model.geom_quat[g].detach().cpu().double()
            rel = eye - model.geom_pos[g].detach().cpu().double()
            local = mq.rotate_vec_with_quat(rel, mq.conj_quat(q))
            if _inside(int(gt[g]), model.geom_size[g].detach().cpu()
                       .double(), local):
                continue
        keep.append(int(g))
    return keep


class VisionFlightWBPG(Task):
    ctrl_dt = C.FLY_CONTROL_TIMESTEP
    phys_dt = C.FLY_PHYSICS_TIMESTEP
    deterministic_init = False

    def __init__(self, walker: FlyWalker, wbpg: WingBeatPatternGenerator,
                 trench: arenas.TrenchSpecs, cam_pose,
                 time_limit: float = 0.4, target_height_range=(0.4, 0.6),
                 target_speed_range=(20.0, 40.0),
                 init_pos_x_range=(-1.0, -0.5),
                 init_pos_y_range=(-0.2, 0.2), eye_size: int = 32):
        self.walker = walker
        self.wbpg = wbpg
        self.time_limit = time_limit
        self.action_size = walker.action_size
        self.target_height_range = target_height_range
        self.target_speed_range = target_speed_range
        self.init_pos_x_range = init_pos_x_range
        self.init_pos_y_range = init_pos_y_range
        model = walker.model
        dev, dtype = model.device, model.dtype
        names = model.names
        hfield_pos = np.asarray(HFIELD_POS, np.float32)
        wing_ids = np.array([names["joint"][n] for n in _WING_JOINTS])
        self.wing_qposadr = np.asarray(model.jnt_qposadr)[wing_ids]
        self.wing_dofadr = np.asarray(model.jnt_dofadr)[wing_ids]
        amap = walker.action_maps
        self.wing_action_idx = np.asarray(amap["action"]["wings"], np.int64)
        self.user_action_idx = int(amap["action"]["user"][0])
        self.root_qposadr = int(np.asarray(model.jnt_qposadr)[0])
        self.rel_range = float(wbpg.beat_freqs[-1] / wbpg.base_beat_freq
                               - 1.0)
        # the scene: the largest primitive geoms
        gt = np.asarray(model.geom_type)
        gs = model.geom_size.detach().cpu().numpy()
        prim = np.nonzero((gt != T.GEOM_PLANE) & (gt != T.GEOM_HFIELD))[0]
        prim = prim[np.argsort(-gs[prim].max(axis=-1))[:EYE_GEOMS]]
        self.scene_geoms = [int(g) for g in prim]
        # each eye: key, body, offset, float32 rotation, and what it casts
        bodyid, pos, quat = cam_pose
        self.eyes = []
        for key, cam in (("left_eye", "eye_left"), ("right_eye", "eye_right")):
            c = names["camera"][cam]
            geoms = visible_geoms(model, self.scene_geoms, int(bodyid[c]),
                                  pos[c])
            self.eyes.append(dict(
                key=key, body=int(bodyid[c]), geoms=geoms,
                cast=raycast.make_scene_raycaster(model, geoms)[0],
                pos=torch.as_tensor(np.asarray(pos[c], np.float32),
                                    device=dev).to(dtype),
                mat=torch.as_tensor(camera_rotation(quat[c]),
                                    device=dev).to(dtype)))
        theta = np.deg2rad(C.BODY_PITCH_ANGLE)
        self.target_zaxis = torch.as_tensor(
            np.array([np.sin(theta), 0.0, np.cos(theta)], np.float32),
            device=dev).to(dtype)
        self.rays = raycast.camera_rays(EYE_FOVY, eye_size, eye_size,
                                        device=dev).to(dtype)
        self.init_quat = torch.as_tensor(np.array(
            [np.cos(-theta / 2), 0.0, np.sin(-theta / 2), 0.0], np.float32),
            device=dev).to(dtype)
        self.height_fn = raycast.hfield_height_fn(
            model.hfield_data[0], model.hfield_size[0], hfield_pos)
        self.trench_xs = torch.as_tensor(np.linspace(
            hfield_pos[0] - 12.0, hfield_pos[0] + 12.0,
            len(trench.center_y)).astype(np.float32), device=dev)
        self.trench_cy = (torch.as_tensor(trench.center_y, device=dev)
                          * 3.0 + float(hfield_pos[1]))

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def init_state(self, model: Model, data: Data, generator):
        """Target height, target speed, x0, y0 and the wing-beat phase,
        drawn per env in that order; level flight at the target height
        over the terrain, at the target speed along x."""
        B = data.qpos.shape[-1]
        dev, dtype = data.qpos.device, data.qpos.dtype

        def draw(lo, hi):
            u = torch.rand((B,), generator=generator, device=dev,
                           dtype=DRAW_DTYPE)
            return (lo + (hi - lo) * u).to(dtype)

        th = draw(*self.target_height_range)
        tv = draw(*self.target_speed_range)
        x0 = draw(*self.init_pos_x_range)
        y0 = draw(*self.init_pos_y_range)
        phase = draw(0.0, 1.0)
        z0 = self.height_fn(x0, y0) + th
        angles, wing_qvel, wbpg_state = self.wbpg.reset(phase)
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
        target, wbpg_state = self.wbpg.step(
            ts.wbpg, self.wbpg.base_beat_freq * (1.0 + self.rel_range * act))
        wing = model.ix(self.wing_action_idx)
        wing_qpos = data.qpos[model.ix(self.wing_qposadr)].T
        action = action.clone()
        action[:, wing] = action[:, wing] + (target - wing_qpos)
        data = self.walker.apply_action(data, action)
        return data, dataclasses.replace(ts, wbpg=wbpg_state)

    def render_eyes(self, data: Data) -> dict:
        """{eye key: (B, H, W) intensity in [0, 255]}."""
        gx = data.geom_xpos.permute(2, 0, 1)
        gm = data.geom_xmat.permute(3, 0, 1, 2)
        out = {}
        for e in self.eyes:
            base_pos = data.xpos[e["body"]].T
            base_mat = data.xmat[e["body"]].permute(2, 0, 1)
            cam_pos = base_pos + torch.einsum("bij,j->bi", base_mat,
                                              e["pos"])
            out[e["key"]] = raycast.render_eye(
                cam_pos, base_mat @ e["mat"], self.rays, self.height_fn,
                n_steps=MARCH_SAMPLES, scene_cast=e["cast"],
                geom_xpos=gx, geom_xmat=gm)
        return out

    def observations(self, model: Model, data: Data, ts: VisionFlightState,
                     sensor_mean) -> dict:
        w = self.walker
        obs = w.observables(model, data, sensor_mean)
        obs["world_zaxis_hover"] = w.world_zaxis_hover(model, data)
        obs["task_input"] = torch.stack([ts.target_height, ts.target_speed],
                                        dim=1)
        obs["joints_pos"] = data.qpos[model.ix(self.wing_qposadr)].T
        obs["joints_vel"] = data.qvel[model.ix(self.wing_dofadr)].T
        obs.update(self.render_eyes(data))
        return obs

    def reward_term_discount(self, model: Model, data: Data,
                             ts: VisionFlightState, sensor_mean):
        a = self.root_qposadr
        dtype = data.qpos.dtype
        xpos = data.qpos[a:a + 3]
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
        zaxis = data.xmat[self.walker.thorax_id, 2]
        angle = torch.arccos(torch.clamp(
            torch.sum(self.target_zaxis[:, None] * zaxis, dim=0), -1.0, 1.0))
        world_zaxis = rwu.tolerance(angle, bounds=(0.0, 0.0), margin=np.pi,
                                    **lin)
        idx = torch.argmin(torch.abs(self.trench_xs[:, None]
                                     - xpos[0][None]), dim=0)
        cy = self.trench_cy[idx].to(dtype)
        trench = rwu.tolerance(xpos[1], bounds=(cy, cy), margin=0.15, **lin)
        reward = height * x_speed * speed * side_speed * world_zaxis * trench

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


def make_vision_flight(device, dtype=torch.float64,
                       time_limit: float = 0.4) -> FlyEnv:
    """The vision_guided_flight FlyEnv over the trench on ``device`` from
    the committed model, in ``dtype``."""
    from benchmark.reference.physics import io_mj
    mj = load_model()
    model = io_mj.put_model(mj, device=device, dtype=dtype, **PUT_MODEL_KW)
    walker = FlyWalker(model, json.loads(str(mj["action_maps_json"])))
    wbpg = WingBeatPatternGenerator(device=model.device)
    _, trench = arenas.sine_trench()
    task = VisionFlightWBPG(
        walker, wbpg, trench,
        (mj["cam_bodyid"], mj["cam_pos"], mj["cam_quat"]),
        time_limit=time_limit)
    return FlyEnv(model, task, dtype=dtype)
