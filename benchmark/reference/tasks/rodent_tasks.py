"""Rodent RL tasks: escape bowl, gaps corridor, maze forage, two-touch.

The reference's observation-normalized rodent tasks (reference
vnl_ray/tasks/rodent_tasks_modified.py:42-459: EscapeSameObs,
RunThroughCorridorSameObs, ManyGoalsMazeSameObs, TwoTouchSamObs, over the
dm_control tasks they subclass), batched over envs. Every stateful
mechanism of the reference (the reward-staleness timers, the two-touch
state machine, the targets' reached flags) is per-env data in the task
state, each leaf with the env axis last.

Every task adds the reference's normalization extras: a ``task_logic``
observation (0, or the two-touch state) and an ``origin`` observation
(the world origin in the torso frame), so specialist policies share one
observation signature (reference rodent_tasks_modified.py:31-39). With
``use_vision`` every task also observes ``egocentric_camera``, (B, 32,
32): a head-mounted camera rendered on the device by the raycaster of
``ops/raycast.py`` (``render_camera``).

Random draws come from the env's generator on its device, in a fixed
order per task, or are given as keywords (the parity tests pass the JAX
package's): ``init_state`` takes ``yaw`` (B,), ``spawn_idx`` (B,) (maze)
and ``target`` (3, B) (two-touch). TwoTouch also draws a new target for
every env in every control step (``step_draws``: the env passes its
generator to ``reward_step``), which it takes where the env respawns its
target, or is given ``new_target`` (3, B).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.envs.core import Task
from benchmark.reference.envs.rodent_walker import RodentWalker
from benchmark.reference.math import quaternions as mq
from benchmark.reference.ops import raycast
from benchmark.reference.physics import types as T
from benchmark.reference.physics.types import Data, Model
from benchmark.reference.utils import rewards as rw

_UPRIGHT_COS = float(np.cos(np.deg2rad(30.0)))
# the egocentric camera: the primitive geoms it sees (the largest, to
# bound the cost per pixel), its range, and its frame in the head's:
# its view axis -z along the head's +x, its up axis +y along the head's +z
CAMERA_GEOMS = 16
CAMERA_MAX_DIST = 4.0
_CAM_FIX = np.array([[0.0, 0.0, -1.0],
                     [-1.0, 0.0, 0.0],
                     [0.0, 1.0, 0.0]])
_LINEAR = dict(sigmoid="linear", value_at_margin=0.0)


def _upright_reward(walker: RodentWalker, data: Data):
    """Linear tolerance on min(torso, pelvis) z-axis cosine: 1 within 30
    degrees of vertical, 0 upside down (dm_control escape._upright_reward),
    (B,)."""
    return rw.tolerance(walker.upright_zz(data),
                        bounds=(_UPRIGHT_COS, float("inf")),
                        margin=1 + _UPRIGHT_COS, **_LINEAR)


def _given_or(given, draw, dev, dtype):
    return draw() if given is None else torch.as_tensor(
        given, device=dev).to(dtype)


class RodentTaskBase(Task):
    ctrl_dt = 0.02
    phys_dt = 0.001
    # reset draws a yaw per env
    deterministic_init = False

    def __init__(self, walker: RodentWalker, time_limit: float,
                 use_vision: bool = False, camera_size: int = 32):
        self.walker = walker
        self.time_limit = time_limit
        self.action_size = walker.action_size
        self.use_vision = use_vision
        self.camera_size = camera_size
        if use_vision:
            self._init_camera(walker.model, camera_size)

    def _init_camera(self, model: Model, size: int) -> None:
        """The head-mounted forward camera (the reference rodent tasks'
        walker/egocentric_camera, dm_control rodent.py), rendered by the
        raycaster over the put model's heightfield, if it has one, and the
        16 largest primitive geoms outside the head (the camera sits in
        the skull)."""
        dev, dtype = model.device, model.dtype
        # float32 rays, as the JAX package's camera_rays default
        self.cam_rays = raycast.camera_rays(90.0, size, size,
                                            device=dev).to(dtype)
        gt = np.asarray(model.geom_type)
        gs = model.geom_size.detach().cpu().numpy()
        gb = np.asarray(model.geom_bodyid)
        prim = np.nonzero((gt != T.GEOM_PLANE) & (gt != T.GEOM_HFIELD)
                          & (gb != self.walker.head_body_id))[0]
        if len(prim):
            # numpy's default sort on the same sizes as the JAX package:
            # the rat's left and right limbs tie
            order = np.argsort(-gs[prim].max(axis=-1))
            prim = prim[order[:CAMERA_GEOMS]]
        self.camera_geoms = prim
        self.scene_cast, has_scene = raycast.make_scene_raycaster(model, prim)
        if not has_scene:
            self.scene_cast = None
        self.height_fn = None
        if model.nhfield:
            hgeom = int(np.nonzero(gt == T.GEOM_HFIELD)[0][0])
            self.height_fn = raycast.hfield_height_fn(
                model.hfield_data[0], model.hfield_size[0],
                model.geom_pos[hgeom].detach().cpu().numpy())
        self.cam_off = torch.tensor([0.035, 0.0, 0.0], device=dev,
                                    dtype=dtype)
        self.cam_fix = torch.as_tensor(_CAM_FIX, device=dev).to(dtype)

    def camera_pose(self, data: Data):
        """World position (B, 3) and rotation (B, 3, 3) of every env's
        camera: 0.035 ahead of the head body along its +x (snout) axis."""
        head = self.walker.head_body_id
        hpos = data.xpos[head].T
        hmat = data.xmat[head].permute(2, 0, 1)
        return (hpos + torch.einsum("bij,j->bi", hmat, self.cam_off),
                hmat @ self.cam_fix)

    def render_camera(self, data: Data, distance: bool = False):
        """(B, H, W) egocentric camera intensity of every env (with
        ``distance``, each pixel's nearest hit distance)."""
        cam_pos, cam_mat = self.camera_pose(data)
        return raycast.render_eye(
            cam_pos, cam_mat, self.cam_rays, self.height_fn,
            max_dist=CAMERA_MAX_DIST, scene_cast=self.scene_cast,
            geom_xpos=data.geom_xpos.permute(2, 0, 1),
            geom_xmat=data.geom_xmat.permute(3, 0, 1, 2), distance=distance)

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def before_step(self, model: Model, data: Data, ts, action):
        return self.walker.apply_action(data, action), ts

    def _draw_yaw(self, data: Data, generator):
        """(B,) yaws uniform in [0, 2 pi) from ``generator``."""
        B, dev, dtype = data.qpos.shape[-1], data.qpos.device, data.qpos.dtype
        # frozen copy: drawn in float32 and cast, so that a float64
        # reference reads the draws of a float32 run of the same generator
        return 2 * np.pi * torch.rand((B,), generator=generator, device=dev,
                                      dtype=torch.float32).to(dtype)

    def _spawn(self, data: Data, xy, yaw=None) -> Data:
        """The root at ``xy`` ((2,) or (2, B)), turned by ``yaw`` (B,)
        about z where given; its height stays the model's (collision-free
        by construction)."""
        adr = self.walker.root_qposadr
        qpos = data.qpos.clone()
        for i in range(2):
            qpos[adr + i] = xy[i]
        if yaw is not None:
            z = torch.zeros_like(yaw)
            qpos[adr + 3:adr + 7] = torch.stack(
                [torch.cos(yaw / 2), z, z, torch.sin(yaw / 2)]).to(qpos.dtype)
        return data.replace(qpos=qpos)

    def _base_obs(self, model, data, sensor_mean) -> dict:
        obs = self.walker.observables(model, data, sensor_mean)
        obs["origin"] = self.walker.origin_obs(data)
        obs["task_logic"] = data.qpos.new_zeros((data.qpos.shape[-1], 1))
        if self.use_vision:
            obs["egocentric_camera"] = self.render_camera(data)
        return obs

    def observations(self, model, data, ts, sensor_mean) -> dict:
        return self._base_obs(model, data, sensor_mean)

    def reward_factors(self, model, data, ts, sensor_mean) -> dict:
        """The scalar reward as the one channel (a drawing task keeps its
        targets: no draw)."""
        keep = {"new_target": ts["target"]} if self.step_draws else {}
        return {"reward": self.reward_step(model, data, ts, sensor_mean,
                                           **keep)[0]}

    def _fatal(self, data: Data):
        return ((torch.linalg.vector_norm(data.qacc, dim=0) > 1e14)
                | torch.any(torch.isnan(data.qpos), dim=0))

    @staticmethod
    def _stale_timer(ts, stale):
        return torch.where(stale, ts["timer"] + 1,
                           torch.zeros_like(ts["timer"]))


class EscapeBowl(RodentTaskBase):
    """Escape a bowl-shaped terrain (reference EscapeSameObs,
    rodent_tasks_modified.py:42-158).

    reward = upright * (escape / 2 + vel / 2 / 6) + aliveness + escape_vel,
    with a reward-staleness failure timer (300 stale control steps)."""

    def __init__(self, walker: RodentWalker, terrain_size: float = 20.0,
                 target_velocity: float = 2.0, aliveness_reward: float = 0.1,
                 reward_termination: bool = True,
                 reward_threshold: float = 0.1, reward_margin: float = 0.01,
                 reward_stale_timestep: int = 300, time_limit: float = 20.0,
                 **base_kwargs):
        super().__init__(walker, time_limit, **base_kwargs)
        self.terrain_size = terrain_size
        self.vel = target_velocity
        self.aliveness_reward = aliveness_reward
        self.reward_termination = reward_termination
        self.reward_threshold = reward_threshold
        self.reward_margin = reward_margin
        self.reward_stale = reward_stale_timestep

    def init_state(self, model: Model, data: Data, generator, yaw=None):
        dev, dtype = data.qpos.device, data.qpos.dtype
        yaw = _given_or(yaw, lambda: self._draw_yaw(data, generator), dev,
                        dtype)
        data = self._spawn(data, (0.0, 0.0), yaw)
        B = data.qpos.shape[-1]
        zero = data.qpos.new_zeros((B,))
        ts = dict(prev_escape=zero, prev_reward=zero.clone(),
                  timer=torch.full((B,), -1, dtype=torch.int32, device=dev))
        return data, ts

    def reward_step(self, model, data, ts, sensor_mean):
        w = self.walker
        escape = rw.tolerance(torch.linalg.vector_norm(w.head_pos(data),
                                                       dim=1),
                              bounds=(self.terrain_size, float("inf")),
                              margin=self.terrain_size, **_LINEAR)
        upright = _upright_reward(w, data)
        v = w.subtree_linvel(sensor_mean)
        vel = rw.tolerance(torch.sqrt(v[:, 0] ** 2 + v[:, 1] ** 2),
                           bounds=(self.vel, self.vel), margin=self.vel,
                           **_LINEAR)
        escape_vel = (escape - ts["prev_escape"]) / self.ctrl_dt / 5.0
        reward = (upright * (escape / 2 + vel / 2 / 6)
                  + self.aliveness_reward + escape_vel)
        stale = (reward < self.reward_threshold) | (
            torch.abs(reward - ts["prev_reward"]) < self.reward_margin)
        timer = self._stale_timer(ts, stale)
        terminated = self._fatal(data)
        if self.reward_termination:
            terminated = terminated | (timer >= self.reward_stale)
        ts = dict(ts, prev_escape=escape, prev_reward=reward, timer=timer)
        # the reference's Escape discount is 1 even on a failure
        return reward, terminated, torch.ones_like(reward), ts


class RunThroughCorridor(RodentTaskBase):
    """Run down a gapped corridor at a target velocity (reference
    RunThroughCorridorSameObs, rodent_tasks_modified.py:161-266).

    reward = tolerance(x velocity; target, linear) * upright; termination
    when a torso, pelvis or cervical geom touches the ground or an end
    effector falls below ``terminate_at_height``."""

    # the reference's walker_spawn_rotation=0: every reset faces +x from
    # the same spawn, so auto-reset builds one fresh state and broadcasts
    deterministic_init = True

    def __init__(self, walker: RodentWalker, spawn_position=(5.0, 0.0),
                 target_velocity: float = 1.0,
                 contact_termination: bool = True,
                 terminate_at_height: float = -0.3,
                 reward_termination: bool = False,
                 reward_threshold: float = 0.5,
                 reward_stale_timestep: int = 150,
                 time_limit: float = 30.0, **base_kwargs):
        super().__init__(walker, time_limit, **base_kwargs)
        self.spawn_position = spawn_position
        self.vel = target_velocity
        self.contact_termination = contact_termination
        self.terminate_at_height = terminate_at_height
        self.reward_termination = reward_termination
        self.reward_threshold = reward_threshold
        self.reward_stale = reward_stale_timestep

    def init_state(self, model: Model, data: Data, generator):
        data = self._spawn(data, self.spawn_position)
        B = data.qpos.shape[-1]
        return data, dict(timer=torch.full((B,), -1, dtype=torch.int32,
                                           device=data.qpos.device))

    def reward_step(self, model, data, ts, sensor_mean):
        w = self.walker
        xvel = w.subtree_linvel(sensor_mean)[:, 0]
        xterm = rw.tolerance(xvel, bounds=(self.vel, self.vel),
                             margin=self.vel, **_LINEAR)
        reward = xterm * _upright_reward(w, data)
        fail = self._fatal(data)
        if self.contact_termination and len(w.nonfoot_geoms):
            fail = fail | (w.contact_flag(model, data, w.nonfoot_geoms,
                                          w.ground_geoms) > 0)
        if self.terminate_at_height is not None:
            # dm_control checks the end effectors' body heights
            if len(w.end_effector_bodies):
                feet_z = data.xpos[model.ix(w.end_effector_bodies), 2]
            else:
                feet_z = data.site_xpos[model.ix(w.end_effector_sites), 2]
            fail = fail | torch.any(feet_z < self.terminate_at_height, dim=0)
        timer = self._stale_timer(ts, reward < self.reward_threshold)
        if self.reward_termination:
            fail = fail | (timer >= self.reward_stale)
        discount = torch.where(fail, torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, fail, discount, dict(ts, timer=timer)


class ManyGoalsMaze(RodentTaskBase):
    """Collect every target in a maze (reference ManyGoalsMazeSameObs,
    rodent_tasks_modified.py:275-372).

    reward = aliveness + target_reward_scale per newly reached target;
    once every target is reached the flags clear (dm_control respawn).
    Failure when aliveness falls under its threshold (discount 0) or the
    reward stays stale for 300 control steps."""

    def __init__(self, walker: RodentWalker, spawn_positions,
                 target_positions, target_reward_scale: float = 50.0,
                 target_radius: float = 0.05,
                 target_height: float = 0.125,
                 aliveness_reward: float = 0.1,
                 aliveness_threshold: float = -0.5,
                 reward_termination: bool = True,
                 reward_threshold: float = 0.0,
                 reward_margin: float = 0.01,
                 reward_stale_timestep: int = 300,
                 time_limit: float = 30.0, **base_kwargs):
        super().__init__(walker, time_limit, **base_kwargs)
        self.spawn_positions = np.asarray(spawn_positions, np.float32)
        self.target_positions = np.asarray(target_positions, np.float32)
        self.target_reward_scale = target_reward_scale
        self.target_radius = target_radius
        self.target_height = target_height
        self.aliveness_reward = aliveness_reward
        self.aliveness_threshold = aliveness_threshold
        self.reward_termination = reward_termination
        self.reward_threshold = reward_threshold
        self.reward_margin = reward_margin
        self.reward_stale = reward_stale_timestep

    def init_state(self, model: Model, data: Data, generator, spawn_idx=None,
                   yaw=None):
        """A spawn cell per env, then its yaw, drawn in that order."""
        B, dev, dtype = data.qpos.shape[-1], data.qpos.device, data.qpos.dtype
        spawn_idx = _given_or(spawn_idx, lambda: torch.randint(
            len(self.spawn_positions), (B,), generator=generator,
            device=dev), dev, torch.int64)
        yaw = _given_or(yaw, lambda: self._draw_yaw(data, generator), dev,
                        dtype)
        xy = model.const(self.spawn_positions, torch.float32)[spawn_idx].T
        data = self._spawn(data, xy, yaw)
        G = len(self.target_positions)
        ts = dict(rewarded=torch.zeros((G, B), dtype=torch.bool, device=dev),
                  prev_reward=data.qpos.new_zeros((B,)),
                  timer=torch.full((B,), -1, dtype=torch.int32, device=dev))
        return data, ts

    def reward_step(self, model, data, ts, sensor_mean):
        w = self.walker
        head = w.head_pos(data)                                  # (B, 3)
        tpos = model.const(self.target_positions,
                           torch.float32).to(head.dtype)
        centers = torch.cat([tpos, torch.full_like(tpos[:, :1],
                                                   self.target_height)], 1)
        near = torch.linalg.vector_norm(centers[:, None] - head[None],
                                        dim=-1) < (self.target_radius + 0.06)
        fresh = near & ~ts["rewarded"]                           # (G, B)
        reward = (self.aliveness_reward + self.target_reward_scale
                  * torch.sum(fresh, dim=0).to(head.dtype))
        rewarded = ts["rewarded"] | near
        # every target reached: the targets respawn (the flags clear)
        rewarded = rewarded & ~torch.all(rewarded, dim=0)
        stale = (reward < self.reward_threshold) | (
            torch.abs(reward - ts["prev_reward"]) < self.reward_margin)
        timer = self._stale_timer(ts, stale)
        dead = w.aliveness(data) < self.aliveness_threshold
        terminated = dead | self._fatal(data)
        if self.reward_termination:
            terminated = terminated | (timer >= self.reward_stale)
        discount = torch.where(dead, torch.zeros_like(reward),
                               torch.ones_like(reward))
        ts = dict(ts, rewarded=rewarded, prev_reward=reward, timer=timer)
        return reward, terminated, discount, ts


# Two-touch state machine codes (dm_control reach.TwoTouchState)
PRE_TOUCH, TOUCHED_ONCE, TOUCHED_TWICE, TOUCHED_TOO_SOON, NO_SECOND_TOUCH \
    = 0, 1, 2, 3, 4


class TwoTouch(RodentTaskBase):
    """Tap an orb, wait ``touch_interval``, tap it again (reference
    TwoTouchSamObs, rodent_tasks_modified.py:375-459, over dm_control
    reach.TwoTouch).

    The state machine is per-env data: the state, the touch times, the
    timeout flag; touches are rising edges of hand-orb proximity."""

    # reward_step takes the env's generator: a new target per env per step
    step_draws = True

    def __init__(self, walker: RodentWalker, target_area=(1.5, 1.5),
                 target_type_reward: float = 25.0,
                 z_height: float = 0.14, target_radius: float = 0.025,
                 touch_interval: float = 0.8,
                 interval_tolerance: float = 0.1,
                 failure_timeout: float = 1.2, reset_delay: float = 0.0,
                 aliveness_reward: float = 0.1,
                 reward_termination: bool = True,
                 reward_threshold: float = 1.0,
                 reward_stale_timestep: int = 300,
                 time_limit: float = 30.0, **base_kwargs):
        super().__init__(walker, time_limit, **base_kwargs)
        self.target_area = target_area
        self.target_reward = target_type_reward
        self.z_height = z_height
        self.target_radius = target_radius
        self.touch_interval = touch_interval
        self.interval_tolerance = interval_tolerance
        self.failure_timeout = failure_timeout
        self.reset_delay = reset_delay
        self.aliveness_reward = aliveness_reward
        self.reward_termination = reward_termination
        self.reward_threshold = reward_threshold
        self.reward_stale = reward_stale_timestep

    def _sample_target(self, generator, B, dev, dtype):
        """(3, B) targets: xy uniform over +-target_area, at z_height."""
        # frozen copy: drawn in float32 and cast (see _draw_yaw)
        u = 2 * torch.rand((2, B), generator=generator, device=dev,
                           dtype=torch.float32).to(dtype) - 1
        return torch.stack([u[0] * self.target_area[0],
                            u[1] * self.target_area[1],
                            torch.full_like(u[0], self.z_height)])

    def init_state(self, model: Model, data: Data, generator, target=None,
                   yaw=None):
        """A target per env, then its yaw, drawn in that order."""
        B, dev, dtype = data.qpos.shape[-1], data.qpos.device, data.qpos.dtype
        target = _given_or(target, lambda: self._sample_target(
            generator, B, dev, dtype), dev, dtype)
        yaw = _given_or(yaw, lambda: self._draw_yaw(data, generator), dev,
                        dtype)
        data = self._spawn(data, (0.0, 0.0), yaw)
        zero = data.qpos.new_zeros((B,))
        no = torch.zeros((B,), dtype=torch.bool, device=dev)
        ts = dict(target=target,
                  state=torch.full((B,), PRE_TOUCH, dtype=torch.int32,
                                   device=dev),
                  first_t=zero, second_t=zero.clone(), touching_prev=no,
                  do_time_out=no.clone(),
                  timer=torch.full((B,), -1, dtype=torch.int32, device=dev))
        return data, ts

    def observations(self, model, data, ts, sensor_mean):
        obs = self._base_obs(model, data, sensor_mean)
        obs["task_logic"] = ts["state"].to(data.qpos.dtype)[:, None]
        # the target in the torso frame (stands in for the orb's pixels of
        # the reference's egocentric camera)
        r = self.walker.root_body_id
        rel = (ts["target"] - data.xpos[r]).T
        obs["target_pos"] = mq.rotate_vec_with_quat(
            rel, mq.conj_quat(data.xquat[r].T))
        return obs

    def reward_step(self, model, data, ts, sensor_mean, generator=None,
                    new_target=None):
        """``new_target`` (3, B), else drawn from ``generator`` for every
        env, is where a respawning env's target goes."""
        w = self.walker
        t = data.time
        target = ts["target"]
        lhand = data.xpos[w.lhand_body]                          # (3, B)
        rhand = data.xpos[w.rhand_body]
        lrew = torch.exp(-3.0 * torch.sum(torch.abs(lhand - target), dim=0))
        rrew = torch.exp(-3.0 * torch.sum(torch.abs(rhand - target), dim=0))
        reward = (self.aliveness_reward
                  + 0.01 * torch.maximum(lrew, rrew) * self.target_reward)

        touch_d = torch.minimum(
            torch.linalg.vector_norm(lhand - target, dim=0),
            torch.linalg.vector_norm(rhand - target, dim=0))
        touching = touch_d < (self.target_radius + 0.015)
        touch_event = touching & ~ts["touching_prev"]
        state = ts["state"]
        code = lambda c: torch.full_like(state, c)
        zero = torch.zeros_like(reward)

        # PRE_TOUCH -> TOUCHED_ONCE on the first touch (rewarded)
        first = (state == PRE_TOUCH) & touch_event
        reward = reward + torch.where(first, zero + self.target_reward, zero)
        first_t = torch.where(first, t, ts["first_t"])
        state = torch.where(first, code(TOUCHED_ONCE), state)

        # TOUCHED_ONCE: a second touch, in time or too soon
        second = (state == TOUCHED_ONCE) & touch_event & ~first
        dt2 = t - first_t
        too_soon = dt2 < (self.touch_interval - self.interval_tolerance)
        in_time = dt2 <= (self.touch_interval + self.interval_tolerance)
        reward = reward + torch.where(second & ~too_soon & in_time,
                                      zero + self.target_reward, zero)
        second_t = torch.where(second, t, ts["second_t"])
        state = torch.where(second, torch.where(
            too_soon, code(TOUCHED_TOO_SOON), code(TOUCHED_TWICE)), state)
        do_time_out = ts["do_time_out"] | (second & too_soon)
        # or no second touch within the window
        late = (state == TOUCHED_ONCE) & ~second & (
            (t - first_t) > (self.touch_interval + self.interval_tolerance))
        state = torch.where(late, code(NO_SECOND_TOUCH), state)
        second_t = torch.where(late, t, second_t)
        do_time_out = do_time_out | late

        # the final phases wait out the timeout, then a new target
        in_final = ((state == TOUCHED_TWICE) | (state == TOUCHED_TOO_SOON)
                    | (state == NO_SECOND_TOUCH))
        timeout_over = do_time_out & (t > second_t + self.failure_timeout)
        do_time_out = do_time_out & ~timeout_over
        respawn = (in_final & ~do_time_out
                   & (t > second_t + self.reset_delay) & ~timeout_over)
        if new_target is None:
            new_target = self._sample_target(generator, t.shape[0], t.device,
                                             t.dtype)
        target = torch.where(respawn, new_target.to(t.dtype), target)
        state = torch.where(respawn, code(PRE_TOUCH), state)

        timer = self._stale_timer(ts, reward < self.reward_threshold)
        terminated = self._fatal(data)
        if self.reward_termination:
            terminated = terminated | (timer >= self.reward_stale)
        ts = dict(target=target, state=state, first_t=first_t,
                  second_t=second_t, touching_prev=touching,
                  do_time_out=do_time_out, timer=timer)
        return reward, terminated, torch.ones_like(reward), ts
