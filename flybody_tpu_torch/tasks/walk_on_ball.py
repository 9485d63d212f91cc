"""Tethered fly walking on a floating ball.

The fly's thorax is fused to the world; a ball with a 3-dof ball joint
floats under its legs. Reward = tolerance(ball_qvel - (0, -5, 0), margin 6,
linear); termination on excessive thorax linear/angular velocity or qacc,
discount 0 on termination.

The model comes from ``models/assets/walk_on_ball_model.npz``: the compiled
MuJoCo model's fields and the walker's action maps, written by
``export_model`` where mujoco is installed (``python -m
flybody_tpu_torch.tasks.walk_on_ball`` rewrites it). Loading needs only
numpy, so the env builds on machines without mujoco.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from flybody_tpu_torch.envs.core import FlyEnv, Task
from flybody_tpu_torch.envs.walker import FlyWalker
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.tasks import constants as C
from flybody_tpu_torch.utils import rewards as rw

MODEL_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "assets", "walk_on_ball_model.npz")

# Engine budgets of the production env (sized in the JAX package under the
# trained gait): tight contact islands, per-class ccd lanes, the fused
# solver's (limit rows, cones), and one contact selection per control step.
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 20},
                    ccd_class_budgets={(False, False): 16,
                                       (False, True): 12,
                                       (True, False): 28,
                                       (True, True): 8},
                    contact_solver="fused", fused_sel=(24, 40),
                    col_refresh=10)

# wob-admm: the same env with the dense ADMM solver and its iterations in
# the CUDA kernel (contact_solver="admm_kernel"). The contact budgets are
# cut to the maxima the JAX package measured under the trained gait
# (penetrating condim-3 max 17; ccd gate-hot maxima 11 / 8 / 22 / 4 by
# class), so the dense system has 32 limit + 8 condim-1 + 3 * 62 cone =
# 226 <= 256 rows, the kernel's limit. At the shipped budgets it has
# 32 + 8 + 3 * 84 = 292 rows and the plain ADMM loop runs instead.
WOB_ADMM_KW = dict(con_sel={1: 8, 3: 17},
                   ccd_class_budgets={(False, False): 11, (False, True): 8,
                                      (True, False): 22, (True, True): 4},
                   contact_solver="admm_kernel")


def ball_arena(ball_pos=(-0.05, 0.0, -0.419), ball_radius=0.454,
               ball_density=0.0025):
    """Arena callback adding the floating ball to an MjSpec."""
    def fn(spec):
        import mujoco
        ball = spec.worldbody.add_body(name="ball", pos=np.asarray(ball_pos))
        ball.add_geom(name="ball", type=mujoco.mjtGeom.mjGEOM_SPHERE,
                      size=[ball_radius, 0, 0], density=ball_density,
                      rgba=[0.3, 0.4, 0.5, 1.0])
        ball.add_joint(name="ball", type=mujoco.mjtJoint.mjJNT_BALL)
    return fn


def build_mj_model(claw_friction: float = 1.0, joint_filter: float = 0.01,
                   adhesion_filter: float = 0.007):
    """Compile the walk_on_ball MjModel (needs mujoco). Returns
    (mj_model, action_maps)."""
    from flybody_tpu_torch.models import fruitfly as ff
    cfg = ff.FlyConfig(
        use_legs=True, use_wings=False, use_mouth=False, use_antennae=False,
        joint_filter=joint_filter, adhesion_filter=adhesion_filter,
        root_joint="none", spawn_pos=(0.0, 0.0, 0.1278),
        physics_timestep=C.WALK_PHYSICS_TIMESTEP,
        control_timestep=C.WALK_CONTROL_TIMESTEP)
    morph = ff.apply_surgery(ff.load_morphology(), cfg)
    for b in morph.bodies:
        for g in b.geoms:
            if g.name.startswith("claw") or "labrum" in g.name:
                if g.gap > 0:  # adhesion-collision class geoms
                    g.friction = np.array([claw_friction, 0.005, 0.0001])
    spec = ff.to_spec(morph, cfg, arena_fn=ball_arena())
    return spec.compile(), ff.action_indices(morph, cfg)


def export_model(path: str = MODEL_PATH, **build_kw) -> dict:
    """Build the model with mujoco and write the mapping ``put_model``
    reads (plus the action maps) to ``path``. Returns the mapping."""
    from flybody_tpu_torch.physics import io_mj
    mj_model, amap = build_mj_model(**build_kw)
    out = io_mj.export_mj(mj_model)
    out["action_maps_json"] = np.asarray(json.dumps(amap, sort_keys=True))
    np.savez_compressed(path, **out)
    return out


def load_model(path: str = MODEL_PATH) -> dict:
    """The committed model mapping (numpy only)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class WalkOnBall(Task):
    ctrl_dt = C.WALK_CONTROL_TIMESTEP
    phys_dt = C.WALK_PHYSICS_TIMESTEP
    deterministic_init = True

    def __init__(self, walker: FlyWalker, time_limit: float = 2.0):
        self.walker = walker
        self.time_limit = time_limit
        self.action_size = walker.action_size
        jid = walker.model.names["joint"]["ball"]
        self.ball_dofadr = int(np.asarray(walker.model.jnt_dofadr)[jid])

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def before_step(self, model: Model, data: Data, task_state, action):
        return self.walker.apply_action(data, action), task_state

    def _ball_qvel(self, data: Data):
        return data.qvel[self.ball_dofadr:self.ball_dofadr + 3].T  # (B, 3)

    def observations(self, model: Model, data: Data, task_state,
                     sensor_mean) -> dict:
        obs = self.walker.observables(model, data, sensor_mean)
        obs["appendages_pos"] = self.walker.appendages_pos(data)
        obs.update(self.walker.force_touch_obs(sensor_mean))
        obs["ball_qvel"] = self._ball_qvel(data)
        return obs

    def reward_term_discount(self, model: Model, data: Data, task_state,
                             sensor_mean):
        target = torch.tensor([0.0, -5.0, 0.0], dtype=data.qpos.dtype,
                              device=data.qpos.device)
        factors = rw.tolerance(self._ball_qvel(data) - target,
                               bounds=(0.0, 0.0), margin=6.0,
                               sigmoid="linear", value_at_margin=0.0)
        reward = torch.prod(factors, dim=1)
        norm = lambda x: torch.linalg.vector_norm(x, dim=1)
        linvel = norm(self.walker.sensor_obs(sensor_mean, "velocimeter"))
        angvel = norm(self.walker.sensor_obs(sensor_mean, "gyro"))
        qacc = torch.linalg.vector_norm(data.qacc, dim=0)
        terminated = ((linvel > C.TERMINAL_LINVEL)
                      | (angvel > C.TERMINAL_ANGVEL)
                      | (qacc > C.TERMINAL_QACC)
                      | torch.any(torch.isnan(data.qpos), dim=0))
        discount = torch.where(terminated, torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, terminated, discount


def make_walk_on_ball(device, dtype=torch.float32,
                      time_limit: float = 2.0, mapping: dict | None = None):
    """The walk_on_ball FlyEnv on ``device`` from the committed model (or
    from ``mapping``, an ``export_model`` result)."""
    from flybody_tpu_torch.physics import io_mj
    mj = load_model() if mapping is None else mapping
    model = io_mj.put_model(mj, device=device, dtype=dtype, **PUT_MODEL_KW)
    amap = json.loads(str(mj["action_maps_json"]))
    task = WalkOnBall(FlyWalker(model, amap), time_limit=time_limit)
    return FlyEnv(model, task, dtype=dtype)


if __name__ == "__main__":
    export_model()
    print("wrote", MODEL_PATH)
