"""No-op walking task for testing and experimentation, and the flat floor
arena of the walking tasks.

The free fly (legs on, wings off) stands on a floor; the reward is 1 and
only a blown-up state (qacc over ``TERMINAL_QACC`` or NaN) terminates. An
optional ``action_corruptor`` maps each action batch before it reaches
the walker. The model uses ``put_model``'s default budgets (contact solver
"apgd", one contact selection per substep), so its step runs no hand
kernel.

The model comes from ``models/assets/template_task_model.npz``, written by
``export_model`` where mujoco is installed (``python -m
flybody_tpu_torch.tasks.template_task`` rewrites it). Loading needs only
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

MODEL_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "assets", "template_task_model.npz")

# spawn height above the floor (reference fruitfly.py _SPAWN_POS)
SPAWN_Z = 0.1278


def floor_arena(size=(50.0, 50.0), friction=0.5,
                solref=(0.001, 1.0), solimp=(0.95, 0.99, 0.01)):
    """Arena callback adding a flat floor plane to an MjSpec, with the
    walking tasks' contact parameters. mujoco is imported when the
    callback runs (model export only)."""
    def fn(spec):
        import mujoco
        spec.worldbody.add_geom(
            name="floor", type=mujoco.mjtGeom.mjGEOM_PLANE,
            size=[size[0], size[1], 0.1],
            friction=[friction, 0.005, 0.0001],
            solref=list(solref), solimp=list(solimp) + [0.5, 2.0],
            condim=3)
    return fn


def build_mj_model():
    """Compile the template task's MjModel (needs mujoco). Returns
    (mj_model, action_maps)."""
    from flybody_tpu_torch.models import fruitfly as ff
    cfg = ff.FlyConfig(use_legs=True, use_wings=False, root_joint="free",
                       physics_timestep=C.WALK_PHYSICS_TIMESTEP,
                       control_timestep=C.WALK_CONTROL_TIMESTEP)
    morph = ff.apply_surgery(ff.load_morphology(), cfg)
    spec = ff.to_spec(morph, cfg, arena_fn=floor_arena())
    return spec.compile(), ff.action_indices(morph, cfg)


def export_model(path: str = MODEL_PATH) -> dict:
    """Build the model with mujoco and write the mapping ``put_model``
    reads (plus the action maps) to ``path``. Returns the mapping."""
    from flybody_tpu_torch.physics import io_mj
    mj_model, amap = build_mj_model()
    out = io_mj.export_mj(mj_model)
    out["action_maps_json"] = np.asarray(json.dumps(amap, sort_keys=True))
    np.savez_compressed(path, **out)
    return out


def load_model(path: str = MODEL_PATH) -> dict:
    """The committed model mapping (numpy only)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class TemplateTask(Task):
    """Constant-reward walking task with an optional action corruptor."""

    ctrl_dt = C.WALK_CONTROL_TIMESTEP
    phys_dt = C.WALK_PHYSICS_TIMESTEP
    # the initial state ignores the generator: auto-reset builds one
    # fresh state and broadcasts it
    deterministic_init = True

    def __init__(self, walker: FlyWalker, time_limit: float = 1.0,
                 action_corruptor=None):
        self.walker = walker
        self.time_limit = time_limit
        self.action_size = walker.action_size
        self.action_corruptor = action_corruptor

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def init_state(self, model: Model, data: Data, generator):
        qpos = data.qpos.clone()
        qpos[int(np.asarray(model.jnt_qposadr)[0]) + 2] += SPAWN_Z
        return data.replace(qpos=qpos), ()

    def before_step(self, model: Model, data: Data, task_state, action):
        if self.action_corruptor is not None:
            action = self.action_corruptor(action)
        return self.walker.apply_action(data, action), task_state

    def observations(self, model: Model, data: Data, task_state,
                     sensor_mean) -> dict:
        obs = self.walker.observables(model, data, sensor_mean)
        obs["appendages_pos"] = self.walker.appendages_pos(data)
        obs.update(self.walker.force_touch_obs(sensor_mean))
        return obs

    def reward_term_discount(self, model: Model, data: Data, task_state,
                             sensor_mean):
        B = data.qpos.shape[-1]
        reward = data.qpos.new_ones((B,))
        qacc = torch.linalg.vector_norm(data.qacc, dim=0)
        terminated = ((qacc > C.TERMINAL_QACC)
                      | torch.any(torch.isnan(data.qpos), dim=0))
        discount = torch.where(terminated, torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, terminated, discount


def make_template_task(device, dtype=torch.float32, time_limit: float = 1.0,
                       action_corruptor=None) -> FlyEnv:
    """The template task's FlyEnv on ``device`` from the committed model."""
    from flybody_tpu_torch.physics import io_mj
    mj = load_model()
    model = io_mj.put_model(mj, device=device, dtype=dtype)
    walker = FlyWalker(model, json.loads(str(mj["action_maps_json"])))
    task = TemplateTask(walker, time_limit=time_limit,
                        action_corruptor=action_corruptor)
    return FlyEnv(model, task, dtype=dtype)


if __name__ == "__main__":
    export_model()
    print("wrote", MODEL_PATH)
