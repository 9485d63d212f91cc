"""Walking imitation: DeepMimic-style tracking of reference trajectories
by the free fly on a flat floor.

Each env tracks one snippet of a padded reference dataset, chosen by a
tensor index drawn per env at reset (no model rebuild). The tracked pose
feeds the ``ref_displacement`` / ``ref_root_quat`` observables with
``future_steps`` frames of preview; the reward is the product of the
DeepMimic factors with weights (20, 1, 1, 1); termination tells a fatal
outcome (discount 0) from the end of the snippet (discount 1).

The model comes from ``models/assets/walk_imitation_model.npz``, written
by ``export_model`` where mujoco is installed (``python -m
flybody_tpu_torch.tasks.walk_imitation`` rewrites it). Loading needs only
numpy, so the env builds on machines without mujoco.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from flybody_tpu_torch.envs.core import FlyEnv, Task
from flybody_tpu_torch.envs.walker import FlyWalker
from flybody_tpu_torch.io.trajectories import (TrajectoryDataset,
                                               load_hdf5_walking,
                                               synthetic_walking_dataset)
from flybody_tpu_torch.math import quaternions as mq
from flybody_tpu_torch.physics.kinematics import joint_plan
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.tasks import constants as C
from flybody_tpu_torch.tasks import rewards as rw

MODEL_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "assets", "walk_imitation_model.npz")

# Engine budgets of the env (the JAX package's, sized on a free fly over a
# flat floor): condim-3 (floor) contact islands of 24, 96 ccd lanes split
# over the four kink classes, the fused solver's (limit rows, cones) and
# one contact selection per control step. The fused solve has 176 rows.
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 24}, ccd_budget=96,
                    contact_solver="fused", fused_sel=(24, 48),
                    col_refresh=10)


@dataclasses.dataclass
class ImitationState:
    traj_idx: torch.Tensor     # (B,) int64 snippet index
    step: torch.Tensor         # (B,) int64 control step within the snippet
    snippet_len: torch.Tensor  # (B,) int64 control steps of the episode


def build_mj_model(claw_friction: float = 1.0, joint_filter: float = 0.01,
                   adhesion_filter: float = 0.007):
    """Compile the walk_imitation MjModel (needs mujoco). Returns
    (mj_model, action_maps)."""
    from flybody_tpu_torch.models import fruitfly as ff
    from flybody_tpu_torch.tasks.template_task import floor_arena
    cfg = ff.FlyConfig(
        use_legs=True, use_wings=False, joint_filter=joint_filter,
        adhesion_filter=adhesion_filter, root_joint="free",
        spawn_pos=(0.0, 0.0, 0.1278),
        physics_timestep=C.WALK_PHYSICS_TIMESTEP,
        control_timestep=C.WALK_CONTROL_TIMESTEP)
    morph = ff.apply_surgery(ff.load_morphology(), cfg)
    for b in morph.bodies:
        for g in b.geoms:
            if (g.name.startswith("claw") or "labrum" in g.name) and g.gap > 0:
                g.friction = np.array([claw_friction, 0.005, 0.0001])
    spec = ff.to_spec(morph, cfg, arena_fn=floor_arena())
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


class WalkImitation(Task):
    ctrl_dt = C.WALK_CONTROL_TIMESTEP
    phys_dt = C.WALK_PHYSICS_TIMESTEP
    # every reset draws a snippet per env, so auto-reset builds a fresh
    # batch
    deterministic_init = False

    def __init__(self, walker: FlyWalker, dataset: TrajectoryDataset,
                 time_limit: float = 10.0, future_steps: int = 64,
                 terminal_com_dist: float = 2.0):
        self.walker = walker
        self.time_limit = time_limit
        self.future_steps = future_steps
        self.terminal_com_dist = terminal_com_dist
        self.action_size = walker.action_size
        model = walker.model
        self.dataset = dataset.to(model.device, model.dtype)
        # mocap joints: the fly's scalar joints in model order (the
        # datasets follow the same order); sites: the claws
        self.mocap_joints = joint_plan(model).scalar[0]
        self.joint_qposadr = np.asarray(model.jnt_qposadr)[self.mocap_joints]
        self.joint_dofadr = np.asarray(model.jnt_dofadr)[self.mocap_joints]
        self.mocap_sites = np.asarray(walker.claw_sites, dtype=np.int64)
        self.root_qposadr = int(np.asarray(model.jnt_qposadr)[0])
        # max usable episode steps per snippet
        self._max_steps = round(time_limit / self.ctrl_dt) + 1
        # the root pose columns of the reference, for the preview window
        self._ref_root = self.dataset.fields["qpos"][..., :7].contiguous()

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def init_state(self, model: Model, data: Data, generator,
                   traj_idx: torch.Tensor | None = None):
        """Each env starts at frame 0 of a snippet: ``traj_idx`` (B,) if
        given, else drawn from ``generator`` (on the env's device)."""
        ds = self.dataset
        B = data.qpos.shape[-1]
        dev = data.qpos.device
        if traj_idx is None:
            traj_idx = torch.randint(0, ds.num_trajectories, (B,),
                                     generator=generator, device=dev)
        traj_idx = torch.as_tensor(traj_idx, device=dev).long()
        snippet_len = torch.clamp(
            ds.lengths[traj_idx] - self.future_steps - 1,
            max=self._max_steps)
        ts = ImitationState(traj_idx=traj_idx,
                            step=torch.zeros_like(traj_idx),
                            snippet_len=snippet_len)
        # the initial pose from the snippet's frame 0
        qpos0_ref = ds.fields["qpos"][traj_idx, 0].T.to(data.qpos.dtype)
        qvel0_ref = ds.fields["qvel"][traj_idx, 0].T.to(data.qvel.dtype)
        nj = len(self.mocap_joints)
        a = self.root_qposadr
        qpos = data.qpos.clone()
        qpos[a:a + 7] = qpos0_ref[:7]
        qpos[model.ix(self.joint_qposadr)] = qpos0_ref[7:7 + nj]
        qvel = data.qvel.clone()
        qvel[:6] = qvel0_ref[:6]
        qvel[model.ix(self.joint_dofadr)] = qvel0_ref[6:6 + nj]
        return data.replace(qpos=qpos, qvel=qvel), ts

    def before_step(self, model: Model, data: Data, task_state, action):
        return self.walker.apply_action(data, action), task_state

    def after_substeps(self, model: Model, data: Data, task_state):
        return data, dataclasses.replace(task_state,
                                         step=task_state.step + 1)

    # ------------------------------------------------------------------
    def _ref_window(self, ts: ImitationState) -> torch.Tensor:
        """(B, future_steps + 1, 7): each env's reference root pose at its
        steps [step, step + future_steps], clamped to the snippet."""
        idx = ts.step[:, None] + torch.arange(
            self.future_steps + 1, device=ts.step.device)
        idx = torch.minimum(idx, self.dataset.lengths[ts.traj_idx][:, None]
                            - 1)
        return self._ref_root[ts.traj_idx[:, None], idx]

    def observations(self, model: Model, data: Data, task_state,
                     sensor_mean) -> dict:
        w = self.walker
        obs = w.observables(model, data, sensor_mean)
        obs["appendages_pos"] = w.appendages_pos(data)
        obs.update(w.force_touch_obs(sensor_mean))
        a = self.root_qposadr
        B = data.qpos.shape[-1]
        fly_pos = data.qpos[a:a + 3].T[:, None]         # (B, 1, 3)
        fly_quat = data.qpos[a + 3:a + 7].T[:, None]    # (B, 1, 4)
        ref = self._ref_window(task_state)              # (B, F + 1, 7)
        obs["ref_displacement"] = mq.rotate_vec_with_quat(
            ref[..., :3] - fly_pos, mq.conj_quat(fly_quat)).reshape(B, -1)
        obs["ref_root_quat"] = mq.get_dquat_local(
            fly_quat, ref[..., 3:7]).reshape(B, -1)
        return obs

    def _deep_mimic_factors(self, model: Model, data: Data, ts):
        walker_ft = rw.get_walker_features(
            model, data, self.joint_dofadr, self.mocap_joints,
            self.mocap_sites, self.root_qposadr)
        step = torch.minimum(ts.step, self.dataset.lengths[ts.traj_idx] - 1)
        ref_ft = rw.get_reference_features(self.dataset.fields, ts.traj_idx,
                                           step)
        factors = rw.reward_factors_deep_mimic(
            walker_ft, ref_ft, weights=(20.0, 1.0, 1.0, 1.0))
        return factors, walker_ft, ref_ft

    def reward_factors(self, model: Model, data: Data, task_state,
                       sensor_mean) -> dict:
        """The four DeepMimic channels, each (B,), whose product is the
        reward."""
        factors = self._deep_mimic_factors(model, data, task_state)[0]
        return dict(zip(("com", "qvel", "end_effectors", "joints"),
                        factors))

    def reward_term_discount(self, model: Model, data: Data, task_state,
                             sensor_mean):
        factors, walker_ft, ref_ft = self._deep_mimic_factors(
            model, data, task_state)
        reward = torch.prod(factors, dim=0)
        norm = lambda x, dim=1: torch.linalg.vector_norm(x, dim=dim)
        linvel = norm(self.walker.sensor_obs(sensor_mean, "velocimeter"))
        angvel = norm(self.walker.sensor_obs(sensor_mean, "gyro"))
        com_dist = norm(ref_ft["com"] - walker_ft["com"], dim=0)
        qacc = norm(data.qacc, dim=0)
        reached_end = task_state.step >= task_state.snippet_len
        fatal = ((linvel > C.TERMINAL_LINVEL)
                 | (angvel > C.TERMINAL_ANGVEL)
                 | (com_dist > self.terminal_com_dist)
                 | (qacc > C.TERMINAL_QACC)
                 | torch.any(torch.isnan(data.qpos), dim=0))
        terminated = fatal | reached_end
        discount = torch.where(fatal & ~reached_end,
                               torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, terminated, discount


def make_walk_imitation(device, dtype=torch.float32,
                        ref_path: str | None = None,
                        time_limit: float = 10.0) -> FlyEnv:
    """The walk_imitation FlyEnv on ``device`` from the committed model.
    With no ``ref_path`` the synthetic walking dataset is tracked."""
    from flybody_tpu_torch.physics import io_mj
    mj = load_model()
    model = io_mj.put_model(mj, device=device, dtype=dtype, **PUT_MODEL_KW)
    walker = FlyWalker(model, json.loads(str(mj["action_maps_json"])))
    if ref_path is not None:
        dataset = load_hdf5_walking(ref_path)
    else:
        n_joints = len(joint_plan(model).scalar[0])
        qpos0 = np.zeros(7 + n_joints, np.float32)
        qpos0[2] = 0.1278
        qpos0[3] = 1.0
        dataset = synthetic_walking_dataset(
            qpos0, n_joints=n_joints, n_sites=len(walker.claw_sites),
            timestep=C.WALK_CONTROL_TIMESTEP)
    task = WalkImitation(walker, dataset, time_limit=time_limit)
    return FlyEnv(model, task, dtype=dtype)


if __name__ == "__main__":
    export_model()
    print("wrote", MODEL_PATH)
