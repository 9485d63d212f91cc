"""Flight imitation with a wing-beat pattern generator (WBPG).

The winged fly flies freely in air (no floor), pitched to the hover pose,
with MuJoCo's ellipsoid fluid model on its wings. The agent's wing actions
ride on top of the WBPG's base pattern: each control step the generator's
target angles minus the wings' current angles are added to the wing
actions (position control turned into force offsets), and one extra user
action moves the beat frequency within base * (1 +- rel_freq_range). The
reward is the product of the CoM-displacement and root-quaternion
tolerance factors; falling below ``TERMINAL_HEIGHT`` or straying from the
reference is fatal (discount 0), the end of the snippet is not.

The reference trajectories keep the dataset's float32, and the CoM <-> root
maps of reference poses run in float32 as in the JAX package; the fly's
own state is in the env's dtype.

The model comes from ``models/assets/flight_imitation_model.npz``, written
by ``export_model`` where mujoco is installed (``python -m
flybody_tpu_torch.tasks.flight_imitation`` rewrites it). Loading needs only
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
                                               load_hdf5_flight,
                                               synthetic_flight_dataset)
from flybody_tpu_torch.math import quaternions as mq
from flybody_tpu_torch.physics.types import Data, Model
from flybody_tpu_torch.tasks import constants as C
from flybody_tpu_torch.tasks.pattern_generators import (
    WBPGState, WingBeatPatternGenerator)
from flybody_tpu_torch.tasks.task_utils import com2root, root2com
from flybody_tpu_torch.utils import rewards as rwu

MODEL_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                          "models", "assets", "flight_imitation_model.npz")

# the wing actuators' filter time constant the committed model is built
# with
JOINT_FILTER = 0.0002

# Engine budgets of the env (the JAX package's): no floor and no analytic
# condim-3 pair, only condim-1 self-contact sensing (8) and 32 convex
# self-collision lanes; the fused solver's (limit rows, cones) and one
# contact selection per control step (4 substeps). The fused solve has
# 8 limit + 8 condim-1 + 3 x 16 cone = 64 rows.
PUT_MODEL_KW = dict(con_sel={1: 8}, ccd_budget=32, contact_solver="fused",
                    fused_sel=(8, 16), col_refresh=4)

_WING_JOINTS = [f"wing_{axis}_{side}" for side in ("left", "right")
                for axis in ("yaw", "roll", "pitch")]


@dataclasses.dataclass
class FlightState:
    traj_idx: torch.Tensor     # (B,) int64 snippet index
    step: torch.Tensor         # (B,) int64 control step within the snippet
    snippet_len: torch.Tensor  # (B,) int64 control steps of the episode
    wbpg: WBPGState


def build_mj_model(joint_filter: float = JOINT_FILTER):
    """Compile the flight_imitation MjModel (needs mujoco): the flight fly
    (wings on, legs off, free root, hover pitch, one user action, wing
    fluid) with the flying-base edits of wing stiffness, damping, fluid
    coefficients and actuator gain. Returns (mj_model, action_maps)."""
    from flybody_tpu_torch.models import fruitfly as ff
    wp = C.WING_PARAMS
    cfg = ff.FlyConfig(
        use_legs=False, use_wings=True, use_mouth=False, use_antennae=False,
        joint_filter=joint_filter, root_joint="free",
        body_pitch_angle=C.BODY_PITCH_ANGLE,
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
    spec = ff.to_spec(morph, cfg, arena_fn=None)  # no floor
    return spec.compile(), ff.action_indices(morph, cfg)


def export_model(path: str | None = MODEL_PATH, **build_kw) -> dict:
    """Build the model with mujoco and return the mapping ``put_model``
    reads (plus the action maps); write it to ``path`` unless None."""
    from flybody_tpu_torch.physics import io_mj
    mj_model, amap = build_mj_model(**build_kw)
    out = io_mj.export_mj(mj_model)
    out["action_maps_json"] = np.asarray(json.dumps(amap, sort_keys=True))
    if path is not None:
        np.savez_compressed(path, **out)
    return out


def load_model(path: str = MODEL_PATH) -> dict:
    """The committed model mapping (numpy only)."""
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


class FlightImitationWBPG(Task):
    ctrl_dt = C.FLY_CONTROL_TIMESTEP
    phys_dt = C.FLY_PHYSICS_TIMESTEP
    # every reset draws a snippet and a wing-beat phase per env
    deterministic_init = False

    def __init__(self, walker: FlyWalker, dataset: TrajectoryDataset,
                 wbpg: WingBeatPatternGenerator, time_limit: float = 0.6,
                 future_steps: int = 5, terminal_com_dist: float = 0.3):
        self.walker = walker
        self.wbpg = wbpg
        self.time_limit = time_limit
        self.future_steps = future_steps
        self.terminal_com_dist = terminal_com_dist
        self.action_size = walker.action_size  # includes 1 user action
        model = walker.model
        # float32 as loaded: reference poses are mapped in float32
        self.dataset = dataset.to(model.device)
        names = model.names
        wing_ids = np.array([names["joint"][n] for n in _WING_JOINTS])
        self.wing_qposadr = np.asarray(model.jnt_qposadr)[wing_ids]
        self.wing_dofadr = np.asarray(model.jnt_dofadr)[wing_ids]
        amap = walker.action_maps
        self.wing_action_idx = np.asarray(amap["action"]["wings"], np.int64)
        self.user_action_idx = int(amap["action"]["user"][0])
        self.root_qposadr = int(np.asarray(model.jnt_qposadr)[0])
        self._max_steps = round(time_limit / self.ctrl_dt)
        self.rel_range = float(wbpg.beat_freqs[-1] / wbpg.base_beat_freq
                               - 1.0)

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    def init_state(self, model: Model, data: Data, generator,
                   traj_idx: torch.Tensor | None = None,
                   initial_phase: torch.Tensor | None = None):
        """Each env starts at frame 0 of a snippet with its wings at a
        point of the beat: ``traj_idx`` (B,) and ``initial_phase`` (B,) in
        [0, 1) if given, else drawn from ``generator`` (on the env's
        device) in that order."""
        ds = self.dataset
        B = data.qpos.shape[-1]
        dev, dtype = data.qpos.device, data.qpos.dtype
        if traj_idx is None:
            traj_idx = torch.randint(0, ds.num_trajectories, (B,),
                                     generator=generator, device=dev)
        if initial_phase is None:
            initial_phase = torch.rand((B,), generator=generator,
                                       device=dev, dtype=dtype)
        traj_idx = torch.as_tensor(traj_idx, device=dev).long()
        initial_phase = torch.as_tensor(initial_phase, device=dev)
        snippet_len = torch.clamp(
            ds.lengths[traj_idx] - self.future_steps - 1,
            max=self._max_steps)
        com0 = ds.fields["com_qpos"][traj_idx, 0]              # (B, 7)
        root_pos = com2root(com0[:, :3], com0[:, 3:7])
        a = self.root_qposadr
        qpos = data.qpos.clone()
        qpos[a:a + 3] = root_pos.T.to(dtype)
        qpos[a + 3:a + 7] = com0[:, 3:7].T.to(dtype)
        angles, wing_qvel, wbpg_state = self.wbpg.reset(initial_phase)
        qpos[model.ix(self.wing_qposadr)] = angles.T.to(dtype)
        qvel = data.qvel.clone()
        qvel[model.ix(self.wing_dofadr)] = wing_qvel.T.to(dtype)
        qvel[:3] = ds.fields["com_qvel"][traj_idx, 0, :3].T.to(dtype)
        ts = FlightState(traj_idx=traj_idx, step=torch.zeros_like(traj_idx),
                         snippet_len=snippet_len, wbpg=wbpg_state)
        return data.replace(qpos=qpos, qvel=qvel), ts

    def before_step(self, model: Model, data: Data, ts: FlightState,
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

    def after_substeps(self, model: Model, data: Data, ts: FlightState):
        return data, dataclasses.replace(ts, step=ts.step + 1)

    # ------------------------------------------------------------------
    def _ref_window(self, ts: FlightState):
        """(root positions (B, F + 1, 3), quaternions (B, F + 1, 4)) of each
        env's reference at steps [step, step + future_steps], clamped to
        the snippet; float32."""
        idx = ts.step[:, None] + torch.arange(
            self.future_steps + 1, device=ts.step.device)
        idx = torch.minimum(idx, self.dataset.lengths[ts.traj_idx][:, None]
                            - 1)
        com = self.dataset.fields["com_qpos"][ts.traj_idx[:, None], idx]
        return com2root(com[..., :3], com[..., 3:7]), com[..., 3:7]

    def observations(self, model: Model, data: Data, ts: FlightState,
                     sensor_mean) -> dict:
        w = self.walker
        obs = w.observables(model, data, sensor_mean)
        obs["world_zaxis_hover"] = w.world_zaxis_hover(model, data)
        a = self.root_qposadr
        B = data.qpos.shape[-1]
        dtype = data.qpos.dtype
        fly_pos = data.qpos[a:a + 3].T[:, None]         # (B, 1, 3)
        fly_quat = data.qpos[a + 3:a + 7].T[:, None]    # (B, 1, 4)
        ref_pos, ref_quat = self._ref_window(ts)
        obs["ref_displacement"] = mq.rotate_vec_with_quat(
            ref_pos.to(dtype) - fly_pos,
            mq.conj_quat(fly_quat)).reshape(B, -1)
        obs["ref_root_quat"] = mq.get_dquat_local(
            fly_quat, ref_quat.to(dtype)).reshape(B, -1)
        # the flight observes its wing joints only
        obs["joints_pos"] = data.qpos[model.ix(self.wing_qposadr)].T
        obs["joints_vel"] = data.qvel[model.ix(self.wing_dofadr)].T
        return obs

    def reward_term_discount(self, model: Model, data: Data,
                             ts: FlightState, sensor_mean):
        a = self.root_qposadr
        dtype = data.qpos.dtype
        fly_pos = data.qpos[a:a + 3].T                  # (B, 3)
        fly_quat = data.qpos[a + 3:a + 7].T             # (B, 4)
        step = torch.minimum(ts.step, self.dataset.lengths[ts.traj_idx] - 1)
        com_ref = self.dataset.fields["com_qpos"][ts.traj_idx, step]
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)
        model_com = root2com(fly_pos, fly_quat)
        displacement = norm(com_ref[:, :3].to(dtype) - model_com)
        disp_r = rwu.tolerance(displacement, bounds=(0.0, 0.0),
                               sigmoid="linear", margin=0.4,
                               value_at_margin=0.0)
        dquat = mq.get_dquat_local(fly_quat, com_ref[:, 3:7].to(dtype))
        qdist = mq.quat_dist_short_arc(
            torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                         device=fly_quat.device), dquat)
        quat_r = rwu.tolerance(qdist, bounds=(0.0, 0.0), sigmoid="linear",
                               margin=np.pi, value_at_margin=0.0)
        reward = disp_r * quat_r

        height = self.walker.thorax_height(data)
        qacc = torch.linalg.vector_norm(data.qacc, dim=0)
        reached_end = ts.step >= ts.snippet_len
        root_pos_ref = com2root(com_ref[:, :3], com_ref[:, 3:7])
        com_dist = norm(root_pos_ref.to(dtype) - fly_pos)
        fatal = ((height < C.TERMINAL_HEIGHT)
                 | (com_dist > self.terminal_com_dist)
                 | (qacc > C.TERMINAL_QACC)
                 | torch.any(torch.isnan(data.qpos), dim=0))
        terminated = fatal | reached_end
        discount = torch.where(fatal & ~reached_end,
                               torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, terminated, discount


def make_flight_imitation(device, dtype=torch.float32,
                          ref_path: str | None = None,
                          wpg_pattern_path: str | None = None,
                          time_limit: float = 0.6, future_steps: int = 5,
                          terminal_com_dist: float = 0.3,
                          joint_filter: float = JOINT_FILTER) -> FlyEnv:
    """The flight_imitation FlyEnv on ``device``. The model is the
    committed asset; another ``joint_filter`` rebuilds it (needs mujoco).
    With no ``ref_path`` the synthetic flight dataset is tracked, with no
    ``wpg_pattern_path`` (an .npy of one (n, 3) wing-beat cycle) the
    synthetic base pattern drives the wings."""
    from flybody_tpu_torch.physics import io_mj
    mj = (load_model() if joint_filter == JOINT_FILTER
          else export_model(None, joint_filter=joint_filter))
    model = io_mj.put_model(mj, device=device, dtype=dtype, **PUT_MODEL_KW)
    walker = FlyWalker(model, json.loads(str(mj["action_maps_json"])))
    if ref_path is not None:
        dataset = load_hdf5_flight(ref_path)
    else:
        dataset = synthetic_flight_dataset(timestep=C.FLY_CONTROL_TIMESTEP)
    base = np.load(wpg_pattern_path) if wpg_pattern_path is not None \
        else None
    wbpg = WingBeatPatternGenerator(base_pattern=base, device=model.device)
    task = FlightImitationWBPG(walker, dataset, wbpg, time_limit=time_limit,
                               future_steps=future_steps,
                               terminal_com_dist=terminal_com_dist)
    return FlyEnv(model, task, dtype=dtype)


if __name__ == "__main__":
    export_model()
    print("wrote", MODEL_PATH)
