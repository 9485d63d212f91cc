"""Fly walker: action routing, specs, and observable functions.

The walker holds only static metadata (index maps resolved from the model's
name tables and the action maps of the model build); every observable is
a batched function of (Data, sensor_mean) returning batch-leading (B, ...)
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import quaternions as mq
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.types import Data, Model

# Action classes in canonical order (models/fruitfly.ACTION_CLASSES).
ACTION_CLASSES = ("adhesion", "head", "mouth", "antennae", "wings",
                  "abdomen", "legs", "user")


class FlyWalker:
    """Static walker metadata + batched observable/action functions."""

    def __init__(self, model: Model, action_maps: dict):
        self.model = model
        self.action_maps = action_maps
        names = model.names
        self.thorax_id = names["body"]["thorax"]
        self.claw_sites = [v for k, v in sorted(names["site"].items())
                           if k.startswith("claw_")]
        # appendages = end effectors + the head site
        self.appendage_sites = list(self.claw_sites)
        if "head" in names["site"]:
            self.appendage_sites.append(names["site"]["head"])
        self.sensor_adr = {}
        for name, sid in names["sensor"].items():
            self.sensor_adr[name] = (int(np.asarray(model.sensor_adr)[sid]),
                                     int(np.asarray(model.sensor_dim)[sid]))
        # observable joints: scalar joints minus the disabled body parts'
        jt = np.asarray(model.jnt_type)
        scalar = (jt == T.HINGE) | (jt == T.SLIDE)
        obs_names = action_maps.get("observable_joints")
        if obs_names is not None:
            keep = {names["joint"][n] for n in obs_names
                    if n in names["joint"]}
            fly_joints = [j for j in range(model.njnt)
                          if scalar[j] and j in keep]
        else:
            fly_joints = [j for j in range(model.njnt) if scalar[j]]
        self.joint_qposadr = np.asarray(model.jnt_qposadr)[fly_joints]
        self.joint_dofadr = np.asarray(model.jnt_dofadr)[fly_joints]
        # ctrl routing: env action index per ctrl slot (-1 = none)
        ctrl_src = np.full(model.nu, -1, dtype=np.int64)
        for cls in ACTION_CLASSES:
            for ci, ai in zip(action_maps["ctrl"].get(cls, []),
                              action_maps["action"][cls]):
                ctrl_src[ci] = ai
        self.ctrl_from_action = ctrl_src
        self.action_size = action_maps["total"]

    # -- actions ------------------------------------------------------------
    def apply_action(self, data: Data, action: torch.Tensor) -> Data:
        """Route the env action (B, A) into ctrl (nu, B)."""
        m = self.model
        action = torch.where(torch.isnan(action), torch.zeros_like(action),
                             action)
        idx = self.ctrl_from_action
        ctrl = action[:, m.ix(np.maximum(idx, 0))].T
        ctrl = torch.where(m.const(idx >= 0)[:, None], ctrl,
                           torch.zeros_like(ctrl))
        return data.replace(ctrl=ctrl.to(data.ctrl.dtype))

    def action_bounds(self, model: Model):
        """(lo, hi) numpy arrays over the env action vector."""
        lo = np.full(self.action_size, -1.0)
        hi = np.full(self.action_size, 1.0)
        cr = model.actuator_ctrlrange.detach().cpu().numpy()
        for ci, ai in enumerate(self.ctrl_from_action):
            if ai >= 0:
                lo[ai] = cr[ci, 0]
                hi[ai] = cr[ci, 1]
        return lo, hi

    # -- observables ---------------------------------------------------------
    def sensor_obs(self, sensor_mean, name):
        """(B, dim) sensor reading from sensor_mean (nsensordata, B)."""
        adr, dim = self.sensor_adr[name]
        return sensor_mean[adr:adr + dim].T

    def sensors_concat(self, sensor_mean, prefix):
        parts = [self.sensor_obs(sensor_mean, n)
                 for n in sorted(self.sensor_adr) if n.startswith(prefix)]
        if not parts:
            return sensor_mean.new_zeros((sensor_mean.shape[-1], 0))
        return torch.cat(parts, dim=1)

    def observables(self, model: Model, data: Data, sensor_mean) -> dict:
        """Core observable dict (vestibular + proprioception)."""
        return {
            "joints_pos": data.qpos[model.ix(self.joint_qposadr)].T,
            "joints_vel": data.qvel[model.ix(self.joint_dofadr)].T,
            "actuator_activation": data.act.T,
            "gyro": self.sensor_obs(sensor_mean, "gyro"),
            "accelerometer": self.sensor_obs(sensor_mean, "accelerometer"),
            "velocimeter": self.sensor_obs(sensor_mean, "velocimeter"),
            "world_zaxis": data.xmat[self.thorax_id, 2].T,
        }

    def appendages_pos(self, data: Data):
        """Egocentric appendage positions (claws + head site), (B, 3 n)."""
        B = data.qpos.shape[-1]
        if not self.appendage_sites:
            return data.qpos.new_zeros((B, 0))
        tips = data.site_xpos[self.model.ix(self.appendage_sites)]
        tips = tips.permute(2, 0, 1)                       # (B, n, 3)
        root_pos = data.xpos[self.thorax_id].T[:, None]    # (B, 1, 3)
        root_quat = data.xquat[self.thorax_id].T[:, None]  # (B, 1, 4)
        ego = mq.rotate_vec_with_quat(tips - root_pos,
                                      mq.conj_quat(root_quat))
        return ego.reshape(B, -1)

    def force_touch_obs(self, sensor_mean):
        return {
            "force": self.sensors_concat(sensor_mean, "force_"),
            "touch": self.sensors_concat(sensor_mean, "touch_"),
        }
