"""Rodent (rat) walker: action routing, specs, and observable functions.

The dm_control rodent walker's surface that the reference rodent tasks
read (reference vnl_ray/tasks/basic_rodent_2020.py, dm_control
locomotion.walkers.rodent.Rat). Like FlyWalker, the walker holds only
static tables resolved from the model's names, in numpy on the host;
every observable is a batched function of (Data, sensor_mean) returning
batch-leading (B, ...) tensors.

The observables are the Rat's enabled proprioception and sensors: the
actuated joints' positions and velocities, actuator activations, tendons,
the IMU (gyro, accelerometer, velocimeter), touch (palms and soles), the
world z axis in the torso frame, and the egocentric end-effector and head
positions.
"""

from __future__ import annotations

import numpy as np
import torch

from flybody_tpu_torch.math import quaternions as mq
from flybody_tpu_torch.physics import types as T
from flybody_tpu_torch.physics.collision import selected_force, slot_layout
from flybody_tpu_torch.physics.kinematics import joint_plan
from flybody_tpu_torch.physics.types import Data, Model


class RodentWalker:
    """Static rat walker metadata + batched observable/action functions."""

    PREFIX = "walker/"

    def __init__(self, model: Model):
        self.model = model
        names = model.names
        p = self.PREFIX

        root_candidates = [p + "torso", p + "root", p + "thorax"]
        self.root_body_id = next(names["body"][n] for n in root_candidates
                                 if n in names["body"])
        self.torso_id = self.root_body_id
        self.pelvis_id = names["body"].get(p + "pelvis", self.root_body_id)
        self.head_site = names["site"].get(p + "head")
        self.head_body_id = names["body"].get(p + "skull",
                                              names["body"].get(p + "head", 0))
        self.lhand_body = names["body"].get(p + "hand_L", 0)
        self.rhand_body = names["body"].get(p + "hand_R", 0)

        # end effectors: dm_control Rat.end_effectors, the bodies
        # lower_arm_R, lower_arm_L, foot_R, foot_L in that order; the
        # appendages are the end effectors and the head
        ee_body_names = ["lower_arm_R", "lower_arm_L", "foot_R", "foot_L"]
        self.end_effector_bodies = np.asarray(
            [names["body"][p + n] for n in ee_body_names
             if p + n in names["body"]], dtype=np.int64)
        # without those bodies: the limb-tip sites
        self.end_effector_sites = np.asarray(
            [names["site"][p + n]
             for n in ["palm_L", "palm_R", "sole_L", "sole_R"]
             if p + n in names["site"]], dtype=np.int64)
        self.n_limb_tips = (len(self.end_effector_bodies)
                            or len(self.end_effector_sites))

        # sensor (address, dim) by unprefixed name
        sadr, sdim = np.asarray(model.sensor_adr), np.asarray(model.sensor_dim)
        self.sensor_adr = {}
        for name, sid in names["sensor"].items():
            short = name[len(p):] if name.startswith(p) else name
            self.sensor_adr[short] = (int(sadr[sid]), int(sdim[sid]))
        # canonical IMU names (the CMU humanoid's root sensors are
        # sensor_root_*)
        for canon, cands in {
                "gyro": ("gyro", "sensor_root_gyro"),
                "accelerometer": ("accelerometer", "sensor_root_accel"),
                "velocimeter": ("velocimeter", "sensor_root_veloc")}.items():
            for c in cands:
                if c in self.sensor_adr:
                    self.sensor_adr[canon] = self.sensor_adr[c]
                    break

        # mocap joints: every scalar joint in model order (the free root
        # excluded), for the tracking features
        jt = np.asarray(model.jnt_type)
        joints = joint_plan(model).scalar[0].tolist()
        self.joint_qposadr = np.asarray(model.jnt_qposadr)[joints]
        self.joint_dofadr = np.asarray(model.jnt_dofadr)[joints]
        # observable joints: the actuated joints in actuator order
        # (dm_control legacy_base.Walker.observable_joints)
        trn = np.asarray(model.actuator_trntype)
        trnid = np.asarray(model.actuator_trnid)[:, 0]
        ojs = [int(trnid[a]) for a in range(model.nu)
               if trn[a] == T.TRN_JOINT] or joints
        self.obs_joint_qposadr = np.asarray(model.jnt_qposadr)[ojs]
        self.obs_joint_dofadr = np.asarray(model.jnt_dofadr)[ojs]
        free = [j for j in range(model.njnt) if jt[j] == T.FREE]
        self.root_qposadr = (int(np.asarray(model.jnt_qposadr)[free[0]])
                             if free else None)

        # the walker's bodies (the attachment frame's subtree, the frame
        # itself excluded)
        parent = np.asarray(model.body_parentid)
        att = names["body"].get(p.rstrip("/"), self.root_body_id)
        in_walker = np.zeros(model.nbody, bool)
        in_walker[att] = True
        for b in range(1, model.nbody):
            if in_walker[parent[b]]:
                in_walker[b] = True
        in_walker[att] = False
        self.mocap_tracking_bodies = np.nonzero(in_walker)[0].astype(np.int64)

        # walker geoms, ground geoms, and the geoms whose ground contact
        # ends the corridor task (torso, pelvis, cervical vertebrae;
        # reference rodent_tasks_modified.py:205-218)
        geom_body = np.asarray(model.geom_bodyid)
        self.walker_geoms = np.nonzero(in_walker[geom_body])[0]
        bad = ("collision_pelvis", "collision_torso", "vertebra_C1_",
               "vertebra_C3_")
        self.nonfoot_geoms = np.asarray(sorted(
            g for n, g in names["geom"].items()
            if n.startswith(p) and any(b in n[len(p):] for b in bad)),
            dtype=np.int64)
        self.ground_geoms = np.asarray(sorted(
            g for n, g in names["geom"].items() if not n.startswith(p)),
            dtype=np.int64)
        self.touch_names = [n for n in sorted(self.sensor_adr)
                            if n.startswith(("palm", "sole", "sensor_touch"))]
        self.action_size = model.nu

    # -- actions ------------------------------------------------------------
    def apply_action(self, data: Data, action: torch.Tensor) -> Data:
        """The env action (B, nu) as ctrl (nu, B), NaN to 0."""
        action = torch.where(torch.isnan(action), torch.zeros_like(action),
                             action)
        return data.replace(ctrl=action.T.to(data.ctrl.dtype))

    def action_bounds(self, model: Model):
        cr = model.actuator_ctrlrange.detach().cpu().numpy()
        return cr[:, 0].copy(), cr[:, 1].copy()

    # -- observables --------------------------------------------------------
    def sensor_obs(self, sensor_mean, name):
        """(B, dim) sensor reading from sensor_mean (nsensordata, B)."""
        adr, dim = self.sensor_adr[name]
        return sensor_mean[adr:adr + dim].T

    def observables(self, model: Model, data: Data, sensor_mean) -> dict:
        B = data.qpos.shape[-1]
        app = self.appendages_pos(data)
        empty = data.qpos.new_zeros((B, 0))
        obs = {
            "joints_pos": data.qpos[model.ix(self.obs_joint_qposadr)].T,
            "joints_vel": data.qvel[model.ix(self.obs_joint_dofadr)].T,
            "actuator_activation": data.act.T,
            # dm_control's kinematic-sensor observable names
            "sensors_gyro": self.sensor_obs(sensor_mean, "gyro"),
            "sensors_accelerometer":
                self.sensor_obs(sensor_mean, "accelerometer"),
            "sensors_velocimeter":
                self.sensor_obs(sensor_mean, "velocimeter"),
            "world_zaxis": data.xmat[self.root_body_id, 2].T,
            "appendages_pos": app,
            "end_effectors_pos": app[:, :3 * self.n_limb_tips],
            "body_height": data.xpos[self.root_body_id, 2],
            # the rat has no force or torque sensor: dm_control observes
            # them as empty
            "sensors_force": empty,
            "sensors_torque": empty,
        }
        if model.ntendon:
            obs["tendons_pos"] = data.ten_length.T
            obs["tendons_vel"] = data.ten_velocity.T
        if self.touch_names:
            obs["sensors_touch"] = torch.cat(
                [self.sensor_obs(sensor_mean, n) for n in self.touch_names],
                dim=1)
        return obs

    def appendages_pos(self, data: Data):
        """Egocentric end-effector and head positions, (B, 3 n) (dm_control
        order: lower_arm_R, lower_arm_L, foot_R, foot_L, head)."""
        m = self.model
        if len(self.end_effector_bodies):
            tips = data.xpos[m.ix(self.end_effector_bodies)]
        else:
            tips = data.site_xpos[m.ix(self.end_effector_sites)]
        if self.head_site is not None:
            tips = torch.cat([tips, data.site_xpos[self.head_site][None]])
        tips = tips.permute(2, 0, 1)                           # (B, n, 3)
        root_pos = data.xpos[self.root_body_id].T[:, None]     # (B, 1, 3)
        root_quat = data.xquat[self.root_body_id].T[:, None]   # (B, 1, 4)
        ego = mq.rotate_vec_with_quat(tips - root_pos,
                                      mq.conj_quat(root_quat))
        return ego.reshape(ego.shape[0], -1)

    def origin_obs(self, data: Data):
        """The world origin in the torso frame, (B, 3) (reference Escape
        _origin)."""
        r = self.root_body_id
        return -torch.einsum("ijb,jb->bi", data.xmat[r], data.xpos[r])

    # -- task helpers -------------------------------------------------------
    def upright_zz(self, data: Data):
        """min(torso zz, pelvis zz), (B,): the cosine of the tilt that the
        upright reward reads (dm_control escape._upright_reward)."""
        return torch.minimum(data.xmat[self.torso_id, 2, 2],
                             data.xmat[self.pelvis_id, 2, 2])

    def aliveness(self, data: Data):
        """In [-1, 0]: 0 upright, -1 upside down (dm_control Rat
        .aliveness = (torso zz - 1) / 2), (B,)."""
        return 0.5 * (data.xmat[self.torso_id, 2, 2] - 1.0)

    def subtree_linvel(self, sensor_mean):
        """The torso subtree's linear velocity, (B, 3)."""
        return self.sensor_obs(sensor_mean, "torso")

    def head_pos(self, data: Data):
        """(B, 3): the head site, else the root body."""
        if self.head_site is not None:
            return data.site_xpos[self.head_site].T
        return data.xpos[self.root_body_id].T

    def contact_flag(self, model: Model, data: Data, geoms_a, geoms_b):
        """(B,) 1.0 where a selected contact with a nonzero force joins a
        geom of set a with one of set b, analytic and convex slots alike.
        (The JAX package's table is over candidate pairs, indexed by the
        slot ids; ROADMAP C.)"""
        B = data.qpos.shape[-1]
        if model.ncon_max == 0 or data.warm_sel.shape[0] == 0:
            return data.qpos.new_zeros((B,))
        a, b = np.asarray(geoms_a, np.int64), np.asarray(geoms_b, np.int64)

        def build(m):
            g1, g2 = slot_layout(m).cand_g1, slot_layout(m).cand_g2
            return m.const((np.isin(g1, a) & np.isin(g2, b))
                           | (np.isin(g1, b) & np.isin(g2, a)))
        mask = model.plan(("contact_flag", a.tobytes(), b.tobytes()), build)
        return (selected_force(data, mask) > 0).to(data.qpos.dtype)
