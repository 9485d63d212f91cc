"""Multi-clip mocap tracking (reference-pose imitation), batched over envs.

The JAX package's ``tasks/tracking.py`` (reference
vnl_ray/tasks/tracking_old.py:102-930, the thin wrapper
vnl_ray/tasks/tracking.py:73-127):

* The clip collection is loaded once into padded device tensors of
  reference features (joints, body positions and quaternions, root pose,
  joint velocities, appendages), computed by the reference's own forward
  kinematics over every frame and stored in float32 whatever the model's
  dtype, as in the JAX package.
* Each env's clip, start frame and step are (B,) tensors in the task
  state; a reference feature is one gather ``fields[key][clip, t]`` for
  every env (and every preview step at once), with ``t`` clamped to the
  clip's last frame.
* Reset draws the clip, then the start, from the env's generator on its
  device: ``clip`` uniform over the clips, ``start = floor(u max_start)``
  with ``u`` uniform in [0, 1) and ``max_start = max(length - min_steps -
  max(ref_steps), 1)`` of the env's clip. ``init_state`` also takes
  ``clip=`` and ``start=`` (B,) (the parity tests pass the JAX package's
  draws).
* Observations: the walker's, plus the reference previews over
  ``ref_steps`` (relative joints, egocentric relative body positions, the
  relative root quaternion, egocentric body quaternions, appendages) and
  ``clip_id`` (reference tracking_old.py:570-732).
* Termination error = 0.5 body_error_multiplier mean |body position
  difference| + 0.5 mean |joint difference|, per env; past the threshold
  (or a blown-up env) the episode ends with discount 0, at the clip's end
  with discount 1.
* Reward: the family of ``tracking_rewards`` (comic by default); its
  channels are ``reward_factors``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference.envs.core import Task
from benchmark.reference.math import quaternions as mq
from benchmark.reference.physics.types import Data, Model
from benchmark.reference.tasks import tracking_rewards as tr


@dataclasses.dataclass
class ClipCollection:
    """Padded per-clip reference features on the device, float32.

    fields: qpos (N, T, nq), qvel (N, T, nv), joints (N, T, nj),
    joints_velocity (N, T, nj), body_positions (N, T, nb, 3),
    body_quaternions (N, T, nb, 4), position (N, T, 3), quaternion
    (N, T, 4), appendages (N, T, ne, 3); lengths (N,) int64.
    """
    fields: dict
    lengths: torch.Tensor
    timestep: float

    @property
    def num_clips(self) -> int:
        return int(self.lengths.shape[0])


def build_clip_features(model: Model, walker, qpos: np.ndarray,
                        qvel: np.ndarray, lengths: np.ndarray,
                        timestep: float) -> ClipCollection:
    """Reference features of the raw clips ``qpos`` (N, T, nq) and
    ``qvel`` (N, T, nv), by the reference's forward kinematics over all N T
    frames at once (in the model's dtype, on its device)."""
    from benchmark.reference.physics import io_mj
    from benchmark.reference.physics import kinematics as K

    N, Tlen, nq = qpos.shape
    dev = model.device
    d = io_mj.make_data(model, B=N * Tlen)
    flat_q = torch.as_tensor(qpos.reshape(N * Tlen, nq).T, device=dev)
    d = K.kinematics(model, d.replace(qpos=flat_q.to(d.qpos.dtype)))

    def unflat(x):
        # (nb, comp, N T) -> (N, T, nb, comp)
        return x.permute(2, 0, 1).reshape(N, Tlen, *x.shape[:2])

    body_pos, body_quat = unflat(d.xpos), unflat(d.xquat)
    app = walker.appendages_pos(d).reshape(N, Tlen, -1, 3)
    f32 = lambda x: torch.as_tensor(x, device=dev).to(torch.float32)
    fields = dict(
        qpos=f32(qpos), qvel=f32(qvel),
        joints=f32(qpos[..., walker.joint_qposadr]),
        joints_velocity=f32(qvel[..., walker.joint_dofadr]),
        body_positions=f32(body_pos), body_quaternions=f32(body_quat),
        position=f32(body_pos[:, :, walker.root_body_id]),
        quaternion=f32(body_quat[:, :, walker.root_body_id]),
        appendages=f32(app))
    return ClipCollection(
        fields=fields,
        lengths=torch.as_tensor(np.asarray(lengths), dtype=torch.int64,
                                device=dev),
        timestep=timestep)


class MultiClipTracking(Task):
    """Batched MultiClipMocapTracking (reference tracking_old.py:788)."""

    def __init__(self, walker, clips: ClipCollection,
                 ref_steps=(1, 2, 3, 4, 5),
                 termination_error_threshold: float = 0.3,
                 body_error_multiplier: float = 1.0,
                 reward_key: str = "comic", tuning: str = "rodent",
                 min_steps: int = 10, time_limit: float = 10.0,
                 ctrl_dt: float = 0.02, phys_dt: float = 0.002):
        self.walker = walker
        self.clips = clips
        self.ref_steps = tuple(int(r) for r in ref_steps)
        self.termination_error_threshold = termination_error_threshold
        self.body_error_multiplier = body_error_multiplier
        self.reward_key = reward_key
        self.tuning = tuning
        self.min_steps = min_steps
        self.time_limit = time_limit
        self.ctrl_dt = ctrl_dt
        self.phys_dt = phys_dt
        self.action_size = walker.action_size
        # the bodies of the termination error and the relative-body obs
        self.body_idxs = np.asarray(walker.mocap_tracking_bodies,
                                    dtype=np.int64)
        dev = clips.lengths.device
        self._offsets = torch.as_tensor(self.ref_steps, device=dev)
        self._now = torch.zeros(1, dtype=torch.int64, device=dev)
        self._body_ix = torch.as_tensor(self.body_idxs, device=dev)

    def action_bounds(self, model: Model):
        return self.walker.action_bounds(model)

    # -- episode init ------------------------------------------------------
    def init_state(self, model: Model, data: Data, generator, clip=None,
                   start=None):
        B, dev = data.qpos.shape[-1], data.qpos.device
        lengths = self.clips.lengths
        if clip is None:
            clip = torch.randint(0, self.clips.num_clips, (B,),
                                 generator=generator, device=dev)
        clip = torch.as_tensor(clip, device=dev).long()
        if start is None:
            horizon = self.min_steps + max(self.ref_steps)
            max_start = torch.clamp(lengths[clip] - horizon, min=1)
            u = torch.rand((B,), generator=generator, device=dev,
                           dtype=torch.float64)
            start = torch.minimum(torch.floor(u * max_start).long(),
                                  max_start - 1)
        start = torch.as_tensor(start, device=dev).long()
        f = self.clips.fields
        data = data.replace(qpos=f["qpos"][clip, start].T.to(data.qpos.dtype),
                            qvel=f["qvel"][clip, start].T.to(data.qvel.dtype))
        return data, dict(clip=clip, start=start, step=torch.zeros_like(clip))

    def before_step(self, model: Model, data: Data, ts, action):
        return self.walker.apply_action(data, action), ts

    def after_substeps(self, model: Model, data: Data, ts):
        return data, dict(ts, step=ts["step"] + 1)

    # -- features ----------------------------------------------------------
    def _ref(self, key, ts, offsets):
        """``fields[key]`` of every env's clip at start + step + each of
        ``offsets`` ((K,) tensor), clamped to the clip's last frame:
        (B, K, ...), float32 (the arithmetic with the walker's features
        promotes as the JAX package's does)."""
        clip = ts["clip"][:, None]
        t = torch.minimum(ts["start"][:, None] + ts["step"][:, None]
                          + offsets, self.clips.lengths[clip] - 1)
        return self.clips.fields[key][clip, t]

    def _ref_now(self, key, ts):
        return self._ref(key, ts, self._now)[:, 0]

    def _walker_features(self, model: Model, data: Data) -> dict:
        """The walker's features, batch-leading (B, ...)."""
        w = self.walker
        r = w.root_body_id
        return dict(
            position=data.xpos[r].T, quaternion=data.xquat[r].T,
            joints=data.qpos[model.ix(w.joint_qposadr)].T,
            joints_velocity=data.qvel[model.ix(w.joint_dofadr)].T,
            body_positions=data.xpos.permute(2, 0, 1),
            body_quaternions=data.xquat.permute(2, 0, 1),
            appendages=w.appendages_pos(data).reshape(
                data.qpos.shape[-1], -1, 3),
            center_of_mass=data.subtree_com[r].T)

    def observations(self, model: Model, data: Data, ts,
                     sensor_mean) -> dict:
        obs = self.walker.observables(model, data, sensor_mean)
        wf = self._walker_features(model, data)
        B, bi = data.qpos.shape[-1], self._body_ix
        ref = lambda k: self._ref(k, ts, self._offsets)      # (B, K, ...)
        conj = mq.conj_quat(wf["quaternion"])[:, None]         # (B, 1, 4)
        rq = ref("quaternion")                                 # (B, K, 4)
        bp = ref("body_positions")[:, :, bi]
        diff = bp - wf["body_positions"][:, None, bi]
        bq = ref("body_quaternions")[:, :, bi]
        flat = lambda x: x.reshape(B, -1)
        obs.update({
            "ref_rel_joints": flat(ref("joints") - wf["joints"][:, None]),
            "ref_rel_bodies_pos_local": flat(
                mq.rotate_vec_with_quat(diff, conj[:, :, None])),
            "ref_rel_root_quat": flat(mq.mult_quat(conj, rq)),
            "ref_ego_bodies_quats": flat(
                mq.mult_quat(mq.conj_quat(rq)[:, :, None], bq)),
            "ref_appendages_pos": flat(ref("appendages")),
            "clip_id": ts["clip"].to(torch.float32)[:, None],
        })
        return obs

    def _termination_error(self, wf, ts):
        bi = self._body_ix
        err_j = torch.mean(torch.abs(self._ref_now("joints", ts)
                                     - wf["joints"]), dim=1)
        tb = self._ref_now("body_positions", ts)[:, bi]
        err_b = torch.mean(torch.abs(tb - wf["body_positions"][:, bi]),
                           dim=(1, 2))
        return 0.5 * self.body_error_multiplier * err_b + 0.5 * err_j

    def _reward(self, model: Model, data: Data, ts):
        """-> (reward (B,), channels, termination error (B,))."""
        wf = self._walker_features(model, data)
        now = lambda k: self._ref_now(k, ts)
        keys = ("joints", "joints_velocity", "body_quaternions",
                "appendages")
        ref = {k: now(k) for k in keys}
        ref["center_of_mass"] = now("position")
        walker = {k: wf[k] for k in keys + ("center_of_mass",)}
        err = self._termination_error(wf, ts)
        reward, channels = tr.get_reward(self.reward_key)(
            termination_error=err,
            termination_error_threshold=self.termination_error_threshold,
            walker_features=walker, reference_features=ref,
            tuning=self.tuning)
        return reward, channels, err

    def reward_term_discount(self, model: Model, data: Data, ts,
                             sensor_mean):
        reward, _, err = self._reward(model, data, ts)
        fatal = ((err > self.termination_error_threshold)
                 | (torch.linalg.vector_norm(data.qacc, dim=0) > 1e14)
                 | torch.any(torch.isnan(data.qpos), dim=0))
        end_clip = (ts["start"] + ts["step"] + max(self.ref_steps)
                    >= self.clips.lengths[ts["clip"]])
        discount = torch.where(fatal, torch.zeros_like(reward),
                               torch.ones_like(reward))
        return reward, fatal | end_clip, discount

    def reward_factors(self, model: Model, data: Data, ts,
                       sensor_mean) -> dict:
        """The reward's channels, each (B,), in the reward's order
        (``tracking_rewards.get_reward_channels``)."""
        channels = self._reward(model, data, ts)[1]
        return {k: channels[k] for k in self.reward_channels_spec()}

    def reward_channels_spec(self):
        return tr.get_reward_channels(self.reward_key)


def synthetic_clips(model: Model, walker, num_clips: int = 3,
                    length: int = 120, timestep: float = 0.02,
                    seed: int = 0) -> ClipCollection:
    """Standing / slow-walking synthetic clips, numpy from ``seed`` (the
    JAX package's, bit for bit), for standalone runs and tests (the
    reference ships no mocap data)."""
    rng = np.random.RandomState(seed)
    qpos0 = model.qpos0.detach().cpu().numpy()
    qpos = np.tile(qpos0[None, None], (num_clips, length, 1)).astype(
        np.float32)
    qvel = np.zeros((num_clips, length, model.nv), np.float32)
    t = np.arange(length) * timestep
    jadr = np.asarray(walker.joint_qposadr)
    dadr = np.asarray(walker.joint_dofadr)
    for i in range(num_clips):
        v = 0.1 + 0.1 * i
        qpos[i, :, 0] += v * t
        qvel[i, :, 0] = v
        phase = 2 * np.pi * 2.0 * t[:, None] + rng.uniform(
            0, 2 * np.pi, (1, len(jadr)))
        qpos[i][:, jadr] = qpos[i][:, jadr] + 0.03 * np.sin(phase)
        qvel[i][:, dadr] = 0.03 * 2 * np.pi * 2.0 * np.cos(phase)
    lengths = np.full(num_clips, length, np.int32)
    return build_clip_features(model, walker, qpos, qvel, lengths, timestep)
