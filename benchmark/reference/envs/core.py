"""Batched RL environment core: a state machine over a batch of envs.

    env = FlyEnv(model, task)
    state = env.reset(B)                       # batched EnvState
    state = env.autoreset_step(state, action)  # action (B, act_dim)

* The physics substeps run on the batch-native engine (trailing env axis).
* Task hooks are batched functions of the whole batch; observations come
  out batch-leading (B, dim).
* Auto-reset swaps only the true dynamical state (types.STATE_FIELDS)
  where an episode ended; derived quantities are recomputed by the next
  step.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from benchmark.reference.physics import forward as F
from benchmark.reference.physics import io_mj
from benchmark.reference.physics import types as T
from benchmark.reference.physics.types import Data, Model


@dataclasses.dataclass
class EnvState:
    data: Data            # batch-native (trailing B)
    obs: dict             # {name: (B, ...)}
    reward: torch.Tensor  # (B,)
    done: torch.Tensor    # (B,) bool
    discount: torch.Tensor  # (B,)
    step_idx: torch.Tensor  # (B,) int32 control steps since episode start
    rng: torch.Generator | None
    task_state: Any       # task-specific, trailing B
    metrics: dict         # per-step diagnostics, (B,)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


class Task:
    """Task protocol: batched hooks over (model, Data with trailing B)."""

    ctrl_dt: float = 2e-3
    phys_dt: float = 2e-4
    time_limit: float = 1.0
    # True when init_state ignores the generator: auto-reset then builds
    # one fresh state at B=1 and broadcasts it
    deterministic_init: bool = False
    # True when reward_step draws: the env then passes its generator as
    # ``reward_step(..., generator=state.rng)``
    step_draws: bool = False

    def init_state(self, model: Model, data: Data, generator):
        """Episode-initial qpos/qvel and task state for the batch."""
        return data, ()

    def before_step(self, model: Model, data: Data, task_state, action):
        """Map the env action (B, A) to ctrl."""
        return data.replace(ctrl=action.T), task_state

    def after_substeps(self, model: Model, data: Data, task_state):
        return data, task_state

    def observations(self, model: Model, data: Data, task_state,
                     sensor_mean) -> dict:
        raise NotImplementedError

    def reward_term_discount(self, model: Model, data: Data, task_state,
                             sensor_mean):
        """-> (reward (B,), terminated (B,) bool, discount (B,))."""
        raise NotImplementedError

    def reward_step(self, model: Model, data: Data, task_state,
                    sensor_mean):
        r, t, d = self.reward_term_discount(model, data, task_state,
                                            sensor_mean)
        return r, t, d, task_state

    def reward_factors(self, model: Model, data: Data, task_state,
                       sensor_mean) -> dict:
        """Named per-step reward channels, each (B,), for the evaluator's
        reward-decomposition plots (reference utils.py
        render_with_rewards). Default: the scalar reward."""
        r, _, _ = self.reward_term_discount(model, data, task_state,
                                            sensor_mean)
        return {"reward": r}


def _map(fn, *trees):
    """Apply fn leaf-wise over matching dicts / tuples / dataclasses /
    tensors."""
    t0 = trees[0]
    if dataclasses.is_dataclass(t0):
        return dataclasses.replace(t0, **{
            f.name: _map(fn, *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(t0)})
    if isinstance(t0, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _scrub(x):
    """Non-finite -> 0, then clamp to +-1e8 (env-boundary NaN hygiene)."""
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    return torch.clamp(x, -1e8, 1e8)


class FlyEnv:
    """Batched environment: physics engine + a Task."""

    def __init__(self, model: Model, task: Task, dtype=torch.float32):
        self.model = model
        model.opt.timestep = torch.as_tensor(task.phys_dt, dtype=dtype,
                                             device=model.device)
        self.task = task
        self.n_substeps = int(round(task.ctrl_dt / task.phys_dt))
        self.episode_steps = int(round(task.time_limit / task.ctrl_dt))
        self.dtype = dtype
        r = int(model.col_refresh or 1)
        if r > 1 and self.n_substeps % r != 0:
            raise ValueError(
                f"col_refresh={r} must divide substeps-per-control-step "
                f"({self.n_substeps}) so auto-reset lands on a selection "
                "refresh")

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def action_size(self) -> int:
        return getattr(self.task, "action_size", self.model.nu)

    def action_spec(self):
        lo, hi = self.task.action_bounds(self.model)
        return np.asarray(lo), np.asarray(hi)

    def reset(self, B: int, generator: torch.Generator | None = None,
              **init_kw):
        """Batched EnvState of B fresh episodes; ``init_kw`` goes to the
        task's ``init_state`` (e.g. walk_imitation's ``traj_idx``)."""
        data = io_mj.make_data(self.model, B=B, dtype=self.dtype)
        data, task_state = self.task.init_state(self.model, data, generator,
                                                **init_kw)
        data = F.fwd_position(self.model, data)
        data = F.fwd_velocity(self.model, data)
        obs = self.task.observations(self.model, data, task_state,
                                     data.sensordata)
        zero = torch.zeros((B,), dtype=self.dtype, device=self.device)
        return EnvState(
            data=data, obs=obs, reward=zero,
            done=torch.zeros((B,), dtype=torch.bool, device=self.device),
            discount=torch.ones((B,), dtype=self.dtype, device=self.device),
            step_idx=torch.zeros((B,), dtype=torch.int32,
                                 device=self.device),
            rng=generator, task_state=task_state,
            metrics={"episode_return": zero})

    def step(self, state: EnvState, action: torch.Tensor) -> EnvState:
        model, task = self.model, self.task
        # NaN-action scrub before physics: a diverged actor cannot poison
        # the physics state
        action = torch.where(torch.isnan(action), torch.zeros_like(action),
                             action)
        data, task_state = task.before_step(model, state.data,
                                            state.task_state, action)
        # selection-persistent collision schedule: substep 0 of each
        # col_refresh block runs the full selection, the other r-1 refresh
        # geometry for the same lanes; r divides n_substeps
        r = int(model.col_refresh or 1)
        sensors = []
        for k in range(self.n_substeps):
            data = F.step(model, data, col_update=(r > 1 and k % r != 0))
            sensors.append(data.sensordata)
        sensor_mean = torch.stack(sensors).mean(dim=0)
        data, task_state = task.after_substeps(model, data, task_state)
        draws = {"generator": state.rng} if task.step_draws else {}
        reward, terminated, discount, task_state = task.reward_step(
            model, data, task_state, sensor_mean, **draws)
        # observations see the post-reward task state
        obs = task.observations(model, data, task_state, sensor_mean)
        # NaN hygiene at the env boundary: a blown-up episode terminates
        # with discount 0, and its terminal observation is scrubbed so
        # consumers never see non-finite or absurd values
        obs = _map(_scrub, obs)
        reward = _scrub(reward).to(self.dtype)
        discount = torch.clamp(torch.where(torch.isfinite(discount),
                                           discount,
                                           torch.zeros_like(discount)),
                               0.0, 1.0).to(self.dtype)
        step_idx = state.step_idx + 1
        done = terminated | (step_idx >= self.episode_steps)
        return EnvState(
            data=data, obs=obs, reward=reward, done=done, discount=discount,
            step_idx=step_idx, rng=state.rng, task_state=task_state,
            metrics={"episode_return":
                     state.metrics["episode_return"] + reward})

    def autoreset_step(self, state: EnvState, action) -> EnvState:
        """step() + apply_autoreset (batched lockstep rollouts)."""
        return self.apply_autoreset(self.step(state, action))

    def apply_autoreset(self, state: EnvState) -> EnvState:
        """Per-env episode reset where done. Only types.STATE_FIELDS are
        swapped; the terminal step's reward/done/discount stay visible.
        Tasks with deterministic_init build the fresh state at B=1 and
        broadcast it."""
        B = state.done.shape[0]
        if self.task.deterministic_init:
            fresh = self.reset(1, state.rng)
        else:
            fresh = self.reset(B, state.rng)
        done = state.done

        def swap_tail(new, old):
            return torch.where(done, new, old)

        def swap_lead(new, old):
            return torch.where(done.reshape((-1,) + (1,) * (old.ndim - 1)),
                               new, old)

        data = state.data.replace(**{
            f: swap_tail(getattr(fresh.data, f), getattr(state.data, f))
            for f in T.STATE_FIELDS})
        return EnvState(
            data=data, obs=_map(swap_lead, fresh.obs, state.obs),
            reward=state.reward, done=state.done, discount=state.discount,
            step_idx=swap_lead(fresh.step_idx, state.step_idx),
            rng=state.rng,
            task_state=_map(swap_tail, fresh.task_state, state.task_state),
            metrics=_map(swap_lead, fresh.metrics, state.metrics))
