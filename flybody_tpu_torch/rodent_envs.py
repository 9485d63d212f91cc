"""Rodent environment factories (reference
vnl_ray/tasks/basic_rodent_2020.py).

Each factory returns a batched ``FlyEnv`` of the dm_control rat over its
arena, on a CUDA device unless the caller names another device (and
raising if CUDA is asked for and absent):

    env = rodent_run_gaps()                 # cuda
    env = rodent_two_touch(device="cpu")    # the CPU, when asked for
    state = env.reset(4096, torch.Generator("cuda").manual_seed(0))
    state = env.autoreset_step(state, actions)

The model is the committed ``models/assets/rodent_<arena>_model.npz``;
``seed`` draws the arena's heights (and the maze's cells), written into
that model, with no mujoco needed.
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.envs.core import FlyEnv
from flybody_tpu_torch.envs.rodent_walker import RodentWalker
from flybody_tpu_torch.fly_envs import default_device
from flybody_tpu_torch.models import rodent as rm
from flybody_tpu_torch.tasks import rodent_tasks as rt

# The JAX package's engine budgets of every rodent env: the rat stands on
# <= 8 ground contacts with a handful of condim-1 self contacts; the fused
# solver takes the top 16 limit rows (67 limited joints, few near their
# limits at once) and the top 24 cones, so R = 16 + 8 + 3 x 24 = 96; the
# rat's 1515 convex candidate pairs gate to 64 lanes per env; one contact
# selection per 10 substeps (20 substeps per control step).
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 24}, contact_solver="fused",
                    fused_sel=(16, 24), ccd_budget=64, col_refresh=10)


def _env(kind, device, dtype, seed, make_task) -> FlyEnv:
    model, arena = rm.make_rodent_model(kind, default_device(device),
                                        dtype=dtype, seed=seed,
                                        **PUT_MODEL_KW)
    return FlyEnv(model, make_task(RodentWalker(model), arena), dtype=dtype)


def rodent_escape_bowl(device=None, time_limit: float = 20.0,
                       dtype=torch.float32, seed: int = 0,
                       use_vision: bool = False):
    """Climb out of a bowl-shaped terrain (reference
    basic_rodent_2020.py:60-83)."""
    return _env("bowl", device, dtype, seed, lambda w, a: rt.EscapeBowl(
        w, terrain_size=20.0, time_limit=time_limit, use_vision=use_vision))


def rodent_run_gaps(device=None, time_limit: float = 30.0,
                    contact_termination: bool = True, dtype=torch.float32,
                    seed: int = 0, use_vision: bool = False):
    """Run down a corridor with gaps (reference
    basic_rodent_2020.py:86-121)."""
    return _env("gaps", device, dtype, seed,
                lambda w, a: rt.RunThroughCorridor(
                    w, spawn_position=(5.0, 0.0), target_velocity=1.0,
                    contact_termination=contact_termination,
                    terminate_at_height=-0.3, time_limit=time_limit,
                    use_vision=use_vision))


def rodent_maze_forage(device=None, time_limit: float = 30.0,
                       dtype=torch.float32, seed: int = 0,
                       use_vision: bool = False):
    """Find every target in a maze (reference
    basic_rodent_2020.py:124-185)."""
    return _env("maze", device, dtype, seed, lambda w, a: rt.ManyGoalsMaze(
        w, spawn_positions=a.spawn_positions,
        target_positions=a.target_positions, target_reward_scale=50.0,
        time_limit=time_limit, use_vision=use_vision))


def rodent_two_touch(device=None, time_limit: float = 30.0,
                     dtype=torch.float32, use_vision: bool = False):
    """Tap an orb, wait an interval, tap it again (reference
    basic_rodent_2020.py:188-222)."""
    return _env("floor", device, dtype, 0, lambda w, a: rt.TwoTouch(
        w, target_area=(1.5, 1.5), target_type_reward=25.0,
        time_limit=time_limit, use_vision=use_vision))


def rodent_walk_imitation(*args, **kwargs):
    """Multi-clip rodent mocap tracking: not ported yet."""
    raise NotImplementedError(
        "rodent_walk_imitation is not ported yet (ROADMAP A7c: tracking "
        "and the humanoid)")


def walk_humanoid(*args, **kwargs):
    """CMU humanoid mocap tracking: not ported yet."""
    raise NotImplementedError(
        "walk_humanoid is not ported yet (ROADMAP A7c: tracking and the "
        "humanoid)")
