"""Rodent and humanoid environment factories (reference
vnl_ray/tasks/basic_rodent_2020.py).

Each factory returns a batched ``FlyEnv`` of the dm_control rat over its
arena, or of the CMU humanoid on a floor, on a CUDA device unless the
caller names another device (and raising if CUDA is asked for and
absent):

    env = rodent_run_gaps()                 # cuda
    env = rodent_two_touch(device="cpu")    # the CPU, when asked for
    state = env.reset(4096, torch.Generator("cuda").manual_seed(0))
    state = env.autoreset_step(state, actions)

The model is the committed ``models/assets/rodent_<arena>_model.npz``
(``humanoid_floor_model.npz``); ``seed`` draws the arena's heights (and
the maze's cells), written into that model, with no mujoco needed. The
two tracking factories, ``rodent_walk_imitation`` and ``walk_humanoid``,
track the synthetic clips of ``tasks/tracking.py`` unless ``ref_path``
names an HDF5 clip file (h5py needed).
"""

from __future__ import annotations

import torch

from flybody_tpu_torch.envs.core import FlyEnv
from flybody_tpu_torch.envs.humanoid_walker import HumanoidWalker
from flybody_tpu_torch.envs.rodent_walker import RodentWalker
from flybody_tpu_torch.fly_envs import default_device
from flybody_tpu_torch.models import rodent as rm
from flybody_tpu_torch.tasks import rodent_tasks as rt
from flybody_tpu_torch.tasks import tracking as trk

# The JAX package's engine budgets of every rodent env: the rat stands on
# <= 8 ground contacts with a handful of condim-1 self contacts; the fused
# solver takes the top 16 limit rows (67 limited joints, few near their
# limits at once) and the top 24 cones, so R = 16 + 8 + 3 x 24 = 96; the
# rat's 1515 convex candidate pairs gate to 64 lanes per env; one contact
# selection per 10 substeps (20 substeps per control step).
PUT_MODEL_KW = dict(con_sel={1: 8, 3: 24}, contact_solver="fused",
                    fused_sel=(16, 24), ccd_budget=64, col_refresh=10)
# the humanoid's: the same, with a contact selection every 3 substeps (6
# substeps of 5 ms per control step)
HUMANOID_PUT_MODEL_KW = {**PUT_MODEL_KW, "col_refresh": 3}


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


def _clips(model, walker, ref_path, num_clips):
    if ref_path is None:
        return trk.synthetic_clips(model, walker, num_clips=num_clips,
                                   length=120)
    return trk.load_hdf5_clips(model, walker, ref_path)


def rodent_walk_imitation(device=None, ref_path: str | None = None,
                          termination_error_threshold: float = 0.12,
                          time_limit: float = 10.0, dtype=torch.float32):
    """Multi-clip rodent mocap tracking (reference
    basic_rodent_2020.py:225-283 and tracking_old.py
    MultiClipMocapTracking) on the foot-mods rat; synthetic walking clips
    (3 of 120 frames) unless ``ref_path`` names a clip file."""
    model, _ = rm.make_rodent_model("imitation", default_device(device),
                                    dtype=dtype, **PUT_MODEL_KW)
    walker = RodentWalker(model)
    task = trk.MultiClipTracking(
        walker, _clips(model, walker, ref_path, 3), ref_steps=(1, 2, 3, 4, 5),
        termination_error_threshold=termination_error_threshold,
        reward_key="comic", tuning="rodent", min_steps=1,
        time_limit=time_limit, ctrl_dt=0.02, phys_dt=0.001)
    return FlyEnv(model, task, dtype=dtype)


def walk_humanoid(device=None, ref_path: str | None = None,
                  termination_error_threshold: float = 0.3,
                  time_limit: float = 10.0, dtype=torch.float32):
    """CMU humanoid multi-clip mocap tracking (reference
    basic_rodent_2020.py:286-337); synthetic clips (2 of 120 frames)
    unless ``ref_path`` names a clip file."""
    model = rm.make_humanoid_model(default_device(device), dtype=dtype,
                                   **HUMANOID_PUT_MODEL_KW)
    walker = HumanoidWalker(model)
    task = trk.MultiClipTracking(
        walker, _clips(model, walker, ref_path, 2), ref_steps=(1, 2, 3, 4, 5),
        termination_error_threshold=termination_error_threshold,
        reward_key="comic", tuning="fly", min_steps=1,
        time_limit=time_limit, ctrl_dt=0.03, phys_dt=0.005)
    return FlyEnv(model, task, dtype=dtype)
