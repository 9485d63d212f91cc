"""The dm_control rat over the rodent arenas and the CMU humanoid on a
floor, as committed assets.

The reference's rodent tasks use the dm_control rodent walker and its
walk_humanoid the CMU humanoid (reference
vnl_ray/tasks/basic_rodent_2020.py:63-337). Their MJCFs ship with the
installed dm_control package, so each model is compiled where mujoco and
dm_control exist, over one arena of ``tasks/rodent_arenas.py`` (a plane or
one static heightfield), and its fields are committed as
``models/assets/rodent_<kind>_model.npz`` (seed 0, the spawn frame of the
kind's task; the "imitation" kind is the floor with dm_control's
``foot_mods``, which changes the rat's joint ranges) and
``models/assets/humanoid_floor_model.npz``:

    python -m benchmark.reference.models.rodent     # rewrites all six

The card side reads only those files (numpy): ``make_rodent_model(kind,
device, dtype, seed)`` puts the rat's asset on the device, writing another
seed's heights into its heightfield first (the heights are all that a
seed changes in the compiled model); ``make_humanoid_model(device,
dtype)`` puts the humanoid's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.reference.tasks import rodent_arenas as ra

_ASSETS = os.path.join(os.path.dirname(__file__), "assets")

# each kind's arena from a seed and the rat's spawn frame (the JAX
# package's rodent_envs factories)
ARENAS = {
    "floor": (lambda seed: ra.floor_arena(size=(10.0, 10.0)),
              (0.0, 0.0, 0.06)),
    "bowl": (lambda seed: ra.bowl_arena(size=20.0, seed=seed),
             (0.0, 0.0, 0.06)),
    "gaps": (lambda seed: ra.gaps_corridor(seed=seed), (5.0, 0.0, 0.06)),
    "maze": (lambda seed: ra.random_maze(seed=seed), (0.0, 0.0, 0.06)),
    # rodent_walk_imitation: the default floor, the rat with foot_mods
    "imitation": (lambda seed: ra.floor_arena(), (0.0, 0.0, 0.06)),
}
MODEL_PATHS = {k: os.path.join(_ASSETS, f"rodent_{k}_model.npz")
               for k in ARENAS}
HUMANOID_PATH = os.path.join(_ASSETS, "humanoid_floor_model.npz")


def _attach_arena(root, arena: ra.ArenaMeta) -> None:
    """Add the arena geometry (plane or heightfield) to an mjcf root."""
    if arena.hfield_data is None:
        root.worldbody.add("geom", name="floor", type="plane",
                           size=list(arena.size) + [0.1],
                           friction=[1.0, 0.005, 0.0001])
        return
    nrow, ncol = arena.hfield_data.shape
    hf = root.asset.add("hfield", name="terrain",
                        size=list(arena.hfield_size), nrow=nrow, ncol=ncol)
    root.worldbody.add("geom", name="terrain", type="hfield", hfield=hf,
                       pos=list(arena.hfield_pos))
    # a plane far below, where a fall through a gap lands
    root.worldbody.add("geom", name="floor", type="plane",
                       pos=[0, 0, -float(arena.hfield_size[2]) - 0.5],
                       size=[100.0, 100.0, 0.1])


def _compile(walker, name: str, arena: ra.ArenaMeta, spawn_pos):
    """The dm_control ``walker`` with its root at ``spawn_pos`` over
    ``arena``, compiled into an MjModel with its heightfield baked in."""
    from dm_control import mjcf

    root = mjcf.RootElement(model=name)
    _attach_arena(root, arena)
    spawn_frame = root.attach(walker.mjcf_model)
    spawn_frame.pos = list(spawn_pos)
    spawn_frame.add("freejoint")
    physics = mjcf.Physics.from_mjcf_model(root)
    m = physics.model._model
    if arena.hfield_data is not None:
        _write_heights(m.hfield_data, m.hfield_adr[0], arena.hfield_data)
    return m


def build_rodent_mj_model(arena: ra.ArenaMeta, spawn_pos,
                          foot_mods: bool = False):
    """Compile the dm_control rat (``foot_mods`` as dm_control's Rat takes
    it) with its root at ``spawn_pos`` over ``arena`` into an MjModel
    (needs mujoco and dm_control)."""
    os.environ.setdefault("MUJOCO_GL", "disabled")
    from dm_control.locomotion.walkers import rodent

    return _compile(rodent.Rat(foot_mods=foot_mods), "rodent_arena", arena,
                    spawn_pos)


def build_humanoid_mj_model():
    """Compile the CMU humanoid (the position-controlled 2020 variant)
    with its root at (0, 0, 1.2) over the default floor into an MjModel
    (needs mujoco and dm_control)."""
    os.environ.setdefault("MUJOCO_GL", "disabled")
    from dm_control.locomotion import walkers

    return _compile(walkers.CMUHumanoidPositionControlledV2020(),
                    "humanoid_arena", ra.floor_arena(), (0.0, 0.0, 1.2))


def _write_heights(flat, adr: int, heights: np.ndarray) -> None:
    """Heightfield 0's (nrow, ncol) heights into the flat ``hfield_data``
    at ``adr``, in place."""
    n = heights.size
    flat[adr:adr + n] = heights.reshape(-1).astype(np.float64)


def export_model(kind: str = "floor", path: str | None = "",
                 seed: int = 0) -> dict:
    """Build the ``kind`` arena's model from ``seed`` with mujoco and
    return the mapping ``put_model`` reads; write it to ``path`` (the
    committed asset with "", nowhere with None)."""
    from benchmark.reference.physics import io_mj
    arena_fn, spawn = ARENAS[kind]
    out = io_mj.export_mj(build_rodent_mj_model(
        arena_fn(seed), spawn, foot_mods=kind == "imitation"))
    if path is not None:
        np.savez_compressed(path or MODEL_PATHS[kind], **out)
    return out


def export_humanoid_model(path: str | None = "") -> dict:
    """The humanoid's model mapping built with mujoco; written to ``path``
    (the committed asset with "", nowhere with None)."""
    from benchmark.reference.physics import io_mj
    out = io_mj.export_mj(build_humanoid_mj_model())
    if path is not None:
        np.savez_compressed(path or HUMANOID_PATH, **out)
    return out


def _load(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def load_model(kind: str = "floor", seed: int = 0) -> dict:
    """The committed model mapping of ``kind`` (numpy only), with
    ``seed``'s heights written into its heightfield."""
    mj = _load(MODEL_PATHS[kind])
    arena = ARENAS[kind][0](seed)
    if seed != 0 and arena.hfield_data is not None:
        mj["hfield_data"] = mj["hfield_data"].copy()
        _write_heights(mj["hfield_data"], int(mj["hfield_adr"][0]),
                       arena.hfield_data)
    return mj


def make_rodent_model(kind: str, device, dtype=torch.float32, seed: int = 0,
                      **put_kw):
    """(engine Model on ``device``, the seed's ArenaMeta) of the rat over
    the ``kind`` arena; ``put_kw`` goes to ``io_mj.put_model`` (the
    env's contact budgets and solver)."""
    from benchmark.reference.physics import io_mj
    model = io_mj.put_model(load_model(kind, seed), device=device,
                            dtype=dtype, **put_kw)
    return model, ARENAS[kind][0](seed)


def load_humanoid_model() -> dict:
    """The humanoid's committed model mapping (numpy only)."""
    return _load(HUMANOID_PATH)


def make_humanoid_model(device, dtype=torch.float32, **put_kw):
    """The engine Model of the CMU humanoid on the floor, on ``device``;
    ``put_kw`` goes to ``io_mj.put_model``."""
    from benchmark.reference.physics import io_mj
    return io_mj.put_model(load_humanoid_model(), device=device,
                           dtype=dtype, **put_kw)


if __name__ == "__main__":
    for k in ARENAS:
        export_model(k)
        print("wrote", MODEL_PATHS[k])
    export_humanoid_model()
    print("wrote", HUMANOID_PATH)
