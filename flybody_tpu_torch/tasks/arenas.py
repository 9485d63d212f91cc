"""Procedural terrain arenas: sine bumps, sine trench, random hills.

The terrains are numpy heightfields fed to MuJoCo at model build (reference
vnl_ray/tasks/arenas/hills.py: terrain_bowl :18-58, add_sine_bumps :61,
add_sine_trench :82-128). The trench keeps the reference's width rule
against the 0.604 cm wingspan (:341-343). Only ``add_heightfield`` needs
mujoco; the terrains themselves are numpy, so the env builds without it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WINGSPAN = 0.604  # cm, reference hills.py:341


@dataclasses.dataclass
class TrenchSpecs:
    """Geometry of the generated trench (reference SineTrench.trench_specs)."""
    center_y: np.ndarray   # (ncol,) trench centerline per x-column
    width: np.ndarray      # (ncol,)
    depth: float


def sine_bumps(nrow: int = 100, ncol: int = 400, n_periods: float = 8.0,
               height: float = 1.0, rng: np.random.RandomState | None = None
               ) -> np.ndarray:
    """Sine bumps along x, uniform along y; normalized [0, 1]."""
    x = np.linspace(0, 2 * np.pi * n_periods, ncol)
    profile = 0.5 * (1.0 + np.sin(x))
    data = np.tile(profile, (nrow, 1))
    return (data * height).astype(np.float32)


def sine_trench(nrow: int = 100, ncol: int = 400, n_periods: float = 4.0,
                width_factor: float = 3.0, amplitude_factor: float = 2.0,
                rng: np.random.RandomState | None = None
                ) -> tuple[np.ndarray, TrenchSpecs]:
    """A trench wandering as a sine through a raised plateau; its phase is
    one draw from ``rng`` (``RandomState(0)`` by default). A width of
    width_factor wingspans keeps it passable."""
    rng = rng or np.random.RandomState(0)
    data = np.ones((nrow, ncol), np.float32)
    ys = np.linspace(-1.0, 1.0, nrow)
    xs = np.linspace(0, 2 * np.pi * n_periods, ncol)
    # the centerline in normalized y units
    amp = amplitude_factor * WINGSPAN / 10.0
    center = amp * np.sin(xs + rng.uniform(0, 2 * np.pi))
    width = np.full(ncol, width_factor * WINGSPAN / 10.0, np.float32)
    for c in range(ncol):
        mask = np.abs(ys - center[c]) < width[c] / 2
        data[mask, c] = 0.0
    return data, TrenchSpecs(center_y=center.astype(np.float32),
                             width=width, depth=1.0)


def random_hills(nrow: int = 128, ncol: int = 128, n_bumps: int = 40,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
    """Random smooth bumps (reference terrain_bowl :18-58, without the
    bowl); normalized [0, 1]."""
    rng = rng or np.random.RandomState(0)
    data = np.zeros((nrow, ncol), np.float32)
    yy, xx = np.mgrid[0:nrow, 0:ncol]
    for _ in range(n_bumps):
        cy, cx = rng.uniform(0, nrow), rng.uniform(0, ncol)
        s = rng.uniform(3, 12)
        a = rng.uniform(0.2, 1.0)
        data += a * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * s * s))
    data -= data.min()
    data /= max(data.max(), 1e-9)
    return data.astype(np.float32)


def add_heightfield(spec, data: np.ndarray, size=(12.0, 3.0, 0.6, 0.1),
                    pos=(8.0, 0.0, 0.0), name: str = "terrain"):
    """Attach a heightfield geom to the worldbody of ``spec`` (an
    ``mujoco.MjSpec``)."""
    import mujoco
    nrow, ncol = data.shape
    hf = spec.add_hfield(name=name, size=list(size), nrow=nrow, ncol=ncol,
                         userdata=data.reshape(-1).astype(np.float64))
    spec.worldbody.add_geom(name=name, type=mujoco.mjtGeom.mjGEOM_HFIELD,
                            hfieldname=name, pos=list(pos), condim=3)
    return hf
