"""The sine-trench terrain of vision_guided_flight, in numpy (reference
vnl_ray/tasks/arenas/hills.py, add_sine_trench :82-128): a trench
wandering as a sine through a raised plateau, its phase one draw from
``RandomState(0)``, its width three 0.604 cm wingspans (:341-343).

The heightfield itself is in the committed model; the reference reads the
trench's centreline from here for the reward.
"""

from __future__ import annotations

import dataclasses

import numpy as np

WINGSPAN = 0.604  # cm


@dataclasses.dataclass
class TrenchSpecs:
    center_y: np.ndarray   # (ncol,) centreline per x-column, normalized y
    width: np.ndarray      # (ncol,)
    depth: float


def sine_trench(nrow: int = 100, ncol: int = 400, n_periods: float = 4.0,
                width_factor: float = 3.0, amplitude_factor: float = 2.0,
                rng: np.random.RandomState | None = None
                ) -> tuple[np.ndarray, TrenchSpecs]:
    """(heightfield (nrow, ncol) float32 in [0, 1], TrenchSpecs): 1 on the
    plateau, 0 in the trench."""
    rng = rng or np.random.RandomState(0)
    ys = np.linspace(-1.0, 1.0, nrow)
    xs = np.linspace(0, 2 * np.pi * n_periods, ncol)
    center = amplitude_factor * WINGSPAN / 10.0 * np.sin(
        xs + rng.uniform(0, 2 * np.pi))
    width = np.full(ncol, width_factor * WINGSPAN / 10.0, np.float32)
    inside = np.abs(ys[:, None] - center[None, :]) < width[None, :] / 2
    data = np.where(inside, 0.0, 1.0).astype(np.float32)
    return data, TrenchSpecs(center_y=center.astype(np.float32),
                             width=width, depth=1.0)
