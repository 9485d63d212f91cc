"""Rodent arenas: bowl, gaps corridor, maze and floor.

The dm_control arenas of the reference rodent suite (reference
vnl_ray/tasks/basic_rodent_2020.py: bowl.Bowl, corr_arenas.GapsCorridor,
mazes.RandomMazeWithTargets, floors.Floor) plus the fly bowl terrain
(reference vnl_ray/tasks/arenas/hills.py:18-58 terrain_bowl), each drawn
from a seed with numpy (and scipy for the bowl's zoom).

Every arena is one static heightfield geom (or a plane) baked into the
model when it is built; what varies per episode (maze spawn and target
cells, the corridor's spawn) is data the task draws from these tables.
The heights are the JAX package's bit for bit from the same seed, so a
committed asset of one seed takes another seed's heights in place
(``models/rodent.make_rodent_model``).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ArenaMeta:
    """Static arena metadata consumed by tasks."""
    kind: str
    hfield_data: np.ndarray | None = None     # (nrow, ncol) in [0, 1]
    hfield_size: tuple | None = None          # (x, y, z_top, z_base)
    hfield_pos: tuple = (0.0, 0.0, 0.0)
    spawn_positions: np.ndarray | None = None  # (S, 2) xy
    target_positions: np.ndarray | None = None  # (G, 2) xy candidate cells
    size: tuple = (10.0, 10.0)


def terrain_bowl(nrow: int = 101, bump_scale: float = 2.0,
                 elevation_z: float = 4.0, tanh_rel_radius: float = 0.7,
                 tanh_sharpness: float = 8.0, size: float = 20.0,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
    """Bowl-shaped terrain: random bumps masked by a tanh rim
    (reference hills.py:18-58 numerical recipe; also the shape of
    dm_control bowl.Bowl for the rodent escape task)."""
    from scipy import ndimage

    rng = rng or np.random.RandomState(0)
    bump_res = max(int(2 * size / bump_scale), 2)
    bumps = rng.uniform(0, 1, (bump_res, bump_res))
    terrain = ndimage.zoom(bumps, nrow / float(bump_res))[:nrow, :nrow]
    if terrain.shape[0] < nrow:  # zoom rounding
        pad = nrow - terrain.shape[0]
        terrain = np.pad(terrain, ((0, pad), (0, pad)), mode="edge")
    terrain = terrain[:nrow, :nrow]
    terrain -= terrain.min()
    terrain /= max(terrain.max(), 1e-9)
    terrain *= elevation_z
    axis = np.linspace(-1, 1, nrow)
    xv, yv = np.meshgrid(axis, axis)
    r = np.sqrt(xv ** 2 + yv ** 2)
    bowl_shape = 0.5 * np.tanh(tanh_sharpness * (r - tanh_rel_radius)) + 0.5
    return (terrain * bowl_shape).astype(np.float32)


def bowl_arena(size: float = 20.0, elevation_z: float = 0.5,
               seed: int = 0) -> ArenaMeta:
    """Bowl escape arena (reference basic_rodent_2020.py:66 — Bowl
    size (20, 20)). Heights normalized to [0, 1]; z scale in hfield_size."""
    data = terrain_bowl(size=size, elevation_z=1.0,
                        rng=np.random.RandomState(seed))
    return ArenaMeta(kind="bowl", hfield_data=data,
                     hfield_size=(size, size, elevation_z, 0.1),
                     size=(size, size))


def gaps_corridor(corridor_length: float = 40.0, corridor_width: float = 2.0,
                  platform_length=(0.4, 0.8), gap_length=(0.05, 0.2),
                  depth: float = 0.5, cell: float = 0.025,
                  seed: int = 0) -> ArenaMeta:
    """Corridor with gaps (reference basic_rodent_2020.py:92-99:
    GapsCorridor platform U(0.4, 0.8), gap U(0.05, 0.2), width 2,
    length 40). One fixed draw is baked per build; the task randomizes
    the spawn x offset instead of the geometry."""
    rng = np.random.RandomState(seed)
    ncol = int(corridor_length / cell)
    nrow = int(corridor_width / cell)
    data = np.ones((nrow, ncol), np.float32)
    # first 2 m are solid ground (the reference corridor's start platform)
    x = 2.0
    while x < corridor_length:
        plat = rng.uniform(*platform_length)
        gap = rng.uniform(*gap_length)
        a = int((x + plat) / cell)
        b = int((x + plat + gap) / cell)
        data[:, a:min(b, ncol)] = 0.0
        x += plat + gap
    return ArenaMeta(
        kind="gaps", hfield_data=data,
        # platform top at z=0: z_top = depth, geom sits at -depth
        hfield_size=(corridor_length / 2, corridor_width / 2, depth, 0.1),
        hfield_pos=(corridor_length / 2, 0.0, -depth),
        size=(corridor_length, corridor_width))


def random_maze(x_cells: int = 11, y_cells: int = 11, xy_scale: float = 0.5,
                z_height: float = 0.3, max_rooms: int = 4,
                room_min_size: int = 4, room_max_size: int = 5,
                spawns_per_room: int = 1, targets_per_room: int = 3,
                cells_per_unit: int = 6, seed: int = 0) -> ArenaMeta:
    """Random maze with rooms, spawn and target cells (reference
    basic_rodent_2020.py:131-146: RandomMazeWithTargets 11x11 cells,
    xy_scale 0.5, 4 rooms of 4-5 cells, 1 spawn + 3 targets per room).

    Walls are heightfield cells of height z_height. Room placement uses
    a simple non-overlapping rectangle sampler + corridor connections —
    an original generator with labmaze-like statistics (not a labmaze
    port)."""
    rng = np.random.RandomState(seed)
    grid = np.zeros((y_cells, x_cells), bool)  # True = open
    rooms = []
    for _ in range(200):
        if len(rooms) >= max_rooms:
            break
        w = rng.randint(room_min_size, room_max_size + 1)
        h = rng.randint(room_min_size, room_max_size + 1)
        x0 = rng.randint(1, max(x_cells - w - 1, 2))
        y0 = rng.randint(1, max(y_cells - h - 1, 2))
        rect = (x0, y0, w, h)
        if any(abs(x0 - r[0]) < w + 1 and abs(y0 - r[1]) < h + 1
               for r in rooms):
            continue
        rooms.append(rect)
        grid[y0:y0 + h, x0:x0 + w] = True
    # connect room centers with L-corridors
    centers = [(x0 + w // 2, y0 + h // 2) for x0, y0, w, h in rooms]
    for (xa, ya), (xb, yb) in zip(centers[:-1], centers[1:]):
        grid[ya, min(xa, xb):max(xa, xb) + 1] = True
        grid[min(ya, yb):max(ya, yb) + 1, xb] = True

    spawns, targets = [], []
    for x0, y0, w, h in rooms:
        open_cells = [(x, y) for y in range(y0, y0 + h)
                      for x in range(x0, x0 + w)]
        rng.shuffle(open_cells)
        spawns.extend(open_cells[:spawns_per_room])
        targets.extend(open_cells[spawns_per_room:
                                  spawns_per_room + targets_per_room])

    def cell_to_xy(cells):
        c = np.asarray(cells, np.float32)
        return np.stack([(c[:, 0] - x_cells / 2 + 0.5) * xy_scale,
                         (c[:, 1] - y_cells / 2 + 0.5) * xy_scale], axis=-1)

    # rasterize walls to the heightfield: 1 where wall, 0 where open
    rep = cells_per_unit
    data = np.kron(~grid, np.ones((rep, rep))).astype(np.float32)
    half_x = x_cells * xy_scale / 2
    half_y = y_cells * xy_scale / 2
    return ArenaMeta(
        kind="maze", hfield_data=data,
        hfield_size=(half_x, half_y, z_height, 0.05),
        spawn_positions=cell_to_xy(spawns),
        target_positions=cell_to_xy(targets),
        size=(half_x, half_y))


def floor_arena(size=(10.0, 10.0)) -> ArenaMeta:
    """Flat floor (dm_control floors.Floor analog)."""
    return ArenaMeta(kind="floor", size=tuple(size))
