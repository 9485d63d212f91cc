"""Eye-camera rendering on the device: a heightfield and primitive raycaster.

The reference renders the fly's 32x32 eye cameras with EGL (reference
fruitfly.py:676-708). Here each pixel marches a ray against the terrain
heightfield and intersects it in closed form with the scene's primitive
geoms, and the nearest hit is shaded to an intensity. Exact parity with GL
output is not a goal; the information content (bearing and distance of
obstacles) is.

Every function is batched over leading env axes: a camera position
(..., 3), a rotation (..., 3, 3), ray directions (..., H, W, 3) and geom
frames (..., ngeom, 3) / (..., ngeom, 3, 3), batch-leading. ``render_eye``
renders a batch in chunks of envs, so that the march's (envs, H, W,
samples) temporaries stay a bounded size whatever the batch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.physics import types as T

_INF = 1e10
# envs per pass of render_eye: one pass of 32x32 eyes at 48 samples holds
# ~20 (chunk, 32, 32, 48) temporaries, ~4 GB in float32 at 1024 envs
RENDER_CHUNK = 1024


def camera_rays(fovy_deg: float, width: int, height: int,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """(H, W, 3) camera-frame unit ray directions (x right, y up, -z
    forward)."""
    tanv = np.tan(np.deg2rad(fovy_deg) / 2)
    aspect = width / height
    u = (2 * (np.arange(width) + 0.5) / width - 1) * tanv * aspect
    v = (1 - 2 * (np.arange(height) + 0.5) / height) * tanv
    uu, vv = np.meshgrid(u, v)
    d = np.stack([uu, vv, -np.ones_like(uu)], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return torch.as_tensor(d, device=device).to(dtype)


def hfield_height_fn(hfield_data: torch.Tensor, hfield_size, hfield_pos):
    """h(x, y): the world-frame terrain height at (x, y) by bilinear lookup
    in ``hfield_data`` (nrow, ncol), the heightfield's base height outside
    it. The cell index is clamped after the cast too, so a NaN position
    reads a valid cell (its height is the base height)."""
    nrow, ncol = hfield_data.shape
    flat = hfield_data.reshape(-1)
    sx, sy, zt = hfield_size[0], hfield_size[1], hfield_size[2]
    px, py, pz = (float(v) for v in hfield_pos[:3])

    def h(x, y):
        lx = x - px
        ly = y - py
        fx = torch.clamp((lx / sx + 1.0) * 0.5 * (ncol - 1), 0.0,
                         ncol - 1.001)
        fy = torch.clamp((ly / sy + 1.0) * 0.5 * (nrow - 1), 0.0,
                         nrow - 1.001)
        ix = torch.floor(fx).long().clamp_(0, ncol - 2)
        iy = torch.floor(fy).long().clamp_(0, nrow - 2)
        tx, ty = fx - ix.to(fx.dtype), fy - iy.to(fy.dtype)
        idx = iy * ncol + ix
        h00 = flat[idx]
        h01 = flat[idx + 1]
        h10 = flat[idx + ncol]
        h11 = flat[idx + (ncol + 1)]
        hh = ((1 - ty) * ((1 - tx) * h00 + tx * h01)
              + ty * ((1 - tx) * h10 + tx * h11))
        inside = (torch.abs(lx) <= sx) & (torch.abs(ly) <= sy)
        return torch.where(inside, hh * zt + pz, torch.full_like(hh, pz))
    return h


def terrain_hit(cam_pos, d_world, height_fn, max_dist: float = 10.0,
                n_steps: int = 48):
    """(..., H, W) distance to the first march sample below the terrain
    (inf where none is)."""
    ts = torch.linspace(0.05, max_dist, n_steps, dtype=cam_pos.dtype,
                        device=cam_pos.device)
    c = cam_pos[..., None, None, None, :]                  # (..., 1, 1, 1, 3)
    d = d_world[..., None, :]                              # (..., H, W, 1, 3)
    # (..., H, W, S) per component, as cam_pos + ts * d_world
    px = c[..., 0] + ts * d[..., 0]
    py = c[..., 1] + ts * d[..., 1]
    pz = c[..., 2] + ts * d[..., 2]
    below = pz < height_fn(px, py)
    del px, py, pz
    any_hit = below.any(dim=-1)
    first = torch.argmax(below.to(torch.int8), dim=-1)     # the first True
    return torch.where(any_hit, ts[first], torch.full_like(ts[first],
                                                           math.inf))


# ---------------------------------------------------------------------------
# closed-form ray-primitive intersections, batched over pixels x geoms


def _ray_sphere_t(o, d, r):
    """o, d: (..., 3) ray in the sphere frame -> (...,) entry distance."""
    b = torch.sum(o * d, dim=-1)
    c = torch.sum(o * o, dim=-1) - r * r
    disc = b * b - c
    ok = disc >= 0
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = -b - sq
    t = torch.where(t > 0, t, -b + sq)
    return torch.where(ok & (t > 0), t, torch.full_like(t, _INF))


def _ray_ellipsoid_t(o, d, size):
    """Space scaled into the unit sphere (exact)."""
    os_ = o / size
    ds = d / size
    n = torch.linalg.vector_norm(ds, dim=-1)
    t = _ray_sphere_t(os_, ds / torch.clamp(n[..., None], min=1e-12), 1.0)
    # the miss sentinel stays out of the rescaling
    return torch.where(t >= _INF, torch.full_like(t, _INF),
                       t / torch.clamp(n, min=1e-12))


def _ray_capsule_t(o, d, r, hl):
    """Capsule along the local z axis, half-length hl, radius r."""
    ox, oy = o[..., 0], o[..., 1]
    dx, dy = d[..., 0], d[..., 1]
    a = dx * dx + dy * dy
    b = ox * dx + oy * dy
    c = ox * ox + oy * oy - r * r
    disc = b * b - a * c
    ok = (disc >= 0) & (a > 1e-12)
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t_cyl = torch.where(ok, (-b - sq) / torch.clamp(a, min=1e-12),
                        torch.full_like(a, _INF))
    z = o[..., 2] + t_cyl * d[..., 2]
    t_cyl = torch.where((t_cyl > 0) & (torch.abs(z) <= hl), t_cyl,
                        torch.full_like(t_cyl, _INF))
    # the cap spheres, centred at z = +-hl
    cap = lambda z: torch.stack(torch.broadcast_tensors(o[..., 0], o[..., 1],
                                                        z), dim=-1)
    t_top = _ray_sphere_t(cap(o[..., 2] - hl), d, r)
    t_bot = _ray_sphere_t(cap(o[..., 2] + hl), d, r)
    return torch.minimum(t_cyl, torch.minimum(t_top, t_bot))


def _ray_box_t(o, d, size):
    """The slab method in the box frame."""
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12,
                            torch.full_like(d, 1e-12), d)
    t1 = (-size - o) * inv
    t2 = (size - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin > 0, tmin, tmax)
    return torch.where(hit & (t > 0), t, torch.full_like(t, _INF))


_PRIMITIVES = ((T.GEOM_SPHERE, "sphere"), (T.GEOM_CAPSULE, "capsule"),
               (T.GEOM_ELLIPSOID, "ellipsoid"), (T.GEOM_BOX, "box"),
               (T.GEOM_CYLINDER, "cylinder"))


def make_scene_raycaster(model, geom_ids):
    """The static partition of ``geom_ids`` by type -> (cast, any):
    cast(cam_pos (..., 3), d_world (..., H, W, 3), geom_xpos (..., ngeom,
    3), geom_xmat (..., ngeom, 3, 3)) -> (..., H, W) nearest primitive hit
    distance; sizes come from the model."""
    gt = np.asarray(model.geom_type)
    size = torch.as_tensor(model.geom_size)
    groups = {}
    for code, name in _PRIMITIVES:
        ids = np.asarray([g for g in geom_ids if gt[g] == code], np.int64)
        if len(ids):
            ix = torch.as_tensor(ids, device=size.device)
            groups[name] = (ix, size[ix])

    def cast(cam_pos, d_world, geom_xpos, geom_xmat):
        best = torch.full(d_world.shape[:-1], _INF, dtype=d_world.dtype,
                          device=d_world.device)
        for name, (ix, gsize) in groups.items():
            gp = geom_xpos[..., ix, :]                      # (..., G, 3)
            gm = geom_xmat[..., ix, :, :]                   # (..., G, 3, 3)
            gsize = gsize.to(d_world.dtype)
            # rays into each geom frame: R^T (p - c), R^T d
            rel = cam_pos[..., None, :] - gp
            o = torch.einsum("...gij,...gi->...gj", gm, rel)
            dl = torch.einsum("...gij,...hwi->...ghwj", gm, d_world)
            ob = o[..., None, None, :]                      # (..., G,1,1,3)
            if name == "sphere":
                t = _ray_sphere_t(ob, dl, gsize[:, 0, None, None])
            elif name == "ellipsoid":
                t = _ray_ellipsoid_t(ob, dl, gsize[:, None, None, :])
            elif name in ("capsule", "cylinder"):
                # a cylinder as a capsule: the flat-cap error is below a
                # pixel at the eyes' scale
                t = _ray_capsule_t(ob, dl, gsize[:, 0, None, None],
                                   gsize[:, 1, None, None])
            else:  # box
                t = _ray_box_t(ob, dl, gsize[:, None, None, :])
            best = torch.minimum(best, torch.amin(t, dim=-3))
        return best

    return cast, bool(groups)


def shade(t_hit, d_world, max_dist: float):
    """Distance -> intensity in [0, 255]: closer is brighter; a sky
    gradient where nothing is hit."""
    hit = torch.isfinite(t_hit) & (t_hit < max_dist)
    return torch.where(
        hit, 255.0 * torch.clamp(1.0 - t_hit / max_dist, 0.0, 1.0),
        40.0 + 80.0 * torch.clamp(d_world[..., 2], 0, 1))


def _render(cam_pos, cam_mat, rays, height_fn, max_dist, n_steps,
            scene_cast, geom_xpos, geom_xmat, distance):
    d_world = torch.einsum("...ij,hwj->...hwi", cam_mat, rays)
    if height_fn is not None:
        t = terrain_hit(cam_pos, d_world, height_fn, max_dist, n_steps)
    else:
        t = torch.full(d_world.shape[:-1], math.inf, dtype=cam_pos.dtype,
                       device=cam_pos.device)
    if scene_cast is not None:
        t = torch.minimum(t, scene_cast(cam_pos, d_world, geom_xpos,
                                        geom_xmat))
    if distance:
        return t
    return shade(t, d_world, max_dist).to(cam_pos.dtype)


def render_eye(cam_pos, cam_mat, rays, height_fn, max_dist: float = 10.0,
               n_steps: int = 48, scene_cast=None, geom_xpos=None,
               geom_xmat=None, chunk: int = RENDER_CHUNK,
               distance: bool = False):
    """Render one eye of every env: the terrain march and the primitive
    hits -> (B, H, W) intensity in [0, 255] (with ``distance``, the
    nearest hit's distance instead: inf or _INF where nothing is hit).
    cam_pos (B, 3), cam_mat (B, 3, 3), rays (H, W, 3); with ``scene_cast``
    (make_scene_raycaster) the geom frames (B, ngeom, 3) and (B, ngeom, 3,
    3) too. ``chunk`` envs are rendered per pass."""
    B = cam_pos.shape[0]
    part = lambda x, s: None if x is None else x[s]
    return torch.cat([
        _render(cam_pos[s], cam_mat[s], rays, height_fn, max_dist, n_steps,
                scene_cast, part(geom_xpos, s), part(geom_xmat, s), distance)
        for s in (slice(i, i + chunk) for i in range(0, B, chunk))])
