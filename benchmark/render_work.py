"""The eye render's yardstick: the operations and bytes that any
implementation of one render must spend, from its sizes alone.

Counted: each ray against every primitive it is cast against (the ray's
direction into the geom's frame and the least closed form, a sphere's
quadratic), one terrain sample a ray, and each eye image written once in
float32. Not counted: the march's other samples (a march that stops at
the first sample under the terrain is correct and samples less), the
larger closed forms of boxes, capsules and ellipsoids, and the shading.
So a share of the roofline built on this count is a floor, and no
correct render can read it over 100 %.
"""

from __future__ import annotations

# the ray's direction into a geom's frame, R^T d: 9 products, 6 sums
FRAME_FLOPS = 15
# a sphere's entry distance: b = o.d (3 products, 2 sums), b^2 - c, its
# square root, -b - sqrt, and the compare that keeps the nearest
QUADRATIC_FLOPS = 9
PAIR_FLOPS = FRAME_FLOPS + QUADRATIC_FLOPS
# one terrain sample: the point c + t d (3 products, 3 sums), two cell
# coordinates (a sum, a product, a sum, a product each), the bilinear
# blend of four heights (6 products, 3 sums, 2 differences), the height's
# scale and offset (2) and the compare with the point's height
SAMPLE_FLOPS = 6 + 8 + 11 + 2 + 1
IMAGE_BYTES = 4


def render_flops(rays: float, pairs: float) -> float:
    """Operations of a render of ``rays`` rays, ``pairs`` ray-primitive
    pairs among them."""
    return float(SAMPLE_FLOPS * rays + PAIR_FLOPS * pairs)


def render_bytes(rays: float) -> float:
    """Bytes a render must write: one float32 intensity a ray."""
    return float(IMAGE_BYTES * rays)
