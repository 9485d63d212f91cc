"""The flat floor arena of the walking tasks.

Only ``floor_arena`` is ported; the no-op ``TemplateTask`` and its factory
wait for the other fly tasks and ``envs/wrappers.py`` (ROADMAP A5)."""

from __future__ import annotations


def floor_arena(size=(50.0, 50.0), friction=0.5,
                solref=(0.001, 1.0), solimp=(0.95, 0.99, 0.01)):
    """Arena callback adding a flat floor plane to an MjSpec, with the
    walking tasks' contact parameters. mujoco is imported when the
    callback runs (model export only)."""
    def fn(spec):
        import mujoco
        spec.worldbody.add_geom(
            name="floor", type=mujoco.mjtGeom.mjGEOM_PLANE,
            size=[size[0], size[1], 0.1],
            friction=[friction, 0.005, 0.0001],
            solref=list(solref), solimp=list(solimp) + [0.5, 2.0],
            condim=3)
    return fn
