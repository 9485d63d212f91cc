"""Thin env wrappers.

Precision is the env's build-time dtype, so of the reference's wrappers
only the observation filter has a runtime counterpart here."""

from __future__ import annotations


class DropObservations:
    """Remove observation keys from an env (reference RemoveVisionWrapper,
    vnl_ray/wrapper.py:92-108: blind policies on vision tasks). Everything
    else is the wrapped env's."""

    def __init__(self, env, keys):
        self._env = env
        self._drop = tuple(keys)

    def __getattr__(self, name):
        return getattr(self._env, name)

    def _filter(self, state):
        obs = {k: v for k, v in state.obs.items() if k not in self._drop}
        return state.replace(obs=obs)

    def reset(self, B, generator=None, **init_kw):
        return self._filter(self._env.reset(B, generator, **init_kw))

    def step(self, state, action):
        return self._filter(self._env.step(state, action))

    def autoreset_step(self, state, action):
        return self._filter(self._env.autoreset_step(state, action))


def remove_vision(env):
    """Drop eye/camera observations (fly stereo eyes or the rodent
    egocentric camera)."""
    return DropObservations(env, ("left_eye", "right_eye",
                                  "egocentric_camera"))
