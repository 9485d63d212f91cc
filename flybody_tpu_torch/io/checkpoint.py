"""Checkpoint / resume with torch.save (reference learning_dmpo.py:160-243).

A checkpoint is a directory holding ``state.pt``: a nested dict of tensors
and ints, made from the saved state by calling ``state_dict()`` on every
object that has one (a TrainState, a module, an optimizer). Supports the
full learner state and the policy-only partial restores. Checkpoints of
the JAX package (Orbax) are not read here; their weights reach the port
through ``agents.params``.
"""

from __future__ import annotations

import os
import time
from typing import Any

import torch

_FILE = "state.pt"


def _plain(x):
    if hasattr(x, "state_dict"):
        return x.state_dict()
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _check_like(raw, tpl, where: str = "") -> None:
    """Raise ValueError unless ``raw`` has ``tpl``'s keys and tensor
    shapes (it may hold more keys: the moments of an optimizer that has
    stepped, where the template's has not)."""
    if isinstance(tpl, dict):
        if not isinstance(raw, dict) or not set(tpl) <= set(raw):
            raise ValueError(f"checkpoint keys differ at {where or '/'}")
        for k in tpl:
            _check_like(raw[k], tpl[k], f"{where}/{k}")
    elif isinstance(tpl, torch.Tensor):
        if not isinstance(raw, torch.Tensor) or raw.shape != tpl.shape:
            raise ValueError(f"checkpoint shape differs at {where}")


def _load_into(tpl, raw):
    if hasattr(tpl, "load_state_dict"):
        tpl.load_state_dict(raw)
        return tpl
    if isinstance(tpl, dict):
        return {k: _load_into(tpl[k], raw[k]) for k in tpl}
    return raw


def load(path: str) -> dict:
    """The raw saved dict, on the CPU."""
    return torch.load(os.path.join(os.path.abspath(path), _FILE),
                      map_location="cpu", weights_only=True)


def save(path: str, state: Any, step: int | None = None) -> str:
    """Save a checkpoint (a train state or a dict holding one)."""
    path = os.path.abspath(path)
    if step is not None:
        path = os.path.join(path, f"ckpt_{step}")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_plain(state), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def restore(path: str, template: Any) -> Any:
    """Restore into ``template`` (objects with ``load_state_dict`` are
    loaded in place). Raises ValueError, and touches nothing, when the
    checkpoint's structure or shapes differ from the template's."""
    raw = load(path)
    _check_like(raw, _plain(template))
    return _load_into(template, raw)


def _train_node(raw: dict) -> dict:
    return raw["train"] if isinstance(raw, dict) and "train" in raw else raw


def restore_policy_only(path: str, train_state):
    """Load only the policy (online and target) from a checkpoint of a
    TrainState, or of a dict holding one under "train"."""
    raw = _train_node(load(path))
    for k in ("policy", "target_policy"):
        _check_like(raw[k], getattr(train_state, k).state_dict(), k)
    train_state.policy.load_state_dict(raw["policy"])
    train_state.target_policy.load_state_dict(raw["target_policy"])
    return train_state


def restore_policy_params(path: str) -> dict:
    """The policy's state_dict from a checkpoint, without a template
    (teacher loading for kickstarting)."""
    node = _train_node(load(path))
    return node["policy"] if "policy" in node else node


def latest(path: str) -> str | None:
    """Most recent completed ckpt_* directory under path, if any."""
    if not os.path.isdir(path):
        return None
    cands = []
    for d in os.listdir(path):
        if not d.startswith("ckpt_"):
            continue
        suffix = d.split("_", 1)[1]
        if suffix.isdigit() and os.path.isfile(os.path.join(path, d, _FILE)):
            cands.append((int(suffix), d))
    if not cands:
        return None
    return os.path.join(path, max(cands)[1])


class PeriodicCheckpointer:
    """Time-based saving (reference Checkpointer, time_delta_minutes)."""

    def __init__(self, directory: str, time_delta_minutes: float = 30.0):
        self.directory = directory
        self.delta = time_delta_minutes * 60.0
        self._last = time.time()

    def due(self) -> bool:
        return time.time() - self._last >= self.delta

    def maybe_save(self, state, step: int):
        if self.due():
            self._last = time.time()
            return save(self.directory, state, step)
        return None
