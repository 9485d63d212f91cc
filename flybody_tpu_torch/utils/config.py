"""YAML run configs (reference vnl_ray hydra configs).

The reference drives training through hydra + 12 structured YAML run
configs (reference train_dmpo_ray.py:102-106, vnl_ray/config/*.yaml).
Here a config is a flat-or-nested YAML whose leaves override the argparse
defaults of flybody_tpu_torch.train_dmpo: nested sections are flattened
(section names are organizational only, matching the reference's
run_config / learner_network / learner_params groups), keys use either -
or _. PyYAML is imported only when a config is read.

    python -m flybody_tpu_torch.train_dmpo --config run.yaml
"""

from __future__ import annotations

import argparse


def load_yaml(path: str) -> dict:
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f) or {}
    flat: dict = {}

    def walk(node):
        for k, v in node.items():
            key = str(k).replace("-", "_")
            if key in ("task_envs", "actors_envs"):
                # multi-task {task: num_envs} map (reference generalist
                # configs' actors_envs) — kept as a dict, not flattened
                flat["task_envs"] = {str(t).replace("-", "_"): int(n)
                                     for t, n in (v or {}).items()}
            elif isinstance(v, dict):
                walk(v)
            else:
                flat[key] = v

    walk(raw)
    return flat


def apply_yaml_config(args: argparse.Namespace, path: str,
                      strict: bool = False) -> argparse.Namespace:
    """Override argparse values with the config's leaves. Unknown keys are
    ignored unless strict (the reference configs carry ray/cluster knobs
    that have no analog in the single-device loop)."""
    flat = load_yaml(path)
    for k, v in flat.items():
        if hasattr(args, k):
            default = getattr(args, k)
            if default is not None and not isinstance(default, bool) \
                    and isinstance(v, (int, float, str)):
                v = type(default)(v)
            setattr(args, k, v)
        elif strict:
            raise KeyError(f"unknown config key {k!r} in {path}")
    return args
