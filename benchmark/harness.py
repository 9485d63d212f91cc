"""Finding a cell's files by name.

``BENCHMARK.json`` at the checkout's root names each cell (a workload) by
its configuration and its traffic mix; each of those, and each per-layer
metric, is a file of its own that this module finds by that name:

    benchmark/configs/<config>.json   the configuration, every value run
    benchmark/configs/<config>.py     its plain reference (``make_env``)
    benchmark/traffic/<traffic>.json  the traffic mix, read by a driver
    benchmark/metrics/<metric>.py     a per-layer metric's reader

A later cell comes as new files and new entries only. Nothing here needs a
card: this is a check of the files, and the measured path never falls
back to the CPU.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file's contents
    config_name: str
    traffic: dict         # the traffic file's contents
    traffic_name: str
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list
    readers: dict         # per-layer metric name -> module with read(ctx)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def reference_path(root: str, config: str) -> str:
    return os.path.join(root, "benchmark", "configs", f"{config}.py")


def traffic_path(root: str, traffic: str) -> str:
    return os.path.join(root, "benchmark", "traffic", f"{traffic}.json")


def metric_path(root: str, metric: str) -> str:
    return os.path.join(root, "benchmark", "metrics", f"{metric}.py")


def load_module(path: str, name: str):
    """A module from a file path (metric and reference files carry dots
    in their names, so they are loaded by path, not imported)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark._by_path." + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reports(metric: dict, workload: str, e2e_names: set) -> bool:
    """True where a metric belongs in a cell's line: listed under its
    ``workloads``, or, without that key, wherever the metric it moves (or,
    for an end-to-end metric, every cell) is reported."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return metric.get("moves") is None or metric["moves"] in e2e_names


def resolve(workload: str, spec: dict | None = None,
            root: str = ROOT) -> Cell:
    """The cell ``workload`` of ``spec`` (BENCHMARK.json under ``root``
    by default) with its files read and its metric readers loaded; raises
    KeyError or FileNotFoundError for a name with no entry or no file."""
    if spec is None:
        spec = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in configs:
        raise KeyError(f"workload {workload}: no config {w['config']!r}")
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(traffic_path(root, w["traffic"]))
    if not os.path.exists(reference_path(root, w["config"])):
        raise FileNotFoundError(reference_path(root, w["config"]))
    e2e = [m for m in spec["end_to_end"] if reports(m, workload, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if reports(m, workload, names)]
    readers = {m["name"]: load_module(metric_path(root, m["name"]),
                                      m["name"]) for m in per_layer}
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                config_name=w["config"], traffic=traffic,
                traffic_name=w["traffic"], end_to_end=e2e,
                per_layer=per_layer, readers=readers)
