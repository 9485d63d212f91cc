"""BENCHMARK.json against the benchmark's contract, and the lookup of a
cell's files by name (no card needed: a check of the files)."""

import json
import os
import shutil

import pytest

from benchmark import harness

SPEC = harness._load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
CELLS = [w["name"] for w in SPEC["workloads"]]
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_spec_keys_and_limits():
    assert set(SPEC) == TOP
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert all(_line(w) for w in SPEC["command"])
    assert os.path.getsize(os.path.join(harness.ROOT, "BENCHMARK.json")) \
        < 64 * 1024
    for group, keys in KEYS.items():
        for e in SPEC[group]:
            extra = {"workloads"} if group in ("end_to_end",
                                               "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (group, e["name"])
    for e in SPEC["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        limit = 0.25
        assert 0.01 <= e["bound"] <= limit
    assert any(e["name"] == "setup_s" for e in SPEC["end_to_end"])
    for e in SPEC["per_layer"]:
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(e["layer"])
        assert e["moves"] in {m["name"] for m in SPEC["end_to_end"]}
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and _line(w["why"])
    for c in SPEC["configs"]:
        assert _line(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith("benchmark/")


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units(group):
    names = [e["name"] for e in SPEC[group]]
    assert len(names) == len(set(names))
    for e in SPEC[group]:
        assert harness.NAME.match(e["name"]), e["name"]
        for k in ("config", "traffic"):
            if k in e:
                assert harness.NAME.match(e[k])
        for k in e.get("reduced", []):
            assert harness.NAME.match(k)
        if "unit" in e:
            assert harness.UNIT.match(e["unit"]), e["unit"]
        if "better" in e:
            assert e["better"] in ("lower", "higher")


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = harness.resolve(workload)
    assert cell.config["name"] == cell.config_name
    assert cell.traffic["driver"] in ("sim", "train")
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer, workload
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(cell.readers[m["name"]].read)
    limits = os.path.join(harness.ROOT, "benchmark", "limits",
                          f"{workload}.json")
    assert json.load(open(limits))["limits"]


def test_every_config_used_and_listed_metric_cells_exist():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert set(m.get("workloads", [])) <= set(CELLS)


def test_a_cell_added_as_data_only(tmp_path):
    """A new cell: a configuration, a traffic mix and a per-layer metric,
    each a new file, and new entries in BENCHMARK.json; no file that is
    there changes, and the lookup finds them all by name."""
    root = tmp_path
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests",
                                                  "reference"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    cfg = json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                      "fly_walk_imitation.json")))
    cfg["name"] = "fly_walk_imitation_b"
    (root / "benchmark" / "configs" / "fly_walk_imitation_b.json"
     ).write_text(json.dumps(cfg))
    shutil.copy(root / "benchmark" / "configs" / "fly_walk_imitation.py",
                root / "benchmark" / "configs" / "fly_walk_imitation_b.py")
    (root / "benchmark" / "traffic" / "sim256.json").write_text(json.dumps(
        {**json.load(open(root / "benchmark" / "traffic" / "sim4096.json")),
         "envs": 256}))
    (root / "benchmark" / "metrics" / "probe_ms.sim.py").write_text(
        "def read(ctx):\n    return None\n")
    spec["configs"].append({"name": "fly_walk_imitation_b",
                            "source": "https://example.org/b",
                            "file": "benchmark/configs/"
                                    "fly_walk_imitation_b.json",
                            "reduced": [], "why": "a second fly"})
    spec["workloads"].append({"name": "fly_walk_imitation_b.sim256",
                              "config": "fly_walk_imitation_b",
                              "traffic": "sim256", "chips": 1,
                              "why": "small batch"})
    sim = next(m for m in spec["end_to_end"]
               if m["name"] == "sim_env_steps_per_s")
    sim["workloads"].append("fly_walk_imitation_b.sim256")
    spec["per_layer"].append({"name": "probe_ms.sim", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "task", "moves": "sim_env_steps_per_s",
                              "workloads": ["fly_walk_imitation_b.sim256"]})
    cell = harness.resolve("fly_walk_imitation_b.sim256", spec, root=root)
    assert cell.traffic["envs"] == 256
    assert cell.config["name"] == "fly_walk_imitation_b"
    assert [m["name"] for m in cell.per_layer] == ["probe_ms.sim"]
    assert cell.readers["probe_ms.sim"].read({}) is None
    assert {m["name"] for m in cell.end_to_end} == {"sim_env_steps_per_s",
                                                    "setup_s"}
    for p, b in before.items():
        assert p.read_bytes() == b
    with pytest.raises(KeyError):
        harness.resolve("no_such.cell", spec, root=root)
