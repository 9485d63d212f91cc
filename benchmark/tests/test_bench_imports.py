"""No module of JAX or of the JAX package in a benchmark run, compared by
whole top-level name; and a plain reference that imports nothing of the
program."""

import subprocess
import sys

from benchmark import harness, run


def test_whole_top_level_names(monkeypatch):
    fake = {"flybody_tpu_torch": 1, "flybody_tpu_torch.physics": 1,
            "jaxtyping": 1, "flaxen.x": 1, "flybody_tpu": 1, "jax.numpy": 1,
            "jaxlib": 1, "flax.linen": 1}
    monkeypatch.setattr(sys, "modules", fake)
    assert run.forbidden_modules() == ["flax.linen", "flybody_tpu",
                                       "jax.numpy", "jaxlib"]


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\n"
                          "print('\\n'.join(sorted(sys.modules)))"],
                         cwd=harness.ROOT, capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin",
                                          "HOME": "/nonexistent"})
    return set(out.stdout.split())


def test_harness_and_program_load_no_jax():
    mods = _loaded(
        "import benchmark.run, benchmark.drivers, benchmark.calibrate\n"
        "from benchmark import harness, drivers\n"
        "import json\n"
        "spec = json.load(open('BENCHMARK.json'))\n"
        "for w in spec['workloads']:\n"
        "    c = harness.resolve(w['name'])\n"
        "    drivers.reference_env(c, 'cpu')\n"
        "    drivers.program_env(c.config, 'cpu')\n")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "flybody_tpu"}
    assert "flybody_tpu_torch" in tops


def test_reference_imports_nothing_of_the_program():
    mods = _loaded(
        "import json\n"
        "from benchmark import harness, check, work, trace\n"
        "spec = json.load(open('BENCHMARK.json'))\n"
        "for c in spec['configs']:\n"
        "    m = harness.load_module(harness.reference_path(harness.ROOT, "
        "c['name']), c['name'])\n"
        "    m.make_env('cpu')\n")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "flax", "flybody_tpu",
                       "flybody_tpu_torch"}
