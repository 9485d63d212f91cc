"""The PyTorch port stands alone: no file of ``flybody_tpu_torch/`` or
``chip_smoke.py`` imports JAX or the JAX package, importing the port
leaves JAX unloaded, and the entry point refuses to slide onto the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "flybody_tpu")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "flybody_tpu_torch")):
        out += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    for name in _imported(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, flybody_tpu_torch.fly_envs, "
            "flybody_tpu_torch.physics.bridge, "
            "flybody_tpu_torch.ops.solver_kernels; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_walk_on_ball_needs_cuda_unless_told_otherwise():
    from flybody_tpu_torch.fly_envs import walk_on_ball
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        walk_on_ball()
    env = walk_on_ball(device="cpu")
    assert env.device.type == "cpu"
