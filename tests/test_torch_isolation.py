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
            "flybody_tpu_torch.ops.solver_kernels, "
            "flybody_tpu_torch.agents.train, flybody_tpu_torch.train_dmpo, "
            "flybody_tpu_torch.io.checkpoint, "
            "flybody_tpu_torch.tasks.flight_imitation, "
            "flybody_tpu_torch.tasks.pattern_generators, "
            "flybody_tpu_torch.tasks.task_utils, "
            "flybody_tpu_torch.tasks.template_task, "
            "flybody_tpu_torch.tasks.vision_flight, "
            "flybody_tpu_torch.tasks.arenas, flybody_tpu_torch.ops.raycast, "
            "flybody_tpu_torch.envs.wrappers, "
            "flybody_tpu_torch.agents.intention_networks, "
            "flybody_tpu_torch.agents.multitask, "
            "flybody_tpu_torch.agents.evaluator, "
            "flybody_tpu_torch.utils.rendering, "
            "flybody_tpu_torch.rodent_envs, flybody_tpu_torch.models.rodent, "
            "flybody_tpu_torch.envs.rodent_walker, "
            "flybody_tpu_torch.tasks.rodent_tasks, "
            "flybody_tpu_torch.tasks.rodent_arenas, "
            "flybody_tpu_torch.tasks.tracking, "
            "flybody_tpu_torch.tasks.tracking_rewards, "
            "flybody_tpu_torch.envs.humanoid_walker, "
            "flybody_tpu_torch.io.stac, "
            "flybody_tpu_torch.inverse_kinematics, "
            "flybody_tpu_torch.render_stac, "
            "flybody_tpu_torch.parallel.distributed, "
            "flybody_tpu_torch.parallel.mesh, "
            "flybody_tpu_torch.parallel.dryrun; "
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


def test_walk_imitation_needs_cuda_unless_told_otherwise():
    from flybody_tpu_torch.fly_envs import walk_imitation
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        walk_imitation()
    env = walk_imitation(device="cpu")
    assert env.device.type == "cpu"
    assert env.task.dataset.lengths.device.type == "cpu"


@pytest.mark.parametrize("factory", ["flight_imitation", "template_task"])
def test_flight_and_template_need_cuda_unless_told_otherwise(factory):
    from flybody_tpu_torch import fly_envs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = getattr(fly_envs, factory)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    env = make(device="cpu")
    assert env.device.type == "cpu"
    if factory == "flight_imitation":
        assert env.task.dataset.lengths.device.type == "cpu"
        assert env.task.wbpg.table.device.type == "cpu"


@pytest.mark.parametrize("factory", ["rodent_two_touch", "rodent_escape_bowl",
                                     "rodent_run_gaps", "rodent_maze_forage",
                                     "rodent_walk_imitation",
                                     "walk_humanoid"])
def test_rodent_envs_need_cuda_unless_told_otherwise(factory):
    from flybody_tpu_torch import rodent_envs
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    make = getattr(rodent_envs, factory)
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    env = make(device="cpu")
    nv = 62 if factory == "walk_humanoid" else 73
    assert env.device.type == "cpu" and env.model.nv == nv
    if factory in ("rodent_walk_imitation", "walk_humanoid"):
        assert env.task.clips.lengths.device.type == "cpu"
        assert env.task.clips.fields["qpos"].device.type == "cpu"
