"""The vision_flight configuration on the CPU: its cell resolves by name;
the plain reference follows the program (bit for bit in float32, within
the cell's limits in float64); the eye faults of
``benchmark/vision_faults.py`` exceed the step's limits; the reference's
eyes cast what the program's cast; and the render's counting functions
against a hand count."""

import time

import pytest
import torch

from benchmark import check, drivers, harness, render_work, vision_faults

VISION = "vision_flight.sim4096"
SEED = 2 ** 33 + 17


def test_new_cell_resolves():
    cell = harness.resolve(VISION)
    names = {m["name"] for m in cell.per_layer}
    assert {"sim_env_steps_per_s", "setup_s"} == {
        m["name"] for m in cell.end_to_end}
    assert {"solve_rows_roofline_pct.sim", "reset_useful_pct.sim",
            "ccd_launches_per_step.sim"} <= names
    assert {"render_launches_per_step.sim",
            "render_roofline_pct.sim"} <= names
    assert cell.chips == 1 and cell.traffic["action_pool"] == 16
    assert cell.traffic["envs"] == 4096
    assert drivers.load_limits(VISION)


def _actions(env, B, seed):
    lo, hi = (torch.as_tensor(x, dtype=torch.float32)
              for x in env.action_spec())
    u = torch.rand((B, lo.shape[0]),
                   generator=torch.Generator().manual_seed(seed))
    return lo + (hi - lo) * u


def test_float32_reference_follows_the_program():
    """In the configuration's float32 the frozen copy takes the program's
    reset and step bit for bit: the draws, the WBPG, the physics and both
    eyes."""
    cell = harness.resolve(VISION)
    prog = drivers.program_env(cell.config, "cpu")
    ref = drivers.reference_env(cell, "cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(5)
    a = _actions(prog, 2, 6)
    s1 = prog.autoreset_step(prog.reset(2, g), a)
    rng = g.get_state()
    s2 = prog.autoreset_step(s1, a)
    r2 = ref.autoreset_step(check.follow(ref, s1, rng), a)
    assert check.numbers(s2, r2, "step")["_step_err_max"] == 0.0
    r1 = ref.autoreset_step(ref.reset(2, torch.Generator().manual_seed(5)),
                            a)
    assert check.numbers(s1, r1, "start")["_start_err_max"] == 0.0


def test_reference_casts_what_the_program_casts():
    """The reference's eye selection, written apart from the program's,
    drops the same geoms: the head's two ellipsoids, 14 of 16 left."""
    cell = harness.resolve(VISION)
    prog = drivers.program_env(cell.config, "cpu").task
    ref = drivers.reference_env(cell, "cpu").task
    assert ref.scene_geoms == prog.scene_geoms.tolist()
    assert [e["geoms"] for e in ref.eyes] == [g.tolist()
                                              for g in prog.eye_geoms]
    assert [len(e["geoms"]) for e in ref.eyes] == [14, 14]


def _run(workload, hook=None, envs=8):
    return drivers.run_cell(harness.resolve(workload), SEED, 0.0, False,
                            "cpu", time.time(), hook=hook, envs=envs)


def test_sound_run_is_correct():
    res = _run(VISION)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", vision_faults.KINDS)
def test_eye_fault_exceeds_the_step_limits(kind):
    res = _run(VISION, hook=vision_faults.hook(kind))
    assert not res["correct"]
    for name in ("step_err_median", "step_err_p99"):
        c = res["checks"][name]
        assert c["value"] > c["limit"], (name, c)


def test_render_work_by_hand():
    # 2 envs x 2 x 2 pixels x 2 eyes = 16 rays; 3 primitives an eye, so
    # 48 pairs: 16 x (6 + 8 + 11 + 2 + 1) + 48 x (15 + 9) operations, one
    # float32 written a ray
    assert render_work.render_flops(16, 48) == 16 * 28 + 48 * 24
    assert render_work.render_bytes(16) == 64.0
    with pytest.raises(ValueError):
        vision_faults.hook("march12")
