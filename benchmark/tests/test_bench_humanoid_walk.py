"""The humanoid_walk configuration on the CPU: its cell resolves by name
with its metrics; the plain reference follows the program bit for bit in
float32 over three auto-reset steps, one of them ending an env for its
tracking error and resetting it to a drawn clip and start; the float64
reference stays within the cell's limits; the configuration's sizes are
the models'; and the tracking faults of ``benchmark/tracking_faults.py``
exceed the step's limits."""

import time

import pytest
import torch

from benchmark import check, drivers, harness, tracking_faults

HUMANOID = "humanoid_walk.sim4096"
SEED = 2 ** 33 + 17
B = 8
# the steps taken before the followed ones: the tracking error grows with
# each step of random actions, and crosses the threshold in the third
# followed step
LEAD = 3
FOLLOWED = 3

torch.set_num_threads(2)


def _actions(env, k):
    lo, hi = (torch.as_tensor(x, dtype=torch.float32)
              for x in env.action_spec())
    u = torch.rand((B, lo.shape[0]),
                   generator=torch.Generator().manual_seed(10 + k))
    return lo + (hi - lo) * u


def _trajectory(env):
    """[(state before, generator state before, action, state after)] of
    the followed steps, after ``LEAD`` steps from a reset of seed 5."""
    g = torch.Generator().manual_seed(5)
    state = env.reset(B, g)
    out = []
    for k in range(LEAD + FOLLOWED):
        pre, rng, a = state, g.get_state(), _actions(env, k)
        state = env.autoreset_step(state, a)
        if k >= LEAD:
            out.append((pre, rng, a, state))
    return out


@pytest.fixture(scope="module")
def cell():
    return harness.resolve(HUMANOID)


@pytest.fixture(scope="module")
def followed(cell):
    """The program's followed steps and the float32 reference's follow of
    each."""
    prog = drivers.program_env(cell.config, "cpu")
    ref = drivers.reference_env(cell, "cpu", dtype=torch.float32)
    steps = _trajectory(prog)
    refs = [ref.autoreset_step(check.follow(ref, pre, rng), a)
            for pre, rng, a, _ in steps]
    return prog, ref, steps, refs


def test_new_cell_resolves(cell):
    names = {m["name"] for m in cell.per_layer}
    assert {"sim_env_steps_per_s", "setup_s"} == {
        m["name"] for m in cell.end_to_end}
    assert {"device_idle_pct.sim", "launches_per_step.sim",
            "solve_rows_roofline_pct.sim", "step_mfu.sim",
            "reset_ms_per_step.sim", "kinematics_launches_per_step.sim",
            "collision_launches_per_step.sim", "ccd_launches_per_step.sim",
            "solve_rows_used_pct.sim", "reset_useful_pct.sim",
            "graph_substeps_pct.sim", "tracking_launches_per_step.sim",
            "tracking_host_ms_per_step.sim",
            "tracking_device_ms_per_step.sim"} == names
    assert cell.chips == 1 and cell.traffic["action_pool"] == 16
    assert cell.traffic["envs"] == 4096
    assert cell.config["reduced"] == {}
    assert drivers.load_limits(HUMANOID)


def test_float32_reference_follows_the_program(cell, followed):
    """In float32 the frozen copy takes the program's reset and each
    followed step bit for bit: the clip and start draws, the physics, the
    previews, the reward, the termination and the auto-reset."""
    prog, ref, steps, refs = followed
    for (_, _, _, post), r in zip(steps, refs):
        assert check.numbers(post, r, "step")["_step_err_max"] == 0.0
        for k in ("clip", "start", "step"):
            assert torch.equal(post.task_state[k], r.task_state[k]), k
    a = _actions(prog, 0)
    s1 = prog.autoreset_step(prog.reset(B, torch.Generator().manual_seed(5)),
                             a)
    r1 = ref.autoreset_step(ref.reset(B, torch.Generator().manual_seed(5)),
                            a)
    assert check.numbers(s1, r1, "start")["_start_err_max"] == 0.0


def test_a_followed_step_ends_an_env_for_its_error(followed):
    """An env ends for its tracking error (discount 0, not at its clip's
    end) and is reset to a drawn clip and start at step 0."""
    task = followed[0].task
    ended = False
    for pre, _, _, post in followed[2]:
        ts = pre.task_state
        clip_end = (ts["start"] + ts["step"] + 1 + max(task.ref_steps)
                    >= task.clips.lengths[ts["clip"]])
        fatal = post.done & (post.discount == 0) & ~clip_end
        if fatal.any():
            ended = True
            assert torch.all(post.task_state["step"][fatal] == 0)
            assert torch.all(post.step_idx[fatal] == 0)
            moved = ((post.task_state["start"] != ts["start"])
                     | (post.task_state["clip"] != ts["clip"]))
            assert moved[fatal].any()
    assert ended


def test_body_sizes_are_the_models(cell):
    """The configuration's sizes are the program's model's as well as the
    reference's (``test_bench_work`` holds the rest to the reference)."""
    prog = drivers.program_env(cell.config, "cpu")
    ref = drivers.reference_env(cell, "cpu")
    body = cell.config["body"]
    for env in (prog, ref):
        m = env.model
        assert (m.nv, m.nbody, env.action_size, env.n_substeps,
                m.col_refresh) == (body["nv"], body["nbody"], body["nu"],
                                   body["substeps"], body["col_refresh"])
        assert float(m.opt.timestep) == pytest.approx(
            body["physics_timestep_s"])
        assert env.task.ctrl_dt == pytest.approx(body["control_timestep_s"])
    task = cell.config["task"]
    t = prog.task
    assert (t.clips.num_clips, int(t.clips.lengths.max())) == (
        task["clips"], task["clip_frames"])
    assert list(t.ref_steps) == task["ref_steps"]
    assert (t.termination_error_threshold, t.min_steps, t.reward_key) == (
        task["termination_error_threshold"], task["min_steps"],
        task["reward"])
    assert t.time_limit == task["time_limit_s"]
    assert prog.episode_steps == round(task["time_limit_s"] / t.ctrl_dt)


def test_sound_run_is_correct():
    """A run of the cell at 8 envs: the float64 reference stays within
    the cell's limits at the start and at the drawn step."""
    res = drivers.run_cell(harness.resolve(HUMANOID), SEED, 0.0, False,
                           "cpu", time.time(), envs=B)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", tracking_faults.KINDS)
def test_tracking_fault_exceeds_the_step_limits(cell, followed, kind):
    """Each fault, planted in the program, fails the cell's step limits
    against the float64 reference over the followed steps."""
    prog = drivers.program_env(cell.config, "cpu")
    tracking_faults.hook(kind)(prog)
    ref = drivers.reference_env(cell, "cpu")
    limits = drivers.load_limits(HUMANOID)
    worst = {}
    for pre, rng, a, post in _trajectory(prog):
        r = ref.autoreset_step(check.follow(ref, pre, rng), a.double())
        n = check.numbers(post, r, "step")
        ok, _ = check.judge(n, {k: v for k, v in limits.items()
                                if k.startswith("step_")})
        for k in ("step_err_median", "step_err_p99"):
            worst[k] = max(worst.get(k, 0.0), n[k])
        worst["ok"] = worst.get("ok", True) and ok
    assert not worst["ok"]
    assert worst["step_err_p99"] > limits["step_err_p99"], worst
    if kind == "late":
        assert worst["step_err_median"] > limits["step_err_median"], worst


def test_unknown_fault_is_refused():
    with pytest.raises(ValueError):
        tracking_faults.hook("early")
