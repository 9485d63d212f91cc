"""The plain reference at a tiny size on the CPU: it is a faithful frozen
copy (the program's plain path on the CPU steps to the same state), and
``check.follow`` rebuilds the program's state so that the reference takes
the same step from it."""

import pytest
import torch

from benchmark import check, drivers, harness

B = 2


def _cell(workload):
    return harness.resolve(workload)


@pytest.mark.parametrize("workload", ["fly_walk_imitation.sim4096",
                                      "rat_two_touch.sim4096"])
def test_reference_follows_the_program(workload):
    cell = _cell(workload)
    # both in the configuration's float32: the copy draws its random
    # numbers in float32 whatever its dtype, as the program does in float32
    prog = drivers.program_env(cell.config, "cpu")
    ref = drivers.reference_env(cell, "cpu", dtype=torch.float32)
    g = torch.Generator().manual_seed(3)
    s0 = prog.reset(B, g)
    lo, hi = (torch.as_tensor(x, dtype=torch.float32)
              for x in prog.action_spec())
    a = lo + (hi - lo) * torch.rand((B, lo.shape[0]),
                                    generator=torch.Generator().manual_seed(4))
    s1 = prog.autoreset_step(s0, a)
    rng = g.get_state()
    s2 = prog.autoreset_step(s1, a)
    r2 = ref.autoreset_step(check.follow(ref, s1, rng), a)
    n = check.numbers(s2, r2, "step")
    assert n["_step_err_max"] == 0.0 and n["_step_done_flips"] == 0
    # the start: the reference's own reset and step from the seed
    g2 = torch.Generator().manual_seed(3)
    r1 = ref.autoreset_step(ref.reset(B, g2), a)
    assert check.numbers(s1, r1, "start")["_start_err_max"] == 0.0


def test_env_errors_scale_and_flips():
    cell = _cell("fly_walk_imitation.sim4096")
    ref = drivers.reference_env(cell, "cpu")
    s = ref.reset(3, torch.Generator().manual_seed(0))
    qpos = s.data.qpos.clone()
    qpos[:, 1] += 0.5 * qpos.abs().max()
    t = s.replace(data=s.data.replace(qpos=qpos),
                  done=torch.tensor([False, False, True]))
    err, worst, flips = check.env_errors(t, s)
    assert err[0] == 0.0 and err[1] == pytest.approx(0.5)
    assert worst == "qpos" and flips.tolist() == [False, False, True]
    ok, out = check.judge({"a": 0.1, "b": float("nan")},
                          {"a": 0.2, "b": 1.0})
    assert not ok and out["a"] == {"value": 0.1, "limit": 0.2}
