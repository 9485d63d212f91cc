"""The yardstick's counting functions against hand counts at a tiny size,
and each configuration's sizes against its plain reference's model."""

import json
import os

import pytest
import torch

from benchmark import drivers, harness, work


def test_solve_rows_flops_by_hand():
    # nv 2, R 3, B 5, n_up 4, n_down 6, 1 + 2 x 1 + 1 applications of
    # Yd^T Yd: per env 2*3*(15+4+3+2+4*4) + 2*4*3 + 2*(4+6) = 240+24+20
    assert work.solve_rows_flops(2, 3, 5, 4, 6, iterations=1,
                                 noslip_iterations=1,
                                 power_iters=1) == 284.0 * 5


def test_solve_rows_bytes_by_hand():
    # nv 2, R 3, B 1, nbody 4, nM 5, kc 0: d6 12, u6 18, 13 (R, B) rows
    # 39, maskd 8, ld 5, dinv/qacc_smooth/qvel 6, mu 1, f/v 6, qfrc/dqacc
    # 4: 99 words
    assert work.solve_rows_bytes(2, 3, 1, 4, 5, 0) == 4.0 * 99


def test_bound_and_mlp():
    assert work.bound_s(67e12, 0.0) == 1.0
    assert work.bound_s(0.0, 3.35e12) == 1.0
    # [3, 4, 2] over 10 rows: 2*(12 + 8) * 10
    assert work.mlp_flops([3, 4, 2], 10) == 400.0


def test_sim_step_flops_is_b1_times_substeps():
    body = {"nv": 2, "R": 3, "n_up": 4, "n_down": 6, "nbody": 4, "nM": 5,
            "kc": 0, "solver_iterations": 1, "noslip_iterations": 1,
            "power_iters": 1, "substeps": 7}
    assert work.sim_step_flops(body, 5) == 7 * 284.0 * 5


CONFIGS = sorted({w["config"] for w in harness._load_json(
    os.path.join(harness.ROOT, "BENCHMARK.json"))["workloads"]})


@pytest.mark.parametrize("config", CONFIGS)
def test_body_sizes_match_the_reference_model(config):
    """The sizes the counters read are the reference model's own."""
    from benchmark.reference.ops import tree_ldl as TL
    from benchmark.reference.physics import forward as F
    from benchmark.reference.physics import solver_fused as SF
    cfg = json.load(open(os.path.join(harness.ROOT, "benchmark", "configs",
                                      f"{config}.json")))

    class _Cell:
        config_name = config
    _Cell.config = cfg
    env = drivers.reference_env(_Cell, "cpu", dtype=torch.float64)
    m = env.model
    st = env.reset(1, torch.Generator().manual_seed(0))
    prob = SF.assemble(m, F.smooth_forward(m, st.data))
    body = cfg["body"]
    got = {"nv": m.nv, "nbody": m.nbody, "nu": env.action_size,
           "R": prob["lay"]["R"], "kl": prob["kw"]["kl"],
           "kc": prob["kw"]["kc"], "nM": st.data.qLDh.shape[0],
           "n_up": len(TL.flat_up(m.tree)),
           "n_down": len(TL.flat_down(m.tree)),
           "substeps": env.n_substeps, "col_refresh": m.col_refresh,
           "solver_iterations": prob["kw"]["iterations"],
           "noslip_iterations": prob["kw"]["noslip_iterations"],
           "power_iters": prob["kw"]["power_iters"]}
    assert got == {k: body[k] for k in got}
    assert float(m.opt.timestep) == pytest.approx(body["physics_timestep_s"])
    assert env.task.ctrl_dt == pytest.approx(body["control_timestep_s"])
