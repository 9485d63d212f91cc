"""The reference config two_tasks (run-gaps and escape-bowl) through the
port's training CLI on the CPU, in its --test cut: 8 envs per task, unroll
10, batch 32, one iteration."""

from test_torch_rodent_train import _cli


def test_cli_two_tasks_config():
    """configs/train_config_two_tasks.yaml (run-gaps and escape-bowl, one
    learner over a replay table each) trains one --test iteration: both
    tasks' 162 observation floats, two tables of 80 updates."""
    out, line = _cli("--config", "configs/train_config_two_tasks.yaml")
    assert ("task rodent_escape_bowl,rodent_run_gaps: 162 observation "
            "floats, 38 actions") in out, out
    assert "learner_steps=160" in line, line
