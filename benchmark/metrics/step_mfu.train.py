"""step_mfu.train: the window's counted operations over its time and the
float32 peak, in %: B1's exact operations per substep of every env-step
the rollouts took, the actor's policy forward per env-step, and each
update's matrix products of the DMPO networks (``training.train_flops``).
The eager physics stages are not counted, so this is a floor."""

from benchmark import training, work


def read(ctx):
    if ctx.get("driver") != "train" or ctx["window_s"] <= 0:
        return None
    tc = ctx["config"]["train"]
    env_steps = ctx["iters"] * tc["num_envs"] * tc["unroll_length"]
    flops = (training.train_flops(ctx["cell"], ctx["obs_size"],
                                  ctx["action_size"], ctx["iters"],
                                  ctx["updates_per_iter"])
             + work.sim_step_flops(ctx["config"]["body"], 1) * env_steps)
    return 100.0 * flops / ctx["window_s"] / work.PEAK_F32
