"""DMPO training entry point of the PyTorch port (reference
train_dmpo_ray.py): batched rollout, on-device replay and the learner on
one device, or on one device per rank under torchrun. Usage:

    python -m flybody_tpu_torch.train_dmpo --task walk_on_ball \
        --num-envs 256 --iterations 1000 --log-every 10 [--test]

It runs on "cuda" and raises without it unless ``--device cpu`` is given.
``--test`` runs a small smoke configuration printing stats. The flags are
those of the JAX package's train_dmpo.py. Every task of the JAX CLI is
ported (the two tracking tasks, rodent_walk_imitation and walk_humanoid,
on their synthetic clips, as the JAX CLI builds them), with the plain,
intention (``--network intention`` and its five flags) and vision
(``--network vision``) networks, multi-task training (``--task-envs
task:n,task:n`` or a YAML ``task_envs``), decoder transfer
(``--transfer-ckpt``: restore a donor's decoder and freeze it) and
kickstarting (``--kickstart-ckpt``). The rodent's egocentric camera is
reached through the Python API (``rodent_envs.*(use_vision=True)``), as in
the JAX package.

Under torchrun it trains data-parallel over one process per GPU:

    torchrun --nproc_per_node 4 -m flybody_tpu_torch.train_dmpo ...

Each rank runs on ``cuda:LOCAL_RANK`` (``--device cpu``: gloo on the
CPU); ``--num-envs`` and the config's sizes stay global, as in the JAX
CLI. Rank 0 alone logs, writes the CSV and saves checkpoints; every rank
resumes and loads ``--transfer-ckpt`` / ``--kickstart-ckpt``, and the
logged metrics are averaged over the ranks.
"""

from __future__ import annotations

import argparse
import math
import time

TASKS = ("walk_on_ball", "template", "walk_imitation", "flight_imitation",
         "vision_guided_flight", "rodent_escape_bowl", "rodent_run_gaps",
         "rodent_maze_forage", "rodent_two_touch", "rodent_walk_imitation",
         "walk_humanoid")

# the tasks by CLI name -> factory of fly_envs (of rodent_envs for the
# rodent and humanoid tasks)
FLY_TASKS = {"walk_on_ball": "walk_on_ball", "template": "template_task",
             "walk_imitation": "walk_imitation",
             "flight_imitation": "flight_imitation",
             "vision_guided_flight": "vision_guided_flight"}

# flags read only by the intention network, with their defaults: another
# value with another network raises rather than being dropped
INTENTION_FLAGS = {"encoder_layers": "512,512",
                   "decoder_layers": "512,512,512", "intention_size": 60,
                   "high_level_intention_size": 0, "intention_kl_weight": 0.0}


def make_env(name: str, device):
    from flybody_tpu_torch import fly_envs, rodent_envs
    if name not in TASKS:
        raise ValueError(f"unknown task {name!r}")
    if name in FLY_TASKS:
        return getattr(fly_envs, FLY_TASKS[name])(device=device)
    return getattr(rodent_envs, name)(device=device)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--task", default="walk_on_ball", choices=sorted(TASKS))
    p.add_argument("--task-envs", default="",
                   help="multi-task mode: 'task:num_envs,task:num_envs'")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    p.add_argument("--num-envs", type=int, default=256)
    p.add_argument("--unroll-length", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--iterations", type=int, default=1000)
    p.add_argument("--replay-capacity", type=int, default=1_000_000)
    p.add_argument("--min-replay-size", type=int, default=10_000)
    p.add_argument("--samples-per-insert", type=float, default=32.0)
    p.add_argument("--n-step", type=int, default=5)
    # learner hyperparameters (reference ray_distributed_dmpo.py:44-82)
    p.add_argument("--policy-lr", type=float, default=1e-4)
    p.add_argument("--critic-lr", type=float, default=1e-4)
    p.add_argument("--dual-lr", type=float, default=1e-3)
    p.add_argument("--discount", type=float, default=0.99)
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--target-policy-update-period", type=int, default=101)
    p.add_argument("--target-critic-update-period", type=int, default=107)
    p.add_argument("--clip-global-norm", type=float, default=40.0)
    # network shapes (reference network_factory.py:89-113)
    p.add_argument("--policy-layers", default="256,256,256")
    p.add_argument("--critic-layers", default="512,512,256")
    p.add_argument("--encoder-layers",
                   default=INTENTION_FLAGS["encoder_layers"])
    p.add_argument("--decoder-layers",
                   default=INTENTION_FLAGS["decoder_layers"])
    p.add_argument("--vmin", type=float, default=-150.0)
    p.add_argument("--vmax", type=float, default=150.0)
    p.add_argument("--num-atoms", type=int, default=51)
    p.add_argument("--action-delay", type=int, default=0)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-minutes", type=float, default=30.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--network", default="plain",
                   choices=("plain", "intention", "vision"),
                   help="network factory mode (reference "
                        "intention_network_factory / vis_net)")
    p.add_argument("--intention-size", type=int,
                   default=INTENTION_FLAGS["intention_size"])
    p.add_argument("--high-level-intention-size", type=int,
                   default=INTENTION_FLAGS["high_level_intention_size"],
                   help="two-level encoder's high-level latent (0: one "
                        "level)")
    p.add_argument("--intention-kl-weight", type=float,
                   default=INTENTION_FLAGS["intention_kl_weight"])
    p.add_argument("--kickstart-ckpt", default="",
                   help="teacher policy checkpoint for kickstarting")
    p.add_argument("--kickstart-epsilon", type=float, default=0.01)
    p.add_argument("--transfer-ckpt", default="",
                   help="donor checkpoint: restore decoder + freeze "
                        "(reference bowl-transfer config)")
    p.add_argument("--config", default="",
                   help="YAML run config (overrides CLI defaults; "
                        "reference vnl_ray/config/*.yaml)")
    p.add_argument("--test", action="store_true",
                   help="small smoke configuration")
    args = p.parse_args(argv)
    if args.config:
        from flybody_tpu_torch.utils.config import apply_yaml_config
        apply_yaml_config(args, args.config)
    if args.test:
        args.num_envs = 8
        args.unroll_length = 10
        args.batch_size = 32
        args.min_replay_size = 64
        args.replay_capacity = 10_000
        args.iterations = min(args.iterations, 20)
        args.log_every = 1
    return args


def layers(s):
    if isinstance(s, (list, tuple)):
        return tuple(int(x) for x in s)
    return tuple(int(x) for x in str(s).split(",") if str(x).strip())


def task_envs_of(args) -> dict:
    """The multi-task spec {task: num_envs}: a dict from YAML
    (task_envs / actors_envs) or "task:n,task:n" from the command line;
    tasks with 0 envs are dropped, and --test gives each task 8."""
    spec = args.task_envs
    if isinstance(spec, str):
        spec = {kv.split(":")[0].strip(): int(kv.split(":")[1])
                for kv in spec.split(",") if kv.strip()}
    spec = {k: int(n) for k, n in (spec or {}).items() if int(n) > 0}
    if args.test:
        spec = {k: 8 for k in spec}
    return spec


def build_trainer(args, cfg):
    """DMPOTrainer on --task, or MultiTaskDMPOTrainer over --task-envs."""
    from flybody_tpu_torch.agents.train import DMPOTrainer
    task_envs = task_envs_of(args)
    if task_envs:
        # multi-task generalist: a batch of envs and a replay table per
        # task, one round-robin learner (reference train_dmpo_ray.py
        # actors_envs topology)
        from flybody_tpu_torch.agents.multitask import MultiTaskDMPOTrainer
        envs = {k: make_env(k, args.device) for k in task_envs}
        return MultiTaskDMPOTrainer(envs, task_envs, cfg)
    return DMPOTrainer(make_env(args.task, args.device), cfg)


def trainer_config(args):
    """The TrainerConfig of the parsed arguments ``args``."""
    from flybody_tpu_torch.agents.dmpo import DMPOConfig
    from flybody_tpu_torch.agents.train import TrainerConfig
    return TrainerConfig(
        num_envs=args.num_envs, unroll_length=args.unroll_length,
        replay_capacity=args.replay_capacity,
        min_replay_size=args.min_replay_size,
        samples_per_insert=args.samples_per_insert,
        network=args.network,
        intention_size=args.intention_size,
        high_level_intention_size=(args.high_level_intention_size or None),
        freeze_decoder=bool(args.transfer_ckpt),
        policy_layers=layers(args.policy_layers),
        critic_layers=layers(args.critic_layers),
        encoder_layers=layers(args.encoder_layers),
        decoder_layers=layers(args.decoder_layers),
        vmin=args.vmin, vmax=args.vmax, num_atoms=args.num_atoms,
        action_delay=args.action_delay,
        dmpo=DMPOConfig(batch_size=args.batch_size, n_step=args.n_step,
                        discount=args.discount,
                        num_samples=args.num_samples,
                        policy_lr=args.policy_lr, critic_lr=args.critic_lr,
                        dual_lr=args.dual_lr,
                        clip_global_norm=args.clip_global_norm,
                        target_policy_update_period=(
                            args.target_policy_update_period),
                        target_critic_update_period=(
                            args.target_critic_update_period),
                        intention_kl_weight=args.intention_kl_weight))


def main(argv=None):
    args = parse_args(argv)
    if args.network != "intention":
        for k, default in INTENTION_FLAGS.items():
            v = getattr(args, k)
            if (layers(v) != layers(default) if k.endswith("_layers")
                    else v != default):
                raise ValueError(f"--{k.replace('_', '-')} is read only by "
                                 "--network intention")
    from flybody_tpu_torch.io import checkpoint as ckpt
    from flybody_tpu_torch.parallel import distributed as D
    from flybody_tpu_torch.utils.loggers import (Dispatcher,
                                                 make_default_logger)

    # under torchrun: join the group (a no-op for one process), one GPU
    # per rank
    owns_group = not D.in_group() and D.init(args.device)
    args.device = D.rank_device(args.device)
    lead = D.rank() == 0
    say = print if lead else (lambda *a, **k: None)
    cfg = trainer_config(args)
    trainer = build_trainer(args, cfg)
    tasks = ",".join(getattr(trainer, "names", (args.task,)))
    say(f"task {tasks}: {trainer.obs_size} observation floats, "
        f"{trainer.action_size} actions, network {args.network}, on "
        f"{trainer.device}" + (f", {D.world_size()} ranks"
                               if D.in_group() else ""), flush=True)
    if args.kickstart_ckpt:
        trainer.load_teacher(ckpt.restore_policy_params(args.kickstart_ckpt),
                             args.kickstart_epsilon)
    logger = make_default_logger(
        "learner", save_csv=bool(args.ckpt_dir),
        csv_dir=args.ckpt_dir or "logs") if lead else Dispatcher([])

    loop = D.make_global_loop_state(trainer, args.seed)
    if args.transfer_ckpt:
        trainer.restore_decoder(
            loop.train, ckpt.restore_policy_params(args.transfer_ckpt))
        say(f"transfer: decoder restored from {args.transfer_ckpt} and "
            "frozen", flush=True)
    ckptr = (ckpt.PeriodicCheckpointer(args.ckpt_dir, args.ckpt_minutes)
             if args.ckpt_dir and lead else None)
    # checkpoints carry the learner state only (networks, optimizers,
    # duals, step counters): the replay ring is GBs, and a resumed run
    # refills it through the min_replay gate
    ckpt_view = lambda lp: {"train": lp.train,
                            "actor_steps": lp.actor_steps}
    resume = ckpt.latest(args.ckpt_dir) if args.ckpt_dir else None
    if resume:
        try:
            loop.actor_steps = ckpt.restore(resume,
                                            ckpt_view(loop))["actor_steps"]
            trainer.rank_learner_generator(loop.train)
            say(f"resumed from {resume}")
        except ValueError as e:
            say(f"WARNING: checkpoint {resume} does not match the current "
                f"run structure ({e}); starting fresh")

    t0 = time.time()
    steps0 = loop.actor_steps
    for it in range(args.iterations):
        loop, metrics = trainer.train_iteration(loop)
        if (it + 1) % args.log_every == 0:
            critic_loss = float(metrics["critic_loss"])
            dt = time.time() - t0
            sps = (loop.actor_steps - steps0) / max(dt, 1e-9)
            t0, steps0 = time.time(), loop.actor_steps
            logger.write(D.host_allreduce_metrics({
                "iteration": it + 1,
                "actor_steps": loop.actor_steps,
                "learner_steps": metrics["learner_steps"],
                "actor_sps": sps,
                "episode_return": metrics["mean_episode_return"],
                "reward": metrics["mean_reward"],
                "critic_loss": critic_loss,
                "dual_temperature": metrics["dual_temperature"],
                "obs_absmax": metrics["obs_absmax"],
                **({"intention_kl": metrics["intention_kl"]}
                   if "intention_kl" in metrics else {}),
            }))
            if metrics["learner_steps"] > 0 and not math.isfinite(
                    critic_loss):
                # the same global loss on every rank: all stop here
                say("FATAL: non-finite learner stats; aborting run")
                logger.close()
                return _finish(1, owns_group)
        if ckptr is not None:
            ckptr.maybe_save(ckpt_view(loop), it)
    logger.close()
    return _finish(0, owns_group)


def _finish(rc: int, owns_group: bool) -> int:
    if owns_group:
        import torch.distributed as dist
        dist.destroy_process_group()
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
