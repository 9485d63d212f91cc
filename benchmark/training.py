"""The ``train`` driver: DMPO training of a configuration at its published
sizes, and how ``correct`` is decided for it.

Set-up builds one trainer through the program's own CLI functions
(``train_dmpo.parse_args``, ``trainer_config``, ``build_trainer``) with
every value of the configuration's ``train`` group given as an explicit
flag, writes the benchmark's weights (drawn from the seed on the device)
into its networks, and runs one warm iteration: a rollout, its insert
(the ring's gate is one insert), and the iteration's updates. The window
then runs whole ``train_iteration``s, each fenced by a synchronise, until
``seconds`` have passed; ``train_env_steps_per_s`` is the env-steps they
collected over the time from the window's start to the end of the last.

While the warm iteration runs, the benchmark records (wrapping methods on
the instances, never editing the program) what the reference needs to
follow it: each rollout step's observations, generator states, actions
and env states, the first three sampled batches' generator states, and
the learner's state after its first and third update. Once the window has
closed the plain float64 reference (``benchmark/reference``) checks

* ``policy_err``: the rollout's actions against the reference policy's
  samples (same observations, same normals), as a share of the action
  range;
* ``rollout_err_median``: one rollout step drawn from the seed, followed
  from the program's env state as the sim cells follow a step;
* ``batch_err``: the first three sampled batches against the reference's
  own n-step transitions of the rollout, gathered at the reference's own
  draw of indices (n-step assembly, insert and sample);
* ``loss_gap``: each of the first three updates' critic and policy loss;
* ``grad_gap``: the first gradient as Adam got it (its first moment after
  one step), leaf by leaf, by norm;
* ``change_gap``: each leaf's change over the three updates, by norm.

Gaps of norms are |program - reference| over the larger of the
reference's norm of that leaf and of the median leaf; leaves whose
reference gradient is under a thousandth of the median leaf's are left
out of ``change_gap`` (Adam moves them by round-off alone).
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import check, trace, work

BETA1 = 0.9          # torch.optim.Adam's default, as the program builds it
N_FOLLOWED = 3       # updates the reference follows


def trainer_argv(tc: dict, device: str, seed: int) -> list:
    """The configuration's ``train`` values as explicit CLI flags."""
    flags = {"task": tc["task"], "device": device,
             "num-envs": tc["num_envs"], "unroll-length": tc["unroll_length"],
             "batch-size": tc["batch_size"],
             "replay-capacity": tc["replay_capacity"],
             "min-replay-size": tc["min_replay_size"],
             "samples-per-insert": tc["samples_per_insert"],
             "n-step": tc["n_step"], "policy-lr": tc["policy_lr"],
             "critic-lr": tc["critic_lr"], "dual-lr": tc["dual_lr"],
             "discount": tc["discount"], "num-samples": tc["num_samples"],
             "target-policy-update-period":
                 tc["target_policy_update_period"],
             "target-critic-update-period":
                 tc["target_critic_update_period"],
             "clip-global-norm": tc["clip_global_norm"],
             "policy-layers": ",".join(map(str, tc["policy_layers"])),
             "critic-layers": ",".join(map(str, tc["critic_layers"])),
             "vmin": tc["vmin"], "vmax": tc["vmax"],
             "num-atoms": tc["num_atoms"], "network": tc["network"],
             "seed": seed}
    argv = []
    for k, v in flags.items():
        argv += [f"--{k}", str(v)]
    return argv


# --------------------------------------------------------------------------
# the benchmark's weights
# --------------------------------------------------------------------------


def _scale(name: str) -> float:
    """Variance scale of a dense kernel (the published networks' init:
    1e-4 for the policy head, 1 elsewhere)."""
    return 1e-4 if name.startswith("head.") else 1.0


def make_weights(nets: dict, seed: int, device) -> dict:
    """{net: {param name: tensor}} for ``nets`` ({name: module}), drawn
    from ``seed`` on ``device`` in one call: every 2-d kernel a normal
    truncated at two standard deviations with variance scale / fan_in,
    LayerNorm scales 1, biases 0."""
    kernels = [(n, k, p) for n, m in sorted(nets.items())
               for k, p in sorted(m.named_parameters()) if p.ndim == 2]
    total = sum(p.numel() for _, _, p in kernels)
    g = torch.Generator(device).manual_seed(seed)
    z = torch.randn((total,), generator=g, device=device).clamp_(-2.0, 2.0)
    out = {n: {} for n in nets}
    at = 0
    for n, k, p in kernels:
        std = math.sqrt(_scale(k) / p.shape[1]) / 0.87962566103423978
        out[n][k] = (z[at:at + p.numel()].view(p.shape) * std)
        at += p.numel()
    for n, m in nets.items():
        for k, p in m.named_parameters():
            if p.ndim != 2:
                out[n][k] = torch.ones(p.shape, device=device) \
                    if k.endswith("norm.weight") else \
                    torch.zeros(p.shape, device=device)
    return out


@torch.no_grad()
def load_weights(module, weights: dict) -> None:
    for k, p in module.named_parameters():
        p.copy_(weights[k].to(p.dtype))


# --------------------------------------------------------------------------
# recording the warm iteration
# --------------------------------------------------------------------------


class Recorder:
    """Wraps methods of the trainer's instances for one iteration and
    keeps what the reference follows; ``close`` puts the methods back."""

    def __init__(self, trainer, loop, n_followed: int = N_FOLLOWED):
        self.n = n_followed
        self.policy_in, self.env_pre, self.env_post = [], [], []
        self.sample_gen, self.batches = [], []
        self.update_gen, self.stats = [], []
        self.adam1 = self.params3 = None
        self._undo = []
        self._in_rollout = False
        gen = loop.generator
        env, train, replay = trainer.env, loop.train, loop.replay

        def rollout(fn):
            def w(*a, **kw):
                self._in_rollout = True
                try:
                    return fn(*a, **kw)
                finally:
                    self._in_rollout = False
            return w

        def policy(fn):
            def w(obs, *a, **kw):
                if self._in_rollout:
                    self.policy_in.append((obs.clone(), gen.get_state()))
                return fn(obs, *a, **kw)
            return w

        def step(fn):
            def w(state, action):
                self.env_pre.append((state, gen.get_state(), action.clone()))
                return fn(state, action)
            return w

        def autoreset(fn):
            def w(state):
                out = fn(state)
                self.env_post.append((state, out))
                return out
            return w

        def sample(fn):
            def w(g, batch_size):
                if len(self.batches) < self.n:
                    st = g.get_state()
                    out = fn(g, batch_size)
                    self.sample_gen.append((st, replay.size))
                    self.batches.append(out)
                    return out
                return fn(g, batch_size)
            return w

        def update(fn):
            def w(state, batch, *a, **kw):
                k = len(self.stats)
                if k >= self.n:
                    return fn(state, batch, *a, **kw)
                self.update_gen.append(state.generator.get_state())
                out = fn(state, batch, *a, **kw)
                self.stats.append({s: float(out[s]) for s in
                                   ("critic_loss", "policy_loss_total")})
                if k == 0:
                    self.adam1 = adam_first_moments(state)
                if k == self.n - 1:
                    self.params3 = leaf_params(state)
                return out
            return w

        self._wrap(trainer, "rollout_fn", rollout)
        self._wrap(train.policy, "forward", policy)
        self._wrap(env, "step", step)
        self._wrap(env, "apply_autoreset", autoreset)
        self._wrap(replay, "sample", sample)
        self._wrap(trainer.learner, "update", update)

    def _wrap(self, obj, attr, make):
        had = attr in vars(obj)
        old = getattr(obj, attr)
        setattr(obj, attr, make(old))
        self._undo.append((obj, attr, had, old))

    def close(self):
        """Put the wrapped methods back and let go of the instances, so
        the trainer's ring is freed with the trainer."""
        for obj, attr, had, old in reversed(self._undo):
            if had:
                setattr(obj, attr, old)
            else:
                delattr(obj, attr)
        self._undo = []


def _leaves(state) -> list:
    """[(name, tensor)] of every learned leaf of a TrainState."""
    out = [("policy." + k, p) for k, p in state.policy.named_parameters()]
    out += [("critic." + k, p) for k, p in state.critic.named_parameters()]
    d = state.dual_params
    out += [("dual." + f, getattr(d, f)) for f in
            ("log_temperature", "log_alpha_mean", "log_alpha_stddev",
             "log_penalty_temperature")]
    return out


def adam_first_moments(state) -> dict:
    """Each leaf's gradient as Adam got it in its first step: the first
    moment after one step over (1 - beta1); zero where Adam holds no
    state for the leaf (it never stepped it)."""
    opt_state = {}
    for opt in (state.policy_opt, state.critic_opt, state.dual_opt):
        opt_state.update(opt.state)
    return {n: (opt_state[p]["exp_avg"] / (1 - BETA1)).detach().clone()
            if p in opt_state else torch.zeros_like(p.detach())
            for n, p in _leaves(state)}


def leaf_params(state) -> dict:
    return {n: p.detach().clone() for n, p in _leaves(state)}


# --------------------------------------------------------------------------
# the driver
# --------------------------------------------------------------------------


def build(cell, device, seed):
    from flybody_tpu_torch import train_dmpo
    from benchmark.drivers import seed_of
    tc = cell.config["train"]
    args = train_dmpo.parse_args(trainer_argv(tc, device,
                                              seed_of(seed, 3) % (1 << 62)))
    trainer = train_dmpo.build_trainer(args, train_dmpo.trainer_config(args))
    loop = trainer.init(args.seed)
    t = loop.train
    weights = make_weights({"policy": t.policy, "critic": t.critic},
                           seed_of(seed, 4), device)
    for net, w in (("policy", t.policy), ("critic", t.critic),
                   ("policy", t.target_policy), ("critic", t.target_critic)):
        load_weights(w, weights[net])
    return trainer, loop, weights


def run_train(cell, seed: int, seconds: float, traced: bool, device,
              t_start: float, hook=None, limits=None,
              numbers_only: bool = False, tf32=None, control=False,
              **_) -> dict:
    """One run of a ``train`` traffic mix (see the module doc). ``hook``,
    ``numbers_only``, ``tf32`` and ``control`` serve the benchmark's tests
    and its calibration: ``numbers_only`` returns (the compared numbers,
    the control's numbers where ``control``, else None)."""
    from benchmark import drivers
    tf32 = bool(cell.config["tf32"]) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    trainer, loop, weights = build(cell, device, seed)
    if hook is not None:
        hook(trainer, loop)
    rec = Recorder(trainer, loop)
    loop, _ = trainer.train_iteration(loop)
    rec.close()
    drivers._sync(device)
    setup_s = time.time() - t_start

    spans = trace.Spans()
    if traced:
        spans.wrap(trainer, "rollout_fn", "rollout", fence=True)
        spans.wrap(trainer.learner, "update", "update", fence=True)
        spans.wrap(loop.replay, "insert", "insert")
    per_iter = trainer.cfg.num_envs * trainer.cfg.unroll_length
    iters = 0
    t0 = t1 = time.perf_counter()
    # the readings need no window: the calibration asks for none
    while not (numbers_only and seconds <= 0):
        loop, _ = trainer.train_iteration(loop)
        drivers._sync(device)
        iters += 1
        t1 = time.perf_counter()
        if t1 - t0 >= seconds:
            break
    window_s = t1 - t0
    dev_info = drivers.device_info(device, cell.chips)
    res = {"attempted": iters * per_iter}
    ctx = {"cell": cell, "config": cell.config, "driver": "train",
           "iters": iters, "window_s": window_s,
           "updates_per_iter": trainer.updates_per_iter,
           "span_total": dict(spans.total), "span_count": dict(spans.count),
           "obs_size": trainer.obs_size, "action_size": trainer.action_size}
    if traced:
        tr = _traced_tail(trainer, loop)
        ctx["trace"] = tr
        dev_info["busy_s"] = tr.busy_s()
        dev_info["window_s"] = tr.window_s
        res["breakdown"] = tr.breakdown()
    obs_size, action_size = trainer.obs_size, trainer.action_size
    keys = trainer.obs_keys
    # the program's state freed before the reference runs (the spans'
    # wrappers tie the trainer into reference cycles)
    del loop, trainer
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    numbers, ctl = follow_checks(cell, rec, weights, device, seed, obs_size,
                                 action_size, keys, control=control)
    if numbers_only:
        return numbers, ctl
    limits = drivers.load_limits(cell.name) if limits is None else limits
    ok, checks = check.judge(numbers, limits)
    res["correct"] = ok
    res["failed"] = 0 if ok else 1
    if traced:
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {"train_env_steps_per_s":
                   {"value": iters * per_iter / window_s,
                    "unit": "env-steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    res["metrics"] = {k: v for k, v in metrics.items() if k in names}
    res["device"] = dev_info
    res["checks"] = checks
    return drivers._ordered(res)


def _traced_tail(trainer, loop):
    """One more iteration, its last rollout step and its updates under
    the profiler."""
    prof = {"p": None, "t0": 0.0}
    unroll = trainer.cfg.unroll_length
    env = trainer.env
    calls = {"n": 0}
    step = env.step

    def step_then_trace(state, action):
        calls["n"] += 1
        if calls["n"] == unroll:
            prof["p"] = trace.start()
            prof["t0"] = time.perf_counter()
        return step(state, action)

    env.step = step_then_trace
    try:
        trainer.train_iteration(loop)
        trace._sync()
        window = time.perf_counter() - prof["t0"]
    finally:
        del env.step
    return trace.finish(prof["p"], window)


# --------------------------------------------------------------------------
# the reference's checks
# --------------------------------------------------------------------------


def _ref_nets(cell, obs_size, action_size, device, dtype, weights):
    from benchmark.reference.agents import networks as N
    tc = cell.config["train"]
    policy, critic = N.make_policy_critic(
        action_size, obs_size, policy_layers=tuple(tc["policy_layers"]),
        critic_layers=tuple(tc["critic_layers"]), vmin=tc["vmin"],
        vmax=tc["vmax"], num_atoms=tc["num_atoms"])
    policy, critic = policy.to(device, dtype), critic.to(device, dtype)
    load_weights(policy, weights["policy"])
    load_weights(critic, weights["critic"])
    return policy, critic


def _gap(p: float, r: float, floor: float) -> float:
    return abs(p - r) / max(abs(r), floor)


def norm_gaps(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)| over the larger
    of the reference leaf's norm and the median leaf's."""
    names = [n for n in ref if keep is None or keep[n]]
    rn = {n: float(ref[n].double().norm()) for n in names}
    med = sorted(rn.values())[len(rn) // 2]
    return max(_gap(float(prog[n].double().norm()), rn[n], med)
               for n in names)


class Side:
    """One side's outputs of what the reference checks: the policy's
    actions, the followed rollout step, the batches and the three
    updates."""

    def __init__(self):
        self.actions, self.step, self.batches = None, None, None
        self.stats, self.grads, self.change = None, None, None
        self.start = None


def reference_side(cell, rec, weights, device, dtype, tf32, obs_size,
                   action_size, keys, k_step, ref_env) -> Side:
    """The reference's outputs in ``dtype`` (float64; the control:
    float32 with ``tf32``), from the recorded inputs."""
    from benchmark.reference.agents import actors as RA
    from benchmark.reference.agents import dmpo as RD
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    tc = cell.config["train"]
    side = Side()
    policy, critic = _ref_nets(cell, obs_size, action_size, device, dtype,
                               weights)
    lo, hi = (torch.as_tensor(x, dtype=dtype, device=device)
              for x in ref_env.action_spec())
    g = torch.Generator(device)
    canon = []
    with torch.no_grad():
        for obs, st in rec.policy_in:
            g.set_state(st)
            canon.append(policy(obs.to(dtype)).sample(g))
    side.actions = torch.stack([RA.canonical_to_real(a, lo, hi)
                                for a in canon])
    # the followed rollout step
    state, gst, action = rec.env_pre[k_step]
    side.step = ref_env.apply_autoreset(ref_env.step(
        check.follow(ref_env, state, gst), action.to(dtype)))
    # n-step transitions of the recorded rollout, then the batches
    cfg = RA.RolloutConfig(unroll_length=tc["unroll_length"],
                           n_step=tc["n_step"], discount=tc["discount"])
    flat = lambda o: RA.flat_obs({k: v.to(device) for k, v in o.items()},
                                 keys).to(dtype)
    B = rec.env_pre[0][0].done.shape[0]
    traj = {"obs": [], "action": [], "reward": [], "discount": [],
            "done": [], "obs_after": [], "episode_return": []}
    for (pre, _, _), (stepped, _) in zip(rec.env_pre, rec.env_post):
        traj["obs"].append(flat(pre.obs))
        traj["reward"].append(stepped.reward.to(dtype))
        traj["discount"].append(stepped.discount.to(dtype))
        traj["done"].append(stepped.done)
        traj["obs_after"].append(flat(stepped.obs))
        traj["episode_return"].append(stepped.reward.to(dtype))
    traj["action"] = canon
    traj = {k: torch.stack(v) for k, v in traj.items()}
    tail = RA.init_rollout_tail(cfg, B, traj["obs"].shape[-1],
                                traj["action"].shape[-1], dtype=dtype,
                                device=device)
    full = {k: torch.cat([tail[k], traj[k]]) for k in traj}
    tr = RA.nstep_from_trajectory(full, cfg)
    side.batches = []
    for st, size in rec.sample_gen:
        g.set_state(st)
        idx = torch.randint(0, max(size, 1), (tc["batch_size"],),
                            generator=g, device=device)
        side.batches.append(RD.Transition(
            obs=tr.obs[idx], action=tr.action[idx], reward=tr.reward[idx],
            discount=tr.discount[idx], next_obs=tr.next_obs[idx]))
    # the three updates, from the benchmark's weights
    dcfg = RD.DMPOConfig(
        batch_size=tc["batch_size"], n_step=tc["n_step"],
        discount=tc["discount"], num_samples=tc["num_samples"],
        policy_lr=tc["policy_lr"], critic_lr=tc["critic_lr"],
        dual_lr=tc["dual_lr"], clip_global_norm=tc["clip_global_norm"],
        target_policy_update_period=tc["target_policy_update_period"],
        target_critic_update_period=tc["target_critic_update_period"])
    learner = RD.DMPOLearner(policy, critic, action_size, obs_size, dcfg)
    state = learner.init(torch.Generator().manual_seed(0))
    for net, w in (("policy", state.policy), ("critic", state.critic),
                   ("policy", state.target_policy),
                   ("critic", state.target_critic)):
        load_weights(w, weights[net])
    side.start = before = leaf_params(state)
    side.stats = []
    for k, batch in enumerate(side.batches):
        state.generator.set_state(rec.update_gen[k])
        out = learner.update(state, batch)
        side.stats.append({s: float(out[s]) for s in
                           ("critic_loss", "policy_loss_total")})
        if k == 0:
            side.grads = adam_first_moments(state)
    after = leaf_params(state)
    side.change = {n: after[n] - before[n] for n in after}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return side


def compare(side: Side, ref: Side, lo, hi) -> dict:
    """The compared numbers of ``side`` (the program's, or the control's)
    against the float64 reference."""
    out = {}
    rng = (hi - lo).double()
    out["policy_err"] = float(((side.actions.double() - ref.actions)
                               .abs() / rng).max())
    out["rollout_err_median"] = check.numbers(
        side.step, ref.step, "rollout")["rollout_err_median"]
    berr = 0.0
    for b, r in zip(side.batches, ref.batches):
        for f in ("obs", "action", "reward", "discount", "next_obs"):
            x, y = getattr(b, f).double(), getattr(r, f).double()
            berr = max(berr, float((x - y).abs().max())
                       / max(float(y.abs().max()), check.FLOOR))
    out["batch_err"] = berr
    out["loss_gap"] = max(_gap(s[k], r[k], 1e-3)
                          for s, r in zip(side.stats, ref.stats)
                          for k in s)
    out["grad_gap"] = norm_gaps(side.grads, ref.grads)
    gn = {n: float(g.double().norm()) for n, g in ref.grads.items()}
    med = sorted(gn.values())[len(gn) // 2]
    keep = {n: gn[n] >= 1e-3 * med for n in gn}
    out["change_gap"] = norm_gaps(side.change, ref.change, keep)
    return out


def program_side(rec, ref: Side) -> Side:
    """The program's recorded outputs; its change over the three updates
    is taken from the start the reference loaded, the same weights and
    dual constants."""
    side = Side()
    side.actions = torch.stack([a for _, _, a in rec.env_pre])
    side.batches = rec.batches
    side.stats = rec.stats
    side.grads = rec.adam1
    side.change = {n: p.double() - ref.start[n].double()
                   for n, p in rec.params3.items()}
    return side


def follow_checks(cell, rec, weights, device, seed, obs_size, action_size,
                  keys, control=False):
    """(the program's numbers, the control's numbers or None)."""
    from benchmark import drivers
    k_step = drivers.draw_index(seed, len(rec.env_pre))
    ref_env = drivers.reference_env(cell, device)
    ref = reference_side(cell, rec, weights, device, torch.float64, False,
                         obs_size, action_size, keys, k_step, ref_env)
    prog = program_side(rec, ref)
    prog.step = rec.env_post[k_step][1]
    lo, hi = (torch.as_tensor(x, dtype=torch.float64, device=device)
              for x in ref_env.action_spec())
    numbers = compare(prog, ref, lo, hi)
    ctl = None
    if control:
        low_env = drivers.reference_env(cell, device, dtype=torch.float32)
        low = reference_side(cell, rec, weights, device, torch.float32, True,
                             obs_size, action_size, keys, k_step, low_env)
        ctl = compare(low, ref, lo, hi)
    return numbers, ctl


def train_flops(cell, obs_size: int, action_size: int, iters: int,
                updates_per_iter: int) -> float:
    """Counted operations of ``iters`` iterations: the actor's policy
    forward per env-step, and per update the online critic and policy
    forward and backward (3 x forward), the target policy forward and the
    target critic over the N sampled actions per row."""
    tc = cell.config["train"]
    pol = [obs_size] + list(tc["policy_layers"])
    crit = [obs_size + action_size] + list(tc["critic_layers"])
    head = 2 * 2 * tc["policy_layers"][-1] * action_size     # mean, scale
    logits = 2 * tc["critic_layers"][-1] * tc["num_atoms"]
    pf = lambda rows: work.mlp_flops(pol, rows) + head * rows
    cf = lambda rows: work.mlp_flops(crit, rows) + logits * rows
    bs, n = tc["batch_size"], tc["num_samples"]
    actor = tc["num_envs"] * tc["unroll_length"] * pf(1)
    update = 3 * cf(bs) + 3 * pf(bs) + pf(bs) + cf(n * bs)
    return iters * (actor + updates_per_iter * update)
