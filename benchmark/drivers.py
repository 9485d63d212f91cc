"""The loops that run a traffic mix, one per ``driver`` named in a traffic
file, and the result line of a run.

``sim``: B envs in lockstep, each control step ``env.autoreset_step`` with
actions uniform over the action spec's range, drawn from the seed on the
device as a pool of batches made in set-up and used in turn. The window
runs whole control steps, each fenced by ``torch.cuda.synchronize``,
until ``seconds`` have passed; ``sim_env_steps_per_s`` is the env-steps
completed over the time from the window's start to the end of its last
step.
"""

from __future__ import annotations

import importlib
import json
import os
import random
import sys
import time

import torch

from benchmark import check, harness, trace


def seed_of(seed: int, stream: int) -> int:
    """A generator seed for one stream of draws of the run's ``--seed``
    (any whole number; 64 bits are kept)."""
    return (seed * 1000003 + stream) % (1 << 63)


def draw_index(seed: int, n: int) -> int:
    """An index in [0, n) drawn from ``seed`` on the host."""
    return random.Random(seed_of(seed, 99)).randrange(n)


def program_env(config: dict, device):
    """The program's env of a configuration, built by the factory its
    ``program`` entry names, in the configuration's dtype."""
    spec = config["program"]
    fn = getattr(importlib.import_module(spec["module"]), spec["factory"])
    return fn(device=device, dtype=getattr(torch, config["dtype"]),
              **spec.get("kwargs", {}))


def reference_env(cell, device, dtype=torch.float64, root=harness.ROOT):
    ref = harness.load_module(harness.reference_path(root, cell.config_name),
                              cell.config_name + ".reference")
    kw = cell.config["program"].get("kwargs", {})
    return ref.make_env(device, dtype=dtype, **kw)


def load_limits(workload: str, root=harness.ROOT) -> dict:
    with open(os.path.join(root, "benchmark", "limits",
                           f"{workload}.json")) as f:
        return json.load(f)["limits"]


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_sim(cell, seed: int, seconds: float, traced: bool, device,
            t_start: float, envs=None, hook=None, limits=None,
            numbers_only: bool = False, env=None, ref_env=None,
            tf32=None) -> dict:
    """One run of a ``sim`` traffic mix (see the module doc). The rest is
    for the benchmark's own tests and its calibration: ``envs`` overrides
    the traffic's batch, ``hook(env)`` may replace the program's methods,
    ``env`` runs in the program's place (the control), ``ref_env`` is a
    reference already built, ``tf32`` overrides the configuration's, and
    ``numbers_only`` returns the compared numbers alone."""
    tr = cell.traffic
    B = int(envs or tr["envs"])
    tf32 = bool(cell.config["tf32"]) if tf32 is None else tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if env is None:
        env = program_env(cell.config, device)
    if hook is not None:
        hook(env)
    lo, hi = (torch.as_tensor(x, dtype=torch.float32, device=device)
              for x in env.action_spec())
    g_act = torch.Generator(device).manual_seed(seed_of(seed, 1))
    pool = lo + (hi - lo) * torch.rand(
        (int(tr["action_pool"]), B, lo.shape[0]), generator=g_act,
        device=device)
    pool = pool.to(getattr(torch, cell.config["dtype"]))
    gen = torch.Generator(device).manual_seed(seed_of(seed, 2))
    rng0 = gen.get_state()
    # warm-up: one control step builds and loads every kernel it runs
    state = start = env.autoreset_step(env.reset(B, gen), pool[0])
    _sync(device)
    setup_s = time.time() - t_start

    spans = trace.Spans()
    if traced:
        spans.wrap(env, "reset", "reset")
        spans.wrap(env, "step", "step")
    k_check = draw_index(seed, int(tr["check_steps"]))
    n_pool = pool.shape[0]
    steps = 0
    t0 = t1 = time.perf_counter()
    ends = []
    while True:
        a = pool[(1 + steps) % n_pool]
        if steps == k_check:
            pre, pre_rng, pre_a = state, gen.get_state(), a
        state = env.autoreset_step(state, a)
        _sync(device)
        if steps == k_check:
            post = state
        steps += 1
        t1 = time.perf_counter()
        ends.append(t1)
        if t1 - t0 >= seconds and steps > k_check:
            break
    window_s = t1 - t0
    print("window: control steps s " + " ".join(
        f"{b - a:.4f}" for a, b in zip([t0] + ends, ends)), file=sys.stderr)
    dev_info = device_info(device, cell.chips)

    res = {"attempted": steps * B}
    ctx = {"cell": cell, "config": cell.config, "body": cell.config["body"],
           "B": B, "steps": steps, "window_s": window_s, "driver": "sim",
           "span_total": dict(spans.total), "span_count": dict(spans.count)}
    if traced:
        a = pool[(1 + steps) % n_pool]
        state, tr_ = trace.profile(lambda: env.autoreset_step(state, a))
        ctx["trace"] = tr_
        dev_info["busy_s"] = tr_.busy_s()
        dev_info["window_s"] = tr_.window_s
        res["breakdown"] = tr_.breakdown()
    del state

    # the check, once the window has closed and the peak has been read
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if ref_env is None:
        ref_env = reference_env(cell, device)
    g_ref = torch.Generator(device)
    g_ref.set_state(rng0)
    ref_start = ref_env.autoreset_step(ref_env.reset(B, g_ref),
                                       pool[0].double())
    numbers = check.numbers(start, ref_start, "start")
    del start, ref_start
    ref_post = ref_env.autoreset_step(check.follow(ref_env, pre, pre_rng),
                                      pre_a.double())
    numbers.update(check.numbers(post, ref_post, "step"))
    if numbers_only:
        return numbers
    limits = load_limits(cell.name) if limits is None else limits
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
        metrics = {"sim_env_steps_per_s":
                   {"value": steps * B / window_s, "unit": "env-steps/s"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    res["metrics"] = {k: v for k, v in metrics.items()
                      if any(k == m["name"] for m in
                             (cell.per_layer if traced else cell.end_to_end))}
    res["device"] = dev_info
    res["checks"] = checks
    return _ordered(res)


def _ordered(res: dict) -> dict:
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "checks")
    return {k: res[k] for k in keys if k in res}


def _train(*a, **kw):
    from benchmark.training import run_train
    return run_train(*a, **kw)


DRIVERS = {"sim": run_sim, "train": _train}


def run_cell(cell, seed, seconds, traced, device, t_start, **kw) -> dict:
    return DRIVERS[cell.traffic["driver"]](cell, seed, seconds, traced,
                                           device, t_start, **kw)
