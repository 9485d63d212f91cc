"""How ``correct`` is decided for the simulation cells.

The program's control step cannot be re-run from the seed by another
program and land on the same state: the fly's resting self-contact
cluster is chaotic, so a float32 and a float64 trajectory part after a
few steps. The reference therefore follows the program step by step
from the program's own state, and the two ends are checked apart:

* the start: the program's state after its reset from the seed and the
  warm-up control step, against the plain reference's own reset from the
  same generator state and the same step (nothing of the program's state
  is taken);
* one control step of the window, drawn from the seed: the reference,
  in float64, takes the program's state before that step (its dynamical
  state, task state, step counters and generator state) and the same
  action, runs ``autoreset_step``, and is compared with what the
  program's step produced.

Per env, the error is the largest over the compared fields (qpos, qvel,
act, every observation, reward, discount) of max |program - reference|
over the field's entries, over the largest |reference| of the field in
the whole batch (at least ``FLOOR``), and at least 1 where ``done``
differs. The numbers compared are the median and the 99th percentile of
the per-env errors of each end.
"""

from __future__ import annotations

import dataclasses

import torch

# the least scale of a field, so that a field that is all but zero in the
# reference does not turn rounding into a large relative error
FLOOR = 1e-3

# what a control step reads of the state before it: the engine's
# dynamical state (types.STATE_FIELDS) and the warm starts that carry over
# between steps (APGD's v, the convex narrowphase's lanes)
FOLLOWED = ("qpos", "qvel", "act", "ctrl", "qfrc_applied", "xfrc_applied",
            "time", "warm_sel", "warm_f", "warm_lim", "apgd_v",
            "ccd_warm_id", "ccd_warm_u")


def _cast(x, like):
    if torch.is_tensor(x):
        x = x.to(like.device)
        return x.to(like.dtype) if like.is_floating_point() else x.clone()
    return x


def fill(shell, prog):
    """``shell`` (a reference tree: dataclass, dict, tuple or tensor) with
    each leaf taken from the matching leaf of ``prog`` by field name, key
    or position, floats cast to the shell's dtype."""
    if dataclasses.is_dataclass(shell):
        return dataclasses.replace(shell, **{
            f.name: fill(getattr(shell, f.name), getattr(prog, f.name))
            for f in dataclasses.fields(shell)})
    if isinstance(shell, dict):
        return {k: fill(v, prog[k]) for k, v in shell.items()}
    if isinstance(shell, (tuple, list)):
        return type(shell)(fill(s, p) for s, p in zip(shell, prog))
    if torch.is_tensor(shell):
        return _cast(prog, shell)
    return shell


def follow(ref_env, prog_state, gen_state):
    """The reference's EnvState at the program's ``prog_state``: a shell
    from the reference's own reset (its other fields are recomputed by the
    next step), with the program's ``FOLLOWED`` fields, task state, step
    counters and episode returns, and a generator at ``gen_state``."""
    B = prog_state.done.shape[0]
    dev = ref_env.device
    shell = ref_env.reset(B, torch.Generator(dev).manual_seed(0))
    data = shell.data.replace(**{
        f: _cast(getattr(prog_state.data, f), getattr(shell.data, f))
        for f in FOLLOWED})
    gen = torch.Generator(dev)
    gen.set_state(gen_state)
    return shell.replace(
        data=data, task_state=fill(shell.task_state, prog_state.task_state),
        step_idx=prog_state.step_idx.to(dev).clone(), rng=gen,
        metrics=fill(shell.metrics, prog_state.metrics),
        done=prog_state.done.to(dev).clone(),
        reward=_cast(prog_state.reward, shell.reward),
        discount=_cast(prog_state.discount, shell.discount))


def _fields(state) -> dict:
    """name -> (B, k) float64 of every compared field."""
    out = {}
    for f in ("qpos", "qvel", "act"):
        x = getattr(state.data, f)
        out[f] = x.reshape(-1, x.shape[-1]).T
    for k, x in state.obs.items():
        out["obs." + k] = x.reshape(x.shape[0], -1)
    out["reward"] = state.reward.reshape(-1, 1)
    out["discount"] = state.discount.reshape(-1, 1)
    return {k: v.double() for k, v in out.items() if v.numel()}


def env_errors(prog_state, ref_state) -> tuple:
    """((B,) float64 per-env error, name of the field that set the
    largest, (B,) bool where ``done`` differs)."""
    p, r = _fields(prog_state), _fields(ref_state)
    dev = next(iter(r.values())).device
    worst = None
    names = sorted(r)
    per = []
    for k in names:
        pk = p[k].to(dev)
        scale = max(float(r[k].abs().max()), FLOOR)
        e = (pk - r[k]).abs().amax(dim=1) / scale
        # a non-finite program value is as wrong as it gets
        e = torch.where(torch.isfinite(pk).all(dim=1), e,
                        torch.full_like(e, float("inf")))
        per.append(e)
    per = torch.stack(per)                      # (fields, B)
    err, arg = per.max(dim=0)
    worst = names[int(arg[int(err.argmax())])]
    flips = prog_state.done.to(dev) != ref_state.done
    return err, worst, flips


def numbers(prog_state, ref_state, prefix: str) -> dict:
    """The per-env errors of one compared state by their median and 99th
    percentile, under ``<prefix>_*`` names; an env whose ``done`` differs
    counts as an error of at least 1. The largest error and the flips are
    kept for diagnosis (names with a leading ``_``): a few envs of a
    sound run part by chaos within one step, so the largest swings."""
    err, worst, flips = env_errors(prog_state, ref_state)
    err = torch.maximum(err, flips.to(err.dtype))
    return {f"{prefix}_err_median": float(err.median()),
            f"{prefix}_err_p99": float(torch.quantile(err, 0.99)),
            f"_{prefix}_err_max": float(err.max()),
            f"_{prefix}_done_flips": int(flips.sum()),
            f"_{prefix}_field": worst}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) of every limited number; a
    number over its limit, or missing, or not finite, fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        out[name] = {"value": v, "limit": limit}
    return ok, out
