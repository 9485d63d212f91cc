"""Faults planted under a run's timed path, for the benchmark's own tests
and for reading the faults' numbers at a cell's size on the card
(``calibrate --fault``). Each returns a hook that a driver applies to the
program it built: ``hook(env)`` for the ``sim`` driver, ``hook(trainer,
loop)`` for ``train``.

* ``unchanged``: a step that returns its state unchanged;
* ``half``: half of the batch left out (the envs' second half keeps its
  old state; the learner's update takes the mean over the first half);
* ``altered``: an answer altered where it is produced (env 0's qpos; the
  reward of every other transition a rollout produces).

A cell on one chip has no exchange between chips to leave out.
"""

from __future__ import annotations

import dataclasses

import torch

KINDS = ("unchanged", "half", "altered")


def _swap_half(new, old):
    """``new`` with its second half of envs put back to ``old``."""
    B = new.done.shape[0]
    keep = torch.arange(B, device=new.done.device) < B // 2
    tail = lambda n, o: torch.where(keep, n, o)
    lead = lambda n, o: torch.where(
        keep.reshape((-1,) + (1,) * (n.ndim - 1)), n, o)
    data = new.data.replace(**{f: tail(getattr(new.data, f),
                                       getattr(old.data, f))
                               for f in ("qpos", "qvel", "act")})
    return new.replace(data=data, obs={k: lead(v, old.obs[k])
                                       for k, v in new.obs.items()},
                       reward=lead(new.reward, old.reward))


def sim(kind: str):
    def hook(env):
        step = env.autoreset_step

        def broken(state, action):
            if kind == "unchanged":
                return state
            new = step(state, action)
            if kind == "half":
                return _swap_half(new, state)
            qpos = new.data.qpos.clone()
            qpos[:, 0] += 0.1 * qpos.abs().max()
            return new.replace(data=new.data.replace(qpos=qpos))
        env.autoreset_step = broken
    return hook


def train(kind: str):
    def hook(trainer, loop):
        if kind in ("unchanged", "half"):
            update = trainer.learner.update

            def broken(state, batch, *a, **kw):
                if kind == "unchanged":
                    z = torch.zeros((), device=batch.obs.device)
                    return {"critic_loss": z, "policy_loss_total": z}
                half = batch.obs.shape[0] // 2
                return update(state, type(batch)(**{
                    f.name: getattr(batch, f.name)[:half]
                    for f in dataclasses.fields(batch)}), *a, **kw)
            trainer.learner.update = broken
        else:
            rollout = trainer.rollout_fn

            def altered(*a, **kw):
                env_states, tail, tr, metrics = rollout(*a, **kw)
                reward = tr.reward.clone()
                reward[::2] += 1.0
                return env_states, tail, dataclasses.replace(
                    tr, reward=reward), metrics
            trainer.rollout_fn = altered
    return hook


def hook(driver: str, kind: str):
    if kind not in KINDS:
        raise ValueError(f"fault {kind!r}: one of {KINDS}")
    return (sim if driver == "sim" else train)(kind)
