"""Weights carried across: flax parameter trees into the port's modules.

A flax tree arrives as nested dicts of numpy arrays, e.g. the policy's

    {"params": {"LayerNormMLP_0": {"Dense_0": {"kernel", "bias"},
                                   "LayerNorm_0": {"scale", "bias"}, ...},
                "NormalDiagHead_0": {"Dense_0": ..., "Dense_1": ...}}}

A flax Dense kernel is (in, out); a torch Linear weight is (out, in). The
vision networks' ``VisNetFly_0`` or ``VisNetRodent_0`` subtree goes to
their ``vis`` module. An
IntentionPolicy's tree has ``encoder`` ({LayerNormMLP_0, NormalDiagHead_0}
or, two-level, {LayerNormMLP_0, NormalDiagHead_0, LayerNormMLP_1,
NormalDiagHead_1}) and ``decoder`` ({LayerNormMLP_0, Dense_0}).
"""

from __future__ import annotations

import numpy as np
import torch

_DUAL_FIELDS = ("log_temperature", "log_alpha_mean", "log_alpha_stddev",
                "log_penalty_temperature")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _dense(out: dict, prefix: str, node: dict) -> None:
    out[f"{prefix}.weight"] = _tensor(np.asarray(node["kernel"]).T)
    out[f"{prefix}.bias"] = _tensor(node["bias"])


def _mlp(out: dict, node: dict, prefix: str = "mlp") -> None:
    n = sum(k.startswith("Dense_") for k in node)
    for i in range(n):
        _dense(out, f"{prefix}.linears.{i}", node[f"Dense_{i}"])
    out[f"{prefix}.norm.weight"] = _tensor(node["LayerNorm_0"]["scale"])
    out[f"{prefix}.norm.bias"] = _tensor(node["LayerNorm_0"]["bias"])


def _head(out: dict, prefix: str, node: dict) -> None:
    _dense(out, f"{prefix}.mean", node["Dense_0"])
    _dense(out, f"{prefix}.scale", node["Dense_1"])


def _intention(out: dict, p: dict) -> None:
    """flax IntentionPolicy params -> the port's IntentionPolicy keys."""
    enc = p["encoder"]
    levels = (("high_mlp", "high_head"), ("mlp", "head")) \
        if "LayerNormMLP_1" in enc else (("mlp", "head"),)
    for i, (mlp, head) in enumerate(levels):
        _mlp(out, enc[f"LayerNormMLP_{i}"], f"encoder.{mlp}")
        _head(out, f"encoder.{head}", enc[f"NormalDiagHead_{i}"])
    _mlp(out, p["decoder"]["LayerNormMLP_0"], "decoder.mlp")
    _dense(out, "decoder.mean", p["decoder"]["Dense_0"])


VISNETS = ("VisNetFly_0", "VisNetRodent_0")


def _visnet(out: dict, p: dict) -> None:
    """flax VisNetFly or VisNetRodent, where ``p`` has one: a Conv kernel
    is (kh, kw, in, out), a torch Conv2d weight (out, in, kh, kw)."""
    node = next((p[k] for k in VISNETS if k in p), None)
    if node is None:
        return
    n = sum(k.startswith("Conv_") for k in node)
    for i in range(n):
        conv = node[f"Conv_{i}"]
        out[f"vis.convs.{i}.weight"] = _tensor(
            np.asarray(conv["kernel"]).transpose(3, 2, 0, 1))
        out[f"vis.convs.{i}.bias"] = _tensor(conv["bias"])
    _dense(out, "vis.dense", node["Dense_0"])


def policy_state_dict(variables: dict) -> dict:
    """flax PolicyNetwork, VisionPolicy or IntentionPolicy variables -> the
    state_dict of the port's module of the same name."""
    p = variables.get("params", variables)
    out = {}
    if "encoder" in p:
        _intention(out, p)
        return out
    _visnet(out, p)
    _mlp(out, p["LayerNormMLP_0"])
    _head(out, "head", p["NormalDiagHead_0"])
    return out


def critic_state_dict(variables: dict) -> dict:
    """flax DistributionalCritic or VisionCritic variables -> the
    state_dict of DistributionalCritic or VisionCritic."""
    p = variables.get("params", variables)
    out = {}
    _visnet(out, p)
    _mlp(out, p["LayerNormMLP_0"])
    _dense(out, "logits", p["Dense_0"])
    return out


def carry_train_state(learner, jax_state: dict, generator=None):
    """A port TrainState holding a JAX TrainState's policy, critic, both
    targets, dual params and step count. ``jax_state`` maps those field
    names ("policy_params", ..., "dual_params", "steps") to numpy trees.
    The Adam moments are not carried: the optimizers start fresh."""
    state = learner.init(generator)
    state.policy.load_state_dict(policy_state_dict(jax_state["policy_params"]))
    state.target_policy.load_state_dict(
        policy_state_dict(jax_state["target_policy_params"]))
    state.critic.load_state_dict(critic_state_dict(jax_state["critic_params"]))
    state.target_critic.load_state_dict(
        critic_state_dict(jax_state["target_critic_params"]))
    with torch.no_grad():
        for name in _DUAL_FIELDS:
            getattr(state.dual_params, name).copy_(
                _tensor(jax_state["dual_params"][name]))
    state.steps = int(np.asarray(jax_state["steps"]))
    return state
