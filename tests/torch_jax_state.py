"""Shared by the port's parity tests: one seeded walk_on_ball state, made
with numpy and carried between the JAX package and the port as numpy, and
the comparison they all use."""

import numpy as np
import torch

import jax.numpy as jnp

from flybody_tpu.physics import io_mj as jio
from flybody_tpu_torch.physics import bridge
from flybody_tpu_torch.tasks.walk_on_ball import PUT_MODEL_KW, WOB_ADMM_KW

# wob-admm's put_model arguments (the port's PUT_MODEL_KW with its
# WOB_ADMM_KW overrides), for the JAX package's put_model
WOB_ADMM_KW = {**PUT_MODEL_KW, **WOB_ADMM_KW}


def seeded_state(jm, seed, B=2):
    """JAX Data at qpos0 with noisy hinge angles and ball quaternion,
    random qvel / act / ctrl (numpy)."""
    rng = np.random.RandomState(seed)
    d = jio.make_data(jm, B=B, dtype=jnp.float64)
    qpos = np.asarray(d.qpos).copy()
    jt = np.asarray(jm.jnt_type)
    qadr = np.asarray(jm.jnt_qposadr)
    hinge = qadr[jt == 3]
    qpos[hinge] += 0.05 * rng.randn(len(hinge), B)
    for q in qadr[jt == 1]:                  # ball joint quaternion
        quat = np.array([1.0, 0, 0, 0])[:, None] + 0.1 * rng.randn(4, B)
        qpos[q:q + 4] = quat / np.linalg.norm(quat, axis=0)
    cr = np.asarray(jm.actuator_ctrlrange)
    ctrl = cr[:, :1] + (cr[:, 1:] - cr[:, :1]) * rng.rand(jm.nu, B)
    return d.replace(
        qpos=jnp.asarray(qpos), qvel=jnp.asarray(0.3 * rng.randn(jm.nv, B)),
        act=jnp.asarray(0.2 * rng.rand(jm.na, B)), ctrl=jnp.asarray(ctrl))


def to_port(jd, pm):
    """The port's Data of a JAX Data."""
    return bridge.data_from_numpy(bridge.to_numpy(jd), pm)


def to_jax(pd, jm):
    """The JAX package's Data of a port Data (float64)."""
    arr = bridge.to_numpy(pd)
    jd = jio.make_data(jm, B=pd.qpos.shape[-1], dtype=jnp.float64)
    con = jd.contact.replace(**{k: jnp.asarray(v)
                                for k, v in arr.pop("contact").items()})
    return jd.replace(contact=con,
                      **{k: jnp.asarray(v) for k, v in arr.items()})


def close(name, got, want, tol, scale=0.0):
    """max |got - want| <= tol * max(max |want|, scale)."""
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    if want.size:
        scale = max(float(np.max(np.abs(want))), scale)
    scale = max(scale, 1e-12)
    err = float(np.max(np.abs(got - want))) if want.size else 0.0
    assert err <= tol * scale, \
        f"{name}: max err {err:.3e} > {tol} * {scale:.3e}"
