"""Host-side rendering of rollouts through the C++ rasterizer.

Evaluation videos (reference vnl_ray/utils.py:15-33 rollout_and_render,
and the evaluator's mp4 uploads) are drawn by a dependency-free software
raycaster (``flybody_tpu_torch/native/rasterizer.cpp``) driven through
ctypes. The library is built with g++ on first use into
``flybody_tpu_torch/_build/`` under a name that carries a hash of the
source, the flags and the host CPU's target; a failed build raises.

The engine's state is batch-minor on the env's device: each frame reads
env ``env`` (0 by default) of ``geom_xpos``, ``geom_xmat`` and the
thorax's ``xpos``, with the reward channels, in one copy to the host.
The rollouts render one env.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np
import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "rasterizer.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
# the flags of flybody_tpu/native/Makefile: the same source and flags give
# the same pixels
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-march=native")
# plane, sphere, capsule, ellipsoid, cylinder, box (MuJoCo geom codes)
RENDERED_TYPES = (0, 2, 3, 4, 5, 6)
SKY = (135, 170, 210)

_LIB = None


def _host_target() -> bytes:
    """What -march=native resolves to on this host (g++'s target
    options), so that a library built for one CPU is never loaded on
    another."""
    res = subprocess.run(["g++", "-march=native", "-Q", "--help=target"],
                         capture_output=True, check=True)
    return res.stdout


def lib_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_host_target())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"librasterizer-{h.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the rasterizer unless it is built; returns its path."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    res = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                         capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE}:\n{res.stderr}")
    os.replace(tmp, path)    # atomic: readers never see half a file
    return path


def load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        scene = [f32p, f32p, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                 ctypes.c_int, i32p, f32p, f32p, f32p]
        lib.render_rgb.argtypes = scene + [f32p, u8p]
        lib.render_rgb.restype = None
        lib.render_depth.argtypes = scene + [f32p]
        lib.render_depth.restype = None
        _LIB = lib
    return _LIB


def _host_frame(model, data, env: int = 0, extra=()):
    """One copy to the host of env ``env``'s renderable geoms and of the
    ``extra`` tensors. -> (types int32, pos, mat, size flat float32, [each
    extra as numpy in the data's dtype])."""
    types = np.asarray(model.geom_type, np.int32)
    idx = np.nonzero(np.isin(types, RENDERED_TYPES))[0]
    ix = torch.as_tensor(idx, device=data.geom_xpos.device)
    parts = [data.geom_xpos[ix, :, env], data.geom_xmat[ix, ..., env],
             model.geom_size[ix]] + list(extra)
    dt = data.geom_xpos.dtype
    host = torch.cat([p.reshape(-1).to(dt) for p in parts]).cpu().numpy()
    out, pos = [], 0
    for p in parts:
        out.append(host[pos:pos + p.numel()].reshape(p.shape))
        pos += p.numel()
    f32 = lambda x, *s: np.ascontiguousarray(x, np.float32).reshape(*s)
    n = len(idx)
    return (types[idx].copy(), f32(out[0], n * 3), f32(out[1], n * 9),
            f32(out[2], n * 3), out[3:])


def _draw(frame_inputs, cam_pos, cam_mat, fovy, width, height):
    types, pos, mat, size = frame_inputs
    out = np.zeros((height, width, 3), np.uint8)
    rgba = np.full(len(types) * 4, 0.65, np.float32)
    load().render_rgb(np.asarray(cam_pos, np.float32).copy(),
                      np.asarray(cam_mat, np.float32).reshape(9).copy(),
                      float(fovy), width, height, len(types), types, pos,
                      mat, size, rgba, out.reshape(-1))
    return out


def render_frame(model, data, cam_pos, cam_mat, fovy=45.0, width=320,
                 height=240, env: int = 0):
    """One RGB frame (H, W, 3) uint8 of env ``env``; the camera frame's
    columns are (right, up, -forward)."""
    return _draw(_host_frame(model, data, env)[:4], cam_pos, cam_mat, fovy,
                 width, height)


def render_depth(model, data, cam_pos, cam_mat, fovy=45.0, width=32,
                 height=32, env: int = 0):
    """Depth frame (H, W) float32 of env ``env`` (1e30 where no geom is
    hit)."""
    types, pos, mat, size, _ = _host_frame(model, data, env)
    out = np.zeros((height, width), np.float32)
    load().render_depth(np.asarray(cam_pos, np.float32).copy(),
                        np.asarray(cam_mat, np.float32).reshape(9).copy(),
                        float(fovy), width, height, len(types), types, pos,
                        mat, size, out.reshape(-1))
    return out


def track_camera(target):
    """The tracking camera: 0.6, 0.6, 0.35 off ``target`` and looking at
    it. -> (cam_pos (3,), cam_mat (3, 3))."""
    target = np.asarray(target)
    cam_pos = target + np.array([0.6, 0.6, 0.35])
    fwd = target - cam_pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    return cam_pos, np.stack([right, up, -fwd], axis=1)


def _tracked_frame(env, state, width, height, extra=()):
    """Env 0 seen by the tracking camera on its thorax -> (frame, the
    ``extra`` tensors on the host)."""
    thorax = env.task.walker.thorax_id
    *scene, rest = _host_frame(env.model, state.data, 0,
                               [state.data.xpos[thorax, :, 0], *extra])
    cam_pos, cam_mat = track_camera(rest[0])
    return _draw(scene, cam_pos, cam_mat, 45.0, width, height), rest[1:]


def rollout_and_render(env, policy_fn, generator=None, n_steps=100,
                       width=320, height=240):
    """Roll out ``policy_fn`` (obs dict -> (1, A) actions) in one env and
    render it each control step (reference rollout_and_render). -> list
    of (H, W, 3) uint8 frames."""
    state = env.reset(1, generator)
    frames = []
    with torch.no_grad():
        for _ in range(n_steps):
            state = env.autoreset_step(state, policy_fn(state.obs))
            frames.append(_tracked_frame(env, state, width, height)[0])
    return frames


def render_with_rewards_info(env, policy_fn, generator=None, n_steps=100,
                             width=320, height=240):
    """Policy rollout in one env collecting its frames and its reward
    channels (the batched ``task.reward_factors``) each control step
    (reference utils.render_with_rewards_info :139-165). -> (frames, the
    steps at which the episode ended, [{channel: float}] per step)."""
    model, task = env.model, env.task
    state = env.reset(1, generator)
    frames, channels, reset_idx = [], [], []
    with torch.no_grad():
        for i in range(n_steps):
            state = env.autoreset_step(state, policy_fn(state.obs))
            fac = task.reward_factors(model, state.data, state.task_state,
                                      state.data.sensordata)
            frame, vals = _tracked_frame(
                env, state, width, height,
                [v[0] for v in fac.values()] + [state.done[0]])
            frames.append(frame)
            channels.append({k: float(v) for k, v in zip(fac, vals)})
            if vals[-1]:
                reset_idx.append(i)
    return frames, reset_idx, channels


def _plot_reward_strip(history: dict, idx: int, width: int, height: int,
                       terminated: bool = False):
    """Reward-channel line plot as an (height, width, 3) uint8 array
    (reference vnl_ray/utils.py plot_reward :200-244, Agg backend).
    matplotlib is imported here, so only the strip needs it."""
    import matplotlib
    orig = matplotlib.get_backend()
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    try:
        fig = plt.figure(figsize=(width / 100.0, height / 100.0), dpi=100)
        ax = fig.add_subplot(111)
        for key, vals in history.items():
            ax.plot(vals[: idx + 1], label=key)
            ax.scatter([idx], [vals[idx]])
        if terminated:
            ax.axvline(x=idx, color="r", linestyle="-")
        ax.set_ylim(-0.05, 1.1)
        ax.set_xlim(0, max(len(next(iter(history.values()))) - 1, 1))
        ax.legend(loc="upper right", fontsize=6)
        fig.tight_layout()
        fig.canvas.draw()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        w, h = fig.canvas.get_width_height()
        img = buf.reshape(h, w, 4)[..., :3].copy()
        plt.close(fig)
        return img
    finally:
        matplotlib.use(orig)


def render_with_rewards(env, policy_fn, generator=None, n_steps=100,
                        width=320, height=240):
    """Frames with the reward-channel plot composited to their right
    (reference utils.render_with_rewards :168-197). -> list of
    (H, 2 W, 3) uint8."""
    frames, reset_idx, channels = render_with_rewards_info(
        env, policy_fn, generator, n_steps=n_steps, width=width,
        height=height)
    history = {k: np.array([c[k] for c in channels]) for k in channels[0]}
    resets = set(reset_idx)
    return [np.concatenate([frame, _plot_reward_strip(
        history, i, width=width, height=height, terminated=i in resets)],
        axis=1) for i, frame in enumerate(frames)]
