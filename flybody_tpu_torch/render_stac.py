"""Render mocap clips as playback videos (reference render_stac.py:23-92).

Plays each clip of the rat's tracking env back kinematically (qpos set
frame by frame, the forward kinematics and collision geometry of
``forward.fwd_position`` on the env's device) and draws each frame with the
host C++ rasterizer (``utils/rendering.render_frame``):

    python -m flybody_tpu_torch.render_stac [--ref-path clips.h5]
        [--out-dir stac_renders] [--num-clips 2] [--n-steps 100]
        [--width 320] [--height 240] [--device cuda]

Without ``--ref-path`` the synthetic clips are rendered (the reference
ships no mocap data). Videos are mp4 where imageio can write them, else
``.npz`` (``agents/evaluator.save_video``). It runs on "cuda" unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def playback_frames(env, qpos_clip, n_steps: int, width: int,
                    height: int) -> list:
    """The first ``n_steps`` frames of the clip ``qpos_clip`` (T, nq),
    each an (H, W, 3) uint8 image of the posed walker."""
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.physics import io_mj
    from flybody_tpu_torch.utils import rendering

    model = env.model
    data = io_mj.make_data(model, B=1)
    qpos_clip = torch.as_tensor(qpos_clip, device=model.device)
    frames = []
    with torch.no_grad():
        for t in range(n_steps):
            d = F.fwd_position(model, data.replace(
                qpos=qpos_clip[t].to(data.qpos.dtype)[:, None]))
            # 0.8, -0.8, 0.5 off the root, looking at it
            root = d.xpos[1, :, 0].cpu().numpy()
            cam_pos = root + np.array([0.8, -0.8, 0.5])
            fwd = (root - cam_pos) / np.linalg.norm(root - cam_pos)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= max(np.linalg.norm(right), 1e-9)
            cam_mat = np.stack([right, np.cross(right, fwd), -fwd], axis=1)
            frames.append(rendering.render_frame(
                model, d, cam_pos, cam_mat, width=width, height=height))
    return frames


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ref-path", default="")
    p.add_argument("--out-dir", default="stac_renders")
    p.add_argument("--num-clips", type=int, default=2)
    p.add_argument("--n-steps", type=int, default=100)
    p.add_argument("--width", type=int, default=320)
    p.add_argument("--height", type=int, default=240)
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' only when asked for")
    args = p.parse_args(argv)

    from flybody_tpu_torch.agents.evaluator import save_video
    from flybody_tpu_torch.rodent_envs import rodent_walk_imitation

    env = rodent_walk_imitation(device=args.device,
                                ref_path=args.ref_path or None)
    clips = env.task.clips
    os.makedirs(args.out_dir, exist_ok=True)
    n = min(args.num_clips, clips.num_clips)
    lengths = clips.lengths.cpu().numpy()
    for i in range(n):
        steps = min(args.n_steps, int(lengths[i]))
        print(f"rendering clip {i + 1}/{n} ({steps} frames)...", flush=True)
        frames = playback_frames(env, clips.fields["qpos"][i], steps,
                                 args.width, args.height)
        out = save_video(np.asarray(frames),
                         os.path.join(args.out_dir, f"clip_{i}.mp4"), fps=30)
        print(f"wrote {out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
