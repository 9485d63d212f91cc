#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Every launch count below is read from a CUDA-activity trace of the
counted steps (torch.profiler), by kernel name: the kernels that a
replayed CUDA graph of the substeps (envs/substeps.py) runs count one by
one, as they ran on the card, and the timed steps run under that trace.

Phases (each prints its lines; any failure exits non-zero):
  1. device   the card's name and power limit (nvidia-smi)
  2. build    every CUDA source of flybody_tpu_torch/csrc with nvcc, one
              process per source, all started together
  3. main     walk_on_ball at B=4096, float32: reset, one warm-up control
              step, then 10 autoreset_step calls with mid-range actions;
              obs and reward must be finite, the solve_rows kernel
              must have launched exactly 10 times per control step and
              the convex narrowphase kernel (ccd_narrowphase) once per ccd
              class in each substep and in the autoreset's reset (44
              times per control step), and the forward kinematics kernel
              once a substep and in that reset (11 times)
  4. check    one substep of 4 envs of the main path's final state on the
              card (float32) against the same substep on the CPU
              (plain versions, float32; float64 sets how far apart two
              float32 runs may be)
  5. kernels  solve_rows against its plain version on the card, at the
              main path's shapes: (a) inputs captured from the main path's
              final state, (b) random inputs; times of both, and of (a)
              with the solver loop switched off (where the time goes);
              (c) ccd_narrowphase against its plain version
              (physics/ccd.py, float32 on the same card tensors) on every
              call of one more control step from the main path's final
              state (each class, fresh and update substeps, the reset),
              both held to the plain version in float64 lane by lane
              (CCD_TOL_*, CCD_TIE_*), each call timed (device ms
              with the queue held by a spin kernel; plain ms), the first
              fresh and update substep printed class by class; its
              kernels-line row sums the control step's calls.
              Every solve_rows hold (here and in phases 8-13) first
              replays the plain version with the other restart decision
              in an env where its restart test was a near tie (TIE) and
              the kernel took the other path, and prints those replays;
              it fails when more than max(TIE_MIN_ENVS, ceil(TIE_SHARE *
              B)) of them are flips (an env over TIE_NOISE that the
              replay brings TIE_GAIN or less of its error)
  6. stages   the stage split of the same solve on phase 5's fly inputs:
              upsolve_build_yd, upsolve_yd (on J^T of the same rows, held
              against upsolve_build_yd and against its plain version) and
              apgd_iterate (its f held against solve_rows' f) against
              their plain versions, each timed (apgd_iterate also with its
              loop off), and solve_fused(_stage="yd" / "apgd") launching
              them; upsolve_yd's library yardstick, one batched
              torch.linalg.solve_triangular on the dense factor L^T D^{1/2}
              (its Yd only, not b), timed on env-major tensors made before
              the clock starts
  7. solvers  contact_solver "apgd" and "admm": one substep of 4 envs on
              the card against the CPU as in phase 4, each solver's qacc
              distance from an 800-iteration float64 APGD solve; then
              wob-admm (contact_solver "admm_kernel", budgets cut so the
              dense system has 226 rows) at B=4096 for 2 control steps
              with the admm_iterate kernel launched 10 times per control
              step, and that kernel against its plain version env by env,
              after 1 and after 20 iterations; its time at 0 iterations
  8. train    DMPOTrainer on walk_on_ball (float32, the shipped network
              widths, 256 envs, unroll 10, batch 256, 20 action samples,
              32 samples per insert = 320 updates per iteration, a replay
              ring of 1,000,000) for 2 iterations: exactly 200 solve_rows
              launches, 640 learner updates, 5120 transitions in replay,
              finite stats, moved parameters and both target copies;
              solve_rows against its plain version on the inputs of the
              rollout's final state (B=256) as in phase 5; then three
              consecutive learner updates on the card against the same
              updates on the CPU: the losses of each, the last one's
              clipped gradients and the parameters, in float64 (held at
              1e-9) and in float32 (each side's float32-to-float64
              distance sets how far apart the two may be, and the card's
              distance may be at most CARD_F32_RATIO times the CPU's)
  9. imitation walk_imitation (the free fly on a floor, the JAX package's
              budgets: solve_rows at 176 rows, the kernel's wide instance)
              at B=4096, float32: reset from a seeded CUDA generator, one
              warm-up control step, then 10 autoreset_step calls with
              mid-range actions; obs and reward finite, solve_rows launched
              exactly 10 times per control step, floor contacts selected
              and penetrating in the final state (and taken by the
              solver); one substep of 4 envs on the card against the CPU
              as in phase 4; solve_rows against its plain version on the
              final state's inputs as in phase 5, its time with and
              without the solver loop; solve_rows' wide instance on random
              inputs over walk_imitation's tree at 176 rows; upsolve_yd
              against its plain version on J^T of the final state's rows,
              upsolve_build_yd and apgd_iterate on the final state's rows
              as in phase 6, each timed; the forward kinematics kernel
              launched exactly 11 times per control step and held on the
              final state's qpos against its plain version (float32 on
              the same card tensors), both against the plain version in
              float64 output by output (KIN_*), the kernel in float64
              too, and timed (device ms with the queue held by a spin
              kernel; plain ms; its byte bound): the kernels line's
              "kinematics" row
 10. flight   flight_imitation (the winged fly in air, the wing fluid, the
              wing-beat pattern generator; solve_rows at 64 rows over 42
              dofs, the kernel's narrow instance) at B=4096, float32: reset
              from a seeded CUDA generator, one warm-up control step, then
              10 autoreset_step calls with mid-range actions (user action
              0); obs and reward finite, solve_rows launched exactly once
              per substep (4 per control step), the fluid force nonzero in
              every env; one substep of 4 envs on the card against the CPU
              as in phase 4; solve_rows against its plain version on the
              final state's inputs as in phase 5, its time with and without
              the solver loop; upsolve_build_yd, upsolve_yd and
              apgd_iterate as in phase 9. Then the template task (the free
              fly on a floor, contact solver "apgd"): 8 envs, one control
              step, finite obs and no hand kernel launched
 11. vision   vision_guided_flight over the trench (the flight fly over a
              heightfield, both 32x32 eyes rendered every control step;
              solve_rows at 88 rows over 42 dofs, the narrow instance) at
              B=4096, float32: reset from a seeded CUDA generator, one
              warm-up control step, then 10 autoreset_step calls with
              mid-range actions; obs (both eyes) and reward finite,
              solve_rows launched exactly 4 times per control step, in
              no env an eye inside a geom it casts against, and the
              terrain the nearest hit of a share of each eye's pixels
              within EYE_TERRAIN_*; the eye render's ms per control
              step and the phase's
              peak device memory; one substep of 4 envs placed with the
              fly just touching the terrain on the card against the CPU
              as in phase 4, heightfield contacts selected, penetrating
              and among the solver's cones; one substep of the final
              state's 4 envs the same way and solve_rows against its
              plain version on the final state's inputs as in phase 10;
              three learner updates with the vision networks on the card
              against the CPU as in phase 8, on the phase's observations
              at batch 256
 12. agents   the agent modes on the card, each through its entry point,
              each run's solve_rows launches counted exactly: (a)
              DMPOTrainer with the intention network on walk_imitation
              (its ref_* task keys; configs/train_config_rodent_imitation
              .yaml: encoder and decoder [1024, 1024], intention 60,
              critic [1024]x3, batch 256, latent KL weight 1e-4), 256
              envs, unroll 10, 1 iteration of 320 updates: 100 launches at
              R 176, intention_kl finite, three learner updates card vs CPU
              as in phase 8 (the encoder's and decoder's gradients too);
              (b) transfer: (a)'s policy checkpointed, a trainer with
              configs/train_config_bowl_transfer.yaml's two-level encoder
              (high level 45, [512]x3, intention 60) and (a)'s decoder
              restored from the checkpoint and frozen, one iteration: 100
              launches, the decoder bit-identical to the donor's before and
              after, the encoder moved; (c) MultiTaskDMPOTrainer over
              walk_on_ball and walk_imitation (configs/train_config_two_
              tasks.yaml's [512]x3 networks, batch 512), 128 envs per task,
              unroll 10, 1 iteration: 200 launches, 100 at R 152 and 100
              at R 176, learner_steps = 2 tables x updates_per_table,
              both tables filled, per-task metrics finite, the iteration
              split; (d) make_evaluator on walk_imitation with episodes of
              10 control steps, 8 episodes, (a)'s policy: 100 launches,
              the five stats finite, mean length <= 10, ms per control
              step; (e) utils.rendering.render_with_rewards_info on
              walk_imitation for 5 control steps at 320x240 with the C++
              rasterizer built by g++: 50 launches, every frame uint8 and
              showing the fly, the four DeepMimic channels finite and each
              over its weight (20, 1, 1, 1) in [0, 1], save_video's .npz
              under the temp directory, the rasterizer's host ms per frame.
              Each sub-phase, once its launches are counted, holds
              solve_rows against its plain version as phase 8 does, on
              the next substep of its own final state at its own batch:
              R 176 at B=256 (a, b), R 152 and R 176 at B=128 (c), R 176
              at B=8 (d) and B=1 (e)
 13. rodent   the dm_control rat (nv 73, 20 substeps per control step,
              solve_rows at 96 rows, the narrow instance): (a)
              rodent_two_touch at B=4096, float32, as phase 9 (reset from
              a seeded CUDA generator, one warm-up control step, 5 timed
              autoreset_step calls: exactly 20 solve_rows launches per
              control step and no other kernel, obs and reward finite;
              the kinematics kernel exactly 21 launches per control step
              and held on the final state as in phase 9, the "*_rodent"
              keys of its row);
              (b) rodent_run_gaps, rodent_escape_bowl and
              rodent_maze_forage the same way for 2 control steps each,
              heightfield contacts selected on gaps or bowl, and one
              substep of 4 envs of gaps' and bowl's final states lowered
              onto the terrain, card against CPU as in phase 4, with
              penetrating heightfield contacts among the solver's cones in
              every env; (c) one substep of 4 envs on the card against
              the CPU as in phase 4 from (a)'s final state, and from a
              head-down state (the joints at qpos0, the root pitched nose
              down and lowered until the skull and jaw boxes press into
              the floor) with penetrating plane-box contacts among the
              solver's cones in every env; (d) solve_rows against its plain
              version on (a)'s final state and on random inputs over the
              rat's tree at 96 rows, timed with and without its loop; (e)
              DMPOTrainer with configs/train_config_two_taps.yaml's
              networks (policy [512]x4, critic [512, 512, 512, 256], batch
              512) at its 64 envs, one iteration of unroll 10 training
              once that rollout is in replay: exactly 200 launches,
              solve_rows held on its final state at B=64, three learner
              updates card vs CPU as in phase 8
 14. tracking multi-clip mocap tracking on the synthetic clips (solve_rows
              at 96 rows, the narrow instance): (a) rodent_walk_imitation
              (the foot-mods rat, nv 73, 20 substeps per control step) at
              B=4096, float32, as phase 13 (reset from a seeded CUDA
              generator, one warm-up control step, 5 timed
              autoreset_step calls: exactly 20 solve_rows launches per
              control step and no other kernel), obs, reward and every
              reward channel finite, every clip drawn and every start
              within its clip; (b) walk_humanoid (the CMU humanoid, nv 62,
              6 substeps of 5 ms) the same way, exactly 6 launches per
              control step; (c) for each, one substep of 4 envs of the
              final state on the card against the CPU as in phase 4, and
              the task's observations, reward, channels, termination and
              discount of 64 envs of the final state card vs CPU (bounds
              raised by the CPU's float32-to-float64 distance); (d)
              solve_rows against its plain version on each final state
              (R 96 over nv 73 and nv 62) and on random inputs over the
              humanoid's tree, timed with and without its loop; (e)
              inverse kinematics (autograd through the kinematics) of the
              rat's sites at clip 0's 120 frames from joints perturbed by
              a seeded 0.1 rad: 20 iterations card vs CPU (no hand
              kernel launched), the site error
              falling over 200 iterations, the ms per iteration; (f)
              DMPOTrainer with configs/train_config_rodent_imitation.yaml's
              intention networks (parsed by train_dmpo) at its 168 envs,
              one iteration of unroll 5 training once that rollout is in
              replay (a replay ring of 100,000): exactly 100 launches,
              solve_rows held on its final state, three learner updates
              card vs CPU as in phase 8; its checkpoint restored by
              configs/train_config_gaps_transfer.yaml's trainer
              (--transfer-ckpt) as its decoder, bit-identical to the
              donor's before and after one iteration (100 launches), the
              encoder moved; (g) python -m flybody_tpu_torch.render_stac
              --num-clips 1 --n-steps 5 into the temp directory (its
              frames uint8 and showing the rat), the playback's host ms
              per frame, no kernel launched
 15. vision   the rat's egocentric camera (solve_rows at 96 rows): (a)
              rodent_escape_bowl(use_vision=True) at B=4096, float32, as
              phase 13 (2 timed control steps: exactly 20 solve_rows
              launches per control step and no other kernel), every
              camera (B, 32, 32) in [0, 255], the share of pixels that
              see the terrain first (> 0), the render's ms (CUDA events),
              device ms and launches (torch.profiler) per call and its
              peak memory; (b) one substep of 4 envs card vs CPU as in
              phase 4, and the camera of CAM_ENVS envs of the final state
              card vs CPU by hit distance (at most CAM_SHARE of the
              pixels flip between hit and miss, at most CAM_SHARE move
              over CAM_TOL_DIST); (c) solve_rows held on the final state;
              (d) DMPOTrainer(network="vision") with
              configs/train_config_bowl.yaml's networks ([512] x 3 each,
              batch 2048) at its 280 envs, one iteration of unroll 5
              training once that rollout is in replay (a ring of 10,000):
              exactly 100 launches, VisNetRodent in both networks,
              solve_rows held on its final state, three learner updates
              card vs CPU as in phase 8 (batch 256, obs from (a))
 16. ranks    data-parallel training (flybody_tpu_torch/parallel): (a)
              python -m torch.distributed.run --standalone
              --nproc_per_node 1 -m flybody_tpu_torch.parallel.dryrun
              --device cuda --backend nccl, a group of one over NCCL
              (exit 0, one row, 70 solve_rows launches, 3 updates); (b)
              two gloo ranks spawned on the one card (NCCL puts no two
              ranks on one device): the dry run's iteration on each
              (exactly 10 solve_rows launches per control step x unroll
              7, the same parameters on both ranks, finite metrics, each
              rank's s/iter printed: two ranks share one card, so no
              scaling figure), then one learner update on the halves of
              a fixed batch of 256 and of its action normals, in float32
              and float64, the parameters the same on both ranks and held
              against the same update on the whole batch in one process
              as phase 8 holds the card against the CPU
 17. registers, shared memory, resident blocks and warps per SM, local
     (spill) bytes and apgd_iterate's active clusters of every kernel
     (solve_rows, upsolve_build_yd and apgd_iterate at all three shapes,
     solve_rows at the vision, rodent and humanoid shapes,
     ccd_narrowphase's four instances, the kinematics kernel in float32
     and float64), also as each
     kernel row's
     "occupancy"; the kernel table as JSON ("launches" on the main path of
     phase 3 or 6-7, "launches_train" in phase 8, solve_rows'
     "launches_imitation", "ms_imitation", "plain_ms_imitation" and
     "bound_ms_imitation" in phase 9 and the same "*_flight" keys in phase
     10 and "*_vision" keys in phase 11, and "launches_intention",
     "launches_transfer", "launches_multitask", "launches_eval" and
     "launches_render" in phase 12, with "max_abs_err_intention",
     "_transfer", "_multitask_walk_on_ball", "_multitask_walk_imitation",
     "_eval" and "_render"; "*_rodent" keys in phase 13 with
     "launches_rodent_gaps", "_bowl", "_maze" and "_train",
     "max_abs_err_rodent_random" and "_rodent_train"; "*_rodent_imitation"
     and "*_humanoid" keys in phase 14 with "launches_tracking_train" and
     "_tracking_transfer", "max_abs_err_humanoid_random" and
     "_tracking_train"; "launches_rodent_vision", "_vision_train" with
     "max_abs_err_rodent_vision", "_vision_train" in phase 15 and
     "launches_ranks" (the two gloo ranks together) in phase 16; beside
     them, each
     hold's "replayed*" envs, flips, share and cap; upsolve_yd's
     "*_imitation" and "*_flight" keys in phases 9-10, with its library
     yardstick's "library_ms_*"; upsolve_build_yd's and apgd_iterate's
     "*_imitation" and "*_flight" keys, and apgd_iterate's
     "loop_off_ms*"), the card line, the result line
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
B = 4096
STEPS = 10
ADMM_STEPS = 2
IMIT_STEPS = 10
FLIGHT_STEPS = 10
VISION_STEPS = 10
# learner updates with the vision networks: the batch of phase 8
VISION_BATCH = 256
TEMPLATE_B = 8
# phase 12: envs, control steps and iterations of the agent modes' runs
# (12a and 12b 256 envs, 12c 128 per task, 12d 8 episodes, 12e one env),
# each run training once its first rollout is in replay
AGENT_ITERATIONS = 1
AGENT_ENVS = 256
AGENT_UNROLL = 10
AGENT_MIN_REPLAY = 2560
MULTI_ENVS = 128
EVAL_STEPS = 10
EVAL_EPISODES = 8
RENDER_STEPS = 5
# phase 13: the rat's control steps at B (a, two_touch; b, each
# heightfield arena) and the trainer's envs (e,
# configs/train_config_two_taps.yaml's 64)
RODENT_STEPS = 5
RODENT_HF_STEPS = 2
RODENT_TRAIN_ENVS = 64
# phase 14: the tracking envs' control steps at B (a, b), the envs of the
# card-vs-CPU task check (c), the inverse kinematics' step size, momentum
# and iterations (e: held card vs CPU, then timed), the unroll and replay
# ring of the tracking trainers (f; unroll 5 keeps the script well inside
# its time limit on a slow host; the reference config's 2829 obs floats a
# transition twice over: 2.3 GB), the playback's frames (g)
TRACK_STEPS = 5
TASK_B = 64
IK_LR = 0.02
IK_BETA = 0.9
IK_HOLD_STEPS = 20
IK_STEPS = 200
TRACK_UNROLL = 5
TRACK_REPLAY = 100_000
STAC_FRAMES = 5
# phase 15: the camera rat's control steps at B (a), the envs of the
# camera's card-vs-CPU check (b), and the vision trainer's envs
# (configs/train_config_bowl.yaml's 280) and replay ring (d: 1186 obs
# floats a transition twice over, 95 MB)
RODENT_VISION_STEPS = 2
CAM_ENVS = 64
BOWL_ENVS = 280
RODENT_VISION_REPLAY = 10_000
# phase 16: the longest a group of ranks may take, the spawn included
RANKS_TIMEOUT = 300.0

# H100 SXM peaks (NVIDIA data sheet): float32 outside the tensor cores,
# and device memory bandwidth
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Tolerances of a kernel against its plain version, float32 on both.
# Every output: max |kernel - plain| / max |plain| <= 1e-3. Both run the
# same arithmetic in another summation order (~1e-6 relative for sums of
# <= 152 terms); a restart test sum(g (z_new - z)) near zero can flip in a
# few envs and change one Nesterov step there, which moves f by a fraction
# of one step, well under 1e-3 of the batch's force scale.
TOL_MAX_REL = 1e-3
# qacc = qacc_smooth + dqacc by the relative norm over the batch, as the
# JAX package's fused-solver test compares qacc (test_solver_fused.py:58);
# the same reasoning on the aggregate.
TOL_QACC = 1e-4
# One substep of 4 envs on the card (float32, kernels) against the same
# substep on the CPU (float32, plain versions) from the same state,
# relative norm over the 4 envs. The two runs round in another order
# through an ill-conditioned contact state (small fly masses, stiff
# contacts, 20 solver iterations), so they can be as far apart as float32
# is from float64: on the card that distance read up to 1.6e-2 for qacc
# and 3.9e-3 for qvel, 4e-4 for qpos and sensordata, over five runs of
# the main path's final state on an H100. qacc and qvel are held at about
# 3x that; qpos and sensordata, which move little in one substep, at 1e-3.
TOL_SUBSTEP = {"qacc": 5e-2, "qvel": 1e-2, "qpos": 1e-3,
               "sensordata": 1e-3}
# A stiff contact state amplifies rounding: two float32 runs that differ
# only in summation order can be as far apart as float32 is from float64
# on the same inputs. So each bound above is raised to F64_FACTOR times
# the plain float32 result's distance from the plain float64 result,
# measured on this run's inputs. A wrong kernel or stage is off by O(1).
F64_FACTOR = 2.0

# admm_iterate against its plain version, every env on its own scale
# (max |z| of the env). The plain version takes the kernel's roundings in
# the kernel's order (admm_kernel.admm_iterate_reference), so the two
# agree bit for bit unless the card rounds an operation otherwise. No
# float64 raise: any other order of the float32 sums moves a bf16 rhs
# entry across a rounding boundary in some envs and 20 over-relaxed
# iterations carry that to ~1e-2 of the env's scale, so a bound that
# admitted it would admit a wrong kernel too.
TOL_ADMM_ENV = 1e-4

# UPDATE_STEPS consecutive learner updates on the card (float32) against
# the same updates on the CPU (float32) from the same params, batches and
# action normals: the losses of every step by relative error, the last
# step's clipped gradients of each group (policy, critic, duals) and the
# updated parameters by relative norm. The two differ in the summation
# order of the networks' float32 products (~1e-6 relative for sums of
# <= 512 terms). Adam's first step is ~lr * sign(g) per entry; from the
# second step on it depends on the gradients' magnitudes, and the
# gradients themselves are compared after the global-norm clip. A step
# that is wrong moves the parameters by O(lr) = 1e-4 per entry, ~2e-3 of
# their norm. The same updates also run in float64 on the card and on the
# CPU, and those two are held at TOL_F64, orders of magnitude above
# float64 rounding: the card computes the same function. So the two
# float32 runs differ only by their own roundings, and the float32 bound
# is raised to F64_FACTOR times the larger of the CPU's and the card's
# float32-to-float64 distances. The card's can be the larger: on a vision
# batch whose third update is ill-conditioned (the stddev KL's dual near
# 1e3 pulls on online minus target scales ~lr apart) the card's float32
# gradients sat several times further from its float64 ones than the
# CPU's (PERF.md section 6, PR 10). A wrong learner is wrong in float64
# too. The parameter change alone (updated minus initial) is held at
# 1e-2: a wrong step is off by O(1) of it.
TOL_UPDATE = 1e-4
TOL_DELTA = 1e-2
TOL_F64 = 1e-9
# The raise above reads the card's own float32 rounding, so a defect in the
# card's float32 path alone (TF32 left on, a reduced-precision library
# path) would raise its own bound. So the card's float32-to-float64
# distance is held against the CPU's: at most CARD_F32_RATIO times it,
# floored at F32_FLOOR (a few float32 ulps, relative) where the CPU's is
# near 0 on a near-exact quantity. On an H100 that ratio read 0.26-3.1
# (PERF.md section 6); TF32 puts the card ~1e2-1e3 times further.
CARD_F32_RATIO = 10.0
F32_FLOOR = 1e-6
UPDATE_STEPS = 3
TRAIN_ITERATIONS = 2

# The tracking task's outputs (observations, reward and its channels) of
# the same float32 state on the card and on the CPU: the same formulas in
# another summation order, over reference features that each side's
# forward kinematics computed in float32 (~1e-6 relative apart): max_rel
# 1e-4 per output, raised to F64_FACTOR times the CPU's float32-to-float64
# distance as for the substep. Termination (error > threshold) and
# discount must agree except where an env's termination error lies within
# TIE_TERM of the threshold.
TOL_TASK = 1e-4
TIE_TERM = 1e-4
# Inverse kinematics: 20 momentum steps on the card against the same steps
# on the CPU, float32, from the same start: the qpos change and the site
# error by relative norm, 1e-4 raised to F64_FACTOR times the CPU's
# float32-to-float64 distance; a wrong gradient moves a step by O(lr g).
TOL_IK = 1e-4

# APGD's restart test r = sum(g (z_new - z)) > 0 is its one discontinuous
# decision. Where |r| is a small share of sum |g (z_new - z)|, the kernel's
# summation order can decide it otherwise than the plain version's (the
# two runs' iterates drift apart by rounding, so by the last iterations a
# share of a few 1e-3 can flip); the env then takes another, equally valid
# momentum path and its f ends up to ~1e-3 of the batch's force scale away,
# which at a small batch is most of qacc's bound. Such a tie is replayed:
# the plain version runs again with the other decision at that iteration,
# and the env is held against the replay, under the same bounds, if the
# replay is nearer the kernel. A wrong kernel is off in envs without a
# near tie, or stays off after the replay. Each hold prints its replays.
TIE = 1e-2
TIE_TRIES = 3
# A kernel that biased the restart test would show as many flipped
# restarts. A replay counts as a flip when the env's error before it was
# over float32 noise (TIE_NOISE of the batch's scale; the plain version's
# own float32-to-float64 distance reads ~1e-6 to 2e-5) and the replay
# brings the env at least 1 / TIE_GAIN times nearer the kernel (it takes
# the kernel's path: the error falls by orders of magnitude). A hold
# fails when more than max(TIE_MIN_ENVS, ceil(TIE_SHARE * B)) envs
# flipped. On an H100 a hold replayed 0-16 envs over batches of 4096,
# 256, 128, 64, 8 and 1, of them at most 2 such flips; a kernel restarting
# only when r > 1e-2 sum |g dz| flipped 89 of 4096 (PERF.md section 6).
TIE_NOISE = 1e-5
TIE_GAIN = 0.1
TIE_SHARE = 1e-2
TIE_MIN_ENVS = 6

# The rat's camera card (float32) against the CPU (float32) on the same
# final state, each pixel's nearest hit distance. Both march the same 48
# samples and take the same closed forms; the camera pose and the geom
# frames differ by float32 rounding (~1e-7 m), so a hit moves by ~1e-6 m.
# A pixel flips between hit and miss, or moves by a march sample (0.084
# m), only where a sample lies within rounding of the terrain or a ray
# grazes a primitive: a handful of the 65,536 pixels. A wrong pose, scene
# or terrain moves most hits by O(1). So: at most CAM_SHARE of the pixels
# may flip, and at most CAM_SHARE may move by more than CAM_TOL_DIST.
CAM_TOL_DIST = 1e-3
CAM_SHARE = 1e-3
# Phase 11: each fly eye casts against the scene's primitives less those
# of its own body (the head) that contain it, so in no env may it lie
# inside a geom of its body that it casts against. (Another body's geom
# may hold it, as a collapsed fly's thorax did: an occlusion, counted and
# printed.) And it
# sees out: the terrain is the nearest hit of a share of an eye's pixels
# whose 1st percentile over the envs is at least EYE_TERRAIN_Q01 and whose
# median lies in EYE_TERRAIN_MEDIAN. On an H100 the phase's final state
# read 0.089 and 0.368-0.373 (the reset's 0.173 and 0.391-0.394; 0.000 in
# the least env, whose eye the thorax held); the bands keep half of that
# percentile and +-0.07 about the median. Eyes that see the inside of the
# head read a share of 0.
EYE_TERRAIN_Q01 = 0.04
EYE_TERRAIN_MEDIAN = (0.30, 0.44)
# The convex narrowphase kernel (phase 5): each answer is checked in
# float64 by the plain code at the answer's own direction u
# (``ccd_misfit``): its dist against the support gap at u, u's gap against
# the float64 run's answer, |u| against 1 (the gap misfit), and its pos
# against the refined witnesses at u (the pos misfit), each length over
# the lane's magnitude. The direction itself is not compared: on flat
# contacts (a face on a face) the gap barely moves over a range of u, and
# the kernel and the plain float32 version land up to ~1e-3 apart there
# while their dists agree to 1e-9. On an H100 at B=4096 over walk_on_ball,
# walk_imitation and rodent_two_touch (PERF.md section 6) the
# largest gap misfit read 1.7e-6 for the kernel and 4.1e-7 for the plain
# float32 version, the largest pos misfit 3.0e-5 and 6.8e-5; broken
# answers (refinement off, one PGD iteration, the flat-axis candidates
# dropped) put 1e5-1.5e6 pairs over these bounds. A rounding can tip one
# of the kernel's selects (a candidate's f < bf, a Newton step's
# acceptance, a refinement's flat test) where the plain version's did
# not: at most max(CCD_TIE_LANES, CCD_TIE_SHARE x pairs) pairs may be
# over. The multiplicity must equal the plain version's wherever the
# plain float32 and float64 versions agree on it.
CCD_TOL_GAP = 1e-5
CCD_TOL_POS = 3e-4
CCD_TIE_LANES = 6
CCD_TIE_SHARE = 1e-5
# The kinematics kernel (float32) against the plain version in float64 on
# the same qpos: per output, its largest error over every finite entry at
# most KIN_RATIO times the plain float32 version's, plus KIN_SLACK float32
# ulps of the output's scale (the two round in another order: nvcc fuses
# multiply-adds); the same entries non-finite. In float64 both do the same
# arithmetic: KIN_F64_ULPS float64 ulps of the output's scale.
KIN_RATIO = 2.0
KIN_SLACK = 8 * 2.0 ** -23
KIN_F64_ULPS = 64 * 2.0 ** -52
# device_ms: cycles of the spin kernel that holds the queue (~50 ms)
SPIN_CYCLES = 100_000_000
ROW_ARGS = ("d6", "u6", "b1", "b2", "lim_sign", "lim_dadr", "maskd", "ld",
            "dinv", "qacc_smooth", "qvel", "kcoef", "bcoef", "posr")
UP_ARGS = ROW_ARGS[7:]
APGD_ARGS = ("rreg", "active", "mu", "f0", "v0")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        fail(f"nvidia-smi: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def eye_view(task, data) -> dict:
    """Per eye of a vision_guided_flight state: the envs in which the eye
    lies inside one of the geoms it casts against, of its own body
    (``own``) and of another (``other``), and the share of its pixels
    whose nearest hit is the terrain, per env (B,)."""
    import numpy as np
    import torch
    from flybody_tpu_torch.ops import raycast
    from flybody_tpu_torch.tasks.vision_flight import contains
    m = task.walker.model
    gt = np.asarray(m.geom_type)
    gb = np.asarray(m.geom_bodyid)
    gs = m.geom_size.detach().cpu().double().numpy()
    gx = data.geom_xpos.permute(2, 0, 1)
    gm = data.geom_xmat.permute(3, 0, 1, 2)
    hits = task.render_eyes(m, data, distance=True)
    out = {}
    for (key, body, pos, mat), ids in zip(task.eyes, task.eye_geoms):
        cam_pos, cam_mat = task.camera_pose(data, body, pos, mat)
        ix = torch.as_tensor(ids, device=gx.device)
        # the eye in each cast geom's frame, float64 on the host
        local = torch.einsum("bgji,bgj->bgi", gm[:, ix].double(),
                             (cam_pos[:, None] - gx[:, ix]).double())
        local = local.cpu().numpy()
        inside = {"own": [], "other": []}
        for b in range(local.shape[0]):
            for k, g in enumerate(ids):
                if contains(gt[g], gs[g], local[b, k]):
                    inside["own" if gb[g] == body else "other"].append(
                        (b, int(g)))
        t_ter = raycast.render_eye(cam_pos, cam_mat, task.rays,
                                   task.height_fn, distance=True)
        terrain = (t_ter <= hits[key]) & (t_ter < 10.0)
        out[key] = dict(inside=inside,
                        share=terrain.flatten(1).double().mean(dim=1))
    return out


def max_rel(a, b) -> float:
    """max |a - b| / max |b|, in float64."""
    a, b = a.double(), b.double()
    return (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)


def rel_norm(a, b) -> float:
    """|a - b| / |b| over the whole tensor, in float64."""
    import torch
    a, b = a.double(), b.double()
    return (torch.linalg.vector_norm(a - b)
            / torch.linalg.vector_norm(b)).item()


def hold(label, names, got, want, want64, tol=TOL_MAX_REL, rel32=None):
    """Each output of ``got`` against ``want`` by max_rel, the bound
    ``tol`` raised to F64_FACTOR times the distance of the plain float32
    result from the plain float64 result ``want64`` (or ``rel32`` where
    given). Fails over a bound; returns the largest abs error."""
    worst = 0.0
    for i, (name, g, w) in enumerate(zip(names, got, want)):
        err = (g - w).abs().max().item()
        rel = max_rel(g, w)
        r32 = rel32[i] if rel32 is not None else max_rel(w, want64[i])
        bound = max(tol, F64_FACTOR * r32)
        worst = max(worst, err)
        print(f"  {label} {name:6s} max_abs {err:.3e} max_rel {rel:.3e} "
              f"(plain f32 vs f64 {r32:.3e}; tol {bound:.3g})", flush=True)
        if not rel <= bound:
            fail(f"{label} {name}: max_rel {rel:.3e} > {bound:.3g}")
    return worst


def hold_envs(label, got, want, tol):
    """``got`` against ``want`` (rows, B) env by env: each env's
    max |got - want| over its own max |want|. Fails if any env is over
    ``tol``; returns the largest abs error."""
    diff = (got.double() - want.double()).abs().amax(dim=0)
    rel = diff / want.double().abs().amax(dim=0).clamp_min(1e-30)
    n_over = int((rel > tol).sum())
    print(f"  {label}: max_abs {diff.max().item():.3e}, largest env max_rel "
          f"{rel.max().item():.3e} (tol {tol:.0e}); envs that differ at all "
          f"{int((diff > 0).sum())}, over tol {n_over} of {diff.numel()}",
          flush=True)
    if n_over:
        fail(f"{label}: {n_over} envs over {tol:.0e} of their own scale")
    return diff.max().item()


def as64(x):
    return x.double() if x is not None and x.is_floating_point() else x


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors
               if x is not None)


def bound(flops, moved) -> tuple:
    """(least ms the card could take, "operations" or "bytes")."""
    t_ops, t_bytes = flops / PEAK_F32, moved / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def kernel_row(name, source, replaces, launches, err, k_ms, p_ms, flops,
               moved, library_ms=None) -> dict:
    """One entry of the kernels line; bound_ms from this run's inputs."""
    b_ms, by = bound(flops, moved)
    row = {"name": name, "route": "cuda",
           "source": f"flybody_tpu_torch/csrc/{source}",
           "replaces": replaces, "launches": launches, "max_abs_err": err,
           "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": by,
           "library_ms": library_ms}
    print(f"kernel: {name} B={B} kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
          f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB), launches "
          f"{launches}", flush=True)
    return row


class CcdCalls:
    """Stands in for ``ops/ccd_kernel.narrowphase`` inside ``with``: keeps
    each call's (args, kwargs) in ``calls`` and calls through. ``launches``
    reads and writes the wrapped function's own count, which that function
    adds to by its module name."""

    def __init__(self, CK):
        self.CK, self.fn, self.calls = CK, CK.narrowphase, []

    def __enter__(self):
        self.CK.narrowphase = self
        return self.calls

    def __exit__(self, *exc):
        self.CK.narrowphase = self.fn

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.fn(*args, **kwargs)

    launches = property(lambda self: self.fn.launches,
                        lambda self, n: setattr(self.fn, "launches", n))


def ccd_misfit(ccd, args64, dist64, out):
    """Per (lane, env) misfit of a narrowphase answer ``out`` (dist, pos,
    u, ...) to the inputs ``args64`` (float64), judged in float64 by the
    plain code at the answer's own direction u: how far its dist is from
    the support gap at u, how far its pos is from the refined witnesses at
    u, how much worse u is than the float64 run's answer ``dist64`` (a
    direction no worse counts 0), and how far |u| is from 1. Each length
    over the lane's magnitude (its centres' distance from the origin, its
    radii, half-axes and segment halves). Returns (gap, pos), each
    flattened over (N, B): gap the largest of the three but pos."""
    import torch
    p1, R1, (e1, s1, r1, _), p2, R2, (e2, s2, r2, _) = args64
    dist, pos, u = (x.double() for x in out[:3])
    norm = u.norm(dim=1)
    u = u / norm[:, None]
    pair = ccd._Pair(p1, R1, (e1, s1), p2, R2, (e2, s2))
    sa, sb = pair.sup(u)
    d_at = -pair.f(u, sa, sb) - (r1 + r2)[:, 0]
    x1, x2 = ccd._refine_witnesses(u, sa, sb, p1, R1, (e1, s1), p2, R2,
                                   (e2, s2))
    pos_at = 0.5 * ((x1 + r1 * u) + (x2 - r2 * u))
    mag = (torch.maximum(p1.norm(dim=1), p2.norm(dim=1)) + e1.amax(dim=1)
           + s1[:, 0] + r1[:, 0] + e2.amax(dim=1) + s2[:, 0] + r2[:, 0])
    gap = torch.stack([(dist - d_at).abs() / mag,
                       (dist64 - d_at).clamp_min(0) / mag,
                       (norm - 1).abs()]).amax(dim=0)
    return (gap.reshape(-1),
            ((pos - pos_at).abs().amax(dim=1) / mag).reshape(-1))


def device_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn`` over ``reps`` calls back to back. A
    spin kernel holds the queue while the host launches them, so the
    host's pace (slower than a small kernel's run) stays out of the time;
    fails if the host took longer than the spin."""
    import torch
    fn()
    torch.cuda.synchronize()
    s0, e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(SPIN_CYCLES)
    t = time.perf_counter()
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    host_ms = 1e3 * (time.perf_counter() - t)
    torch.cuda.synchronize()
    if not host_ms < s0.elapsed_time(e0):
        fail(f"device_ms: the host took {host_ms:.2f} ms to launch {reps} "
             f"calls, longer than the {s0.elapsed_time(e0):.2f} ms spin")
    return e0.elapsed_time(e1) / reps


def ccd_as64(args, kw):
    """A narrowphase call's (args, kwargs) with every float tensor in
    float64."""
    def f64(x):
        if isinstance(x, tuple):
            return tuple(f64(y) for y in x)
        return as64(x) if hasattr(x, "is_floating_point") else x
    return [f64(x) for x in args], dict(kw, u0=as64(kw.get("u0")))


def hold_ccd(label, calls, CK, ccd, n_classes):
    """The narrowphase kernel on every captured call ``calls`` ([(args,
    kwargs)]), each answer checked in float64 by the plain code
    (``ccd_misfit``) beside the plain float32 version's on the same card
    tensors. Fails where more than max(CCD_TIE_LANES, CCD_TIE_SHARE x
    pairs) (lane, env) pairs misfit by over CCD_TOL_GAP or CCD_TOL_POS,
    where the kernel's
    multiplicity differs from one that the plain float32 and float64
    versions agree on, or where the kernel's dist is not finite where the
    plain version's is. Times each call (device ms; plain ms) and prints
    the first fresh and update substep's class by class. Returns the
    kernels line's numbers."""
    import torch
    n0 = CK.narrowphase.launches
    over, nu_bad, lanes, worst = 0, 0, 0, 0.0
    mk_all, mp_all = [[], []], [[], []]
    k_ms = p_ms = flops = moved = 0.0
    for i, (args, kw) in enumerate(calls):
        got = CK.narrowphase(*args, **kw)
        want = ccd.narrowphase(*args, **kw)
        args64, kw64 = ccd_as64(args, kw)
        want64 = ccd.narrowphase(*args64, **kw64)
        if not bool(torch.isfinite(got[0])[torch.isfinite(want[0])].all()):
            fail(f"{label} ccd call {i}: the kernel's dist is not finite "
                 f"where the plain version's is")
        mk = ccd_misfit(ccd, args64, want64[0], got)
        mp = ccd_misfit(ccd, args64, want64[0], want)
        over += int(((mk[0] > CCD_TOL_GAP) | (mk[1] > CCD_TOL_POS)).sum())
        nu_bad += int(((got[3] != want[3]) & (want[3] == want64[3])).sum())
        lanes += mk[0].numel()
        worst = max(worst, (got[0] - want[0]).abs().max().item())
        for j in (0, 1):
            mk_all[j].append(mk[j])
            mp_all[j].append(mp[j])
        N, _, B_c = args[0].shape
        ax1, ax2 = bool(args[2][3]), bool(args[5][3])
        work = CK.narrowphase_work(N, B_c, kw["iters"], ax1, ax2)
        ms = device_ms(lambda: CK.narrowphase(*args, **kw), 20)
        pms = cuda_ms(lambda: ccd.narrowphase(*args, **kw), 1)
        k_ms, p_ms = k_ms + ms, p_ms + pms
        flops, moved = flops + work["flops"], moved + work["bytes"]
        if i < 2 * n_classes:
            b_ms, by = bound(work["flops"], work["bytes"])
            print(f"  {label} ccd {'fresh' if i < n_classes else 'update'} "
                  f"flags ({int(ax1)},{int(ax2)}) lanes {N} B={B_c} iters "
                  f"{kw['iters']}: kernel {ms:.4f} ms, plain {pms:.3f} ms, "
                  f"bound {b_ms:.4f} ms ({by})", flush=True)
    torch.cuda.synchronize()
    cap = max(CCD_TIE_LANES, math.ceil(CCD_TIE_SHARE * lanes))
    q = [0.5, 0.99, 0.9999]

    def spread(xs):
        x = torch.cat(xs)
        qs = x.quantile(torch.tensor(q, dtype=x.dtype, device=x.device))
        return [float(f"{v:.3g}") for v in qs.tolist() + [x.max().item()]]

    print(f"  {label} ccd: {len(calls)} calls, {lanes} (lane, env) pairs; "
          f"misfit in float64 at quantiles {q} and max, gap: kernel "
          f"{spread(mk_all[0])}, plain float32 {spread(mp_all[0])} (tol "
          f"{CCD_TOL_GAP:g}); pos: kernel {spread(mk_all[1])}, plain "
          f"float32 {spread(mp_all[1])} (tol {CCD_TOL_POS:g}); kernel pairs "
          f"over: {over} (cap {cap}); multiplicity off where both plain "
          f"versions agree: {nu_bad}; max |dist| kernel - plain "
          f"{worst:.3e}", flush=True)
    if CK.narrowphase.launches - n0 < len(calls):
        fail(f"{label} ccd: the kernel was not launched on every call")
    if over > cap:
        fail(f"{label} ccd: {over} (lane, env) pairs misfit over "
             f"tolerance > cap {cap}")
    if nu_bad:
        fail(f"{label} ccd: the multiplicity differs in {nu_bad} pairs")
    return {"err": worst, "ms": k_ms, "plain_ms": p_ms, "flops": flops,
            "bytes": moved, "over": over, "cap": cap}


def hold_kin(label, KK, K, m, data):
    """The forward kinematics kernel on ``data``'s qpos (``m`` on the card,
    float32) against the plain version there in float32, both held to the
    plain version in float64 per output (KIN_RATIO, KIN_SLACK), and the
    kernel in float64 (KIN_F64_ULPS); each output in the plain version's
    strides. Times the kernel (device ms, the queue held by a spin kernel)
    and the plain version. Returns the kernels line's numbers."""
    import torch
    m64 = m.to(dtype=torch.float64)
    d64 = data.replace(qpos=data.qpos.double())
    n0 = KK.kinematics.launches
    got, got64 = KK.kinematics(m, data), KK.kinematics(m64, d64)
    want, want64 = K.kinematics(m, data), K.kinematics(m64, d64)
    torch.cuda.synchronize()
    if KK.kinematics.launches != n0 + 2:
        fail(f"{label} kinematics: the kernel did not launch")
    worst = 0.0
    for k in KK.OUTPUTS:
        g, w, g64, t = (getattr(x, k) for x in (got, want, got64, want64))
        if g.stride() != w.stride():
            fail(f"{label} kinematics {k}: strides {g.stride()}, the plain "
                 f"version's {w.stride()}")
        fin = torch.isfinite(t)
        if not torch.equal(torch.isfinite(g), fin):
            fail(f"{label} kinematics {k}: non-finite where float64 is not")
        scale = max(t[fin].abs().max().item(), 1.0)
        e_k = (g.double() - t)[fin].abs().max().item()
        e_p = (w.double() - t)[fin].abs().max().item()
        e64 = (g64 - t)[fin].abs().max().item()
        cap = KIN_RATIO * e_p + KIN_SLACK * scale
        worst = max(worst, (g - w)[fin].abs().max().item())
        print(f"  {label} kinematics {k:9s} max |kernel - f64| {e_k:.3e}, "
              f"plain f32 {e_p:.3e} (cap {cap:.3e}); kernel f64 {e64:.3e} "
              f"(cap {KIN_F64_ULPS * scale:.3e})", flush=True)
        if not e_k <= cap:
            fail(f"{label} kinematics {k}: {e_k:.3e} from float64 > "
                 f"{cap:.3e}")
        if not e64 <= KIN_F64_ULPS * scale:
            fail(f"{label} kinematics {k}: the float64 kernel {e64:.3e} "
                 f"from the plain version")
    B_k = data.qpos.shape[1]
    work = KK.kinematics_work(m.nbody, m.njnt, m.ngeom, m.nsite, m.nq, B_k,
                              jnt_type=m.jnt_type)
    ms = device_ms(lambda: KK.kinematics(m, data), 50)
    pms = cuda_ms(lambda: K.kinematics(m, data), 3)
    b_ms, by = bound(work["flops"], work["bytes"])
    print(f"  {label} kinematics B={B_k}: kernel {ms:.4f} ms, plain "
          f"{pms:.3f} ms, bound {b_ms:.4f} ms ({by}: "
          f"{work['bytes'] / 1e6:.1f} MB), {100 * b_ms / ms:.1f} % of it",
          flush=True)
    return {"err": worst, "ms": ms, "plain_ms": pms, "bound_ms": b_ms,
            "flops": work["flops"], "bytes": work["bytes"]}


def param_vector(*modules):
    """Every parameter of ``modules`` (or of a DualParams) as one float64
    vector on the CPU."""
    import torch
    return torch.cat([p.detach().double().cpu().reshape(-1)
                      for m in modules for p in m.parameters()])


def train_phase(env, cfg, iterations, zero_counts, counts, smi,
                label="train", min_copies=1):
    """Phase 8 (and 12a, 13e): DMPOTrainer on ``env`` for ``iterations``;
    fails on any gate. Each target network's copies must be as scheduled,
    and at least ``min_copies``; a network must move, and so must a target
    that was copied. Returns every kernel's launches in the run, the
    trainer, the final LoopState, the last metrics and the seconds of each
    iteration's rollout and updates."""
    import torch
    from flybody_tpu_torch.agents.train import DMPOTrainer
    trainer = DMPOTrainer(env, cfg)
    roll_s = []
    rollout = trainer.rollout_fn

    def timed_rollout(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = rollout(*args)
        torch.cuda.synchronize()
        roll_s.append(time.perf_counter() - t)
        return out

    trainer.rollout_fn = timed_rollout
    loop = trainer.init(0)
    st = loop.train
    start = {k: param_vector(getattr(st, k)) for k in (
        "policy", "critic", "target_policy", "target_critic")}
    torch.cuda.synchronize()
    zero_counts()
    iter_s = []
    for _ in range(iterations):
        t = time.perf_counter()
        loop, metrics = trainer.train_iteration(loop)
        torch.cuda.synchronize()
        iter_s.append(time.perf_counter() - t)
    launched = counts()
    st = loop.train
    n_updates = iterations * trainer.updates_per_iter
    n_env_steps = iterations * cfg.num_envs * cfg.unroll_length
    upd_s = [a - b for a, b in zip(iter_s, roll_s)]
    print(f"{label}: launches {launched} (expected solve_rows "
          f"{n_env_steps // cfg.num_envs * env.n_substeps}, the others 0)",
          flush=True)
    if launched != dict({k: 0 for k in launched},
                        solve_rows=n_env_steps // cfg.num_envs
                        * env.n_substeps):
        fail(f"{label}: solve_rows was not launched once per substep")
    print(f"{label}: learner_steps {st.steps} (expected {n_updates}), replay "
          f"size {loop.replay.size} (expected {n_env_steps}), target copies "
          f"policy {st.target_policy_copies} critic "
          f"{st.target_critic_copies}", flush=True)
    if st.steps != n_updates or loop.replay.size != n_env_steps:
        fail(f"{label}: wrong number of updates or transitions")
    periods = (cfg.dmpo.target_policy_update_period,
               cfg.dmpo.target_critic_update_period)
    copies = {"target_policy": st.target_policy_copies,
              "target_critic": st.target_critic_copies}
    if tuple(copies.values()) != tuple(
            n_updates // p for p in periods) or min(
                n_updates // p for p in periods) < min_copies:
        fail(f"{label}: the target copies did not fire as scheduled")
    bad = [k for k, v in metrics.items()
           if not bool(torch.isfinite(torch.as_tensor(v)).all())]
    if bad:
        fail(f"{label}: non-finite stats {bad}")
    moved = {k: rel_norm(param_vector(getattr(st, k)), v)
             for k, v in start.items()}
    print(f"{label}: parameters moved from init by (relative norm) "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in moved.items()})}; "
          f"critic_loss {float(metrics['critic_loss']):.4f}, "
          f"policy_loss_total {float(metrics['policy_loss_total']):.4f}, "
          f"mean_reward {float(metrics['mean_reward']):.4f}", flush=True)
    if not min(v for k, v in moved.items() if copies.get(k, 1)) > 0:
        fail(f"{label}: a network or its target did not move")
    print(f"{label}: {iterations} iterations of {cfg.num_envs} envs x "
          f"{cfg.unroll_length} control steps + {trainer.updates_per_iter} "
          f"updates; rollout s per iteration "
          f"{[round(x, 3) for x in roll_s]}, update s per iteration "
          f"{[round(x, 3) for x in upd_s]}; actor "
          f"{n_env_steps / sum(roll_s):.1f} env-steps/s, learner "
          f"{n_updates / sum(upd_s):.1f} updates/s | {smi}", flush=True)
    return launched, trainer, loop, metrics, (roll_s, upd_s)


def replay_ties(SK, tree, args, kwa, got, want, trace):
    """``want`` (solve_rows_reference's f, v, qfrc, dqacc, with its restart
    ``trace``) with each env whose restart test had a near tie (|r| <= TIE
    of sum |g dz|) replaced by a replay of the plain version that takes the
    other decision at one of its TIE_TRIES nearest ties, where that replay
    is nearer the kernel's ``got``. Returns (want, [(env, iteration,
    |r| / sum |g dz|, error before, error after)]); an env's error is
    max |got - want| over f, qfrc and dqacc, each over its batch scale."""
    import torch
    r = torch.cat([t[0] for t in trace])             # (iterations, B)
    margin = r.abs() / torch.cat([t[1] for t in trace]).clamp_min(1e-30)
    want = list(want)
    scale = [w.abs().max().clamp_min(1e-30) for w in want]

    def env_err(w):
        return torch.stack([(got[k] - w[k]).abs().amax(0) / scale[k]
                            for k in (0, 2, 3)]).amax(0)

    err = env_err(want)
    order = torch.where(margin <= TIE, margin,
                        torch.full_like(margin, float("inf"))).argsort(0)
    replayed = []
    for t in range(min(TIE_TRIES, margin.shape[0])):
        it = order[t]                                 # (B,) iteration
        cand = margin.gather(0, it[None])[0] <= TIE
        if not bool(cand.any()):
            break
        flip = torch.zeros_like(margin, dtype=torch.bool)
        flip.scatter_(0, it[None], cand[None])
        alt = SK.solve_rows_reference(tree, **args, **kwa, flip=flip)
        err_alt = env_err(alt)
        take = cand & (err_alt < err)
        for e in take.nonzero()[:, 0].tolist():
            i = int(it[e])
            replayed.append((e, i, float(margin[i, e]), float(err[e]),
                             float(err_alt[e])))
        for k in range(4):
            want[k] = torch.where(take, alt[k], want[k])
        err = torch.where(take, err_alt, err)
    return tuple(want), replayed


def update_check(learner, cfg, seed: int = 1, obs_pool=None,
                 tag: str = "update") -> None:
    """Phase 8b: UPDATE_STEPS learner updates on the card against the same
    updates on the CPU, each in float32 and in float64, from the same
    params (the port's init moved with .to()), the same numpy-seeded
    batches at the trainer's shapes and the same action normals. The
    batches' obs are standard normals, or rows of ``obs_pool`` (n,
    obs_size) drawn by the same seed."""
    import numpy as np
    import torch
    from flybody_tpu_torch.agents.dmpo import DMPOLearner, Transition
    obs, act, n, b = (learner.obs_size, learner.action_size,
                      cfg.num_samples, cfg.batch_size)
    rng = np.random.RandomState(seed)
    draw_obs = (lambda: rng.normal(size=(b, obs))) if obs_pool is None \
        else (lambda: obs_pool[rng.randint(0, len(obs_pool), b)])
    steps = [(dict(obs=draw_obs(),
                   action=rng.uniform(-1, 1, (b, act)),
                   reward=rng.uniform(0, 1, b),
                   discount=np.full(b, cfg.discount ** cfg.n_step),
                   next_obs=draw_obs()),
              rng.normal(size=(n, b, act))) for _ in range(UPDATE_STEPS)]
    card = learner.init(torch.Generator().manual_seed(seed))
    names = ("policy", "critic", "target_policy", "target_critic",
             "dual_params")
    groups = ("policy", "critic", "dual_params")
    init = {k: copy.deepcopy(getattr(card, k).state_dict()) for k in names}
    runs = {}
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    for label, dev, dt in (("card32", learner.device, f32),
                           ("card64", learner.device, f64),
                           ("cpu32", cpu, f32), ("cpu64", cpu, f64)):
        if label == "card32":
            lrn, st = learner, card
        else:
            lrn = DMPOLearner(copy.deepcopy(learner.policy).to(dev, dt),
                              copy.deepcopy(learner.critic).to(dev, dt),
                              act, obs, cfg)
            st = lrn.init(torch.Generator().manual_seed(seed + 1))
            for k in names:
                getattr(st, k).load_state_dict(init[k])
        first = param_vector(*(getattr(st, g) for g in groups))
        out = {}
        for i, (batch, eps) in enumerate(steps):
            tb = Transition(**{k: torch.as_tensor(v, dtype=dt, device=dev)
                               for k, v in batch.items()})
            stats = lrn.update(st, tb, eps=torch.as_tensor(eps, dtype=dt,
                                                           device=dev))
            for k in ("critic_loss", "policy_loss_total"):
                out[f"{k} {i + 1}"] = float(stats[k])
        # the last step's gradients, as the optimizers took them (an
        # intention policy's encoder and decoder also apart)
        parts = [(g, getattr(st, g)) for g in groups] + [
            (f"policy.{sub}", getattr(st.policy, sub))
            for sub in ("encoder", "decoder") if hasattr(st.policy, sub)]
        for g, module in parts:
            out[f"{g} grads"] = torch.cat([
                p.grad.double().cpu().reshape(-1)
                for p in module.parameters()])
        out["params"] = param_vector(*(getattr(st, g) for g in groups))
        out["params - init"] = out["params"] - first
        runs[label] = out
        if dev.type == "cuda":
            torch.cuda.synchronize()
    for name in runs["card32"]:
        dist = rel_norm if torch.is_tensor(runs["card32"][name]) else (
            lambda a, b: abs(a - b) / max(abs(b), 1e-30))
        d = {k: dist(runs[a][name], runs[b][name]) for k, (a, b) in {
            "32": ("card32", "cpu32"), "64": ("card64", "cpu64"),
            "card": ("card32", "card64"), "cpu": ("cpu32", "cpu64")}.items()}
        tol = TOL_DELTA if name == "params - init" else TOL_UPDATE
        bound = max(tol, F64_FACTOR * max(d["card"], d["cpu"]))
        card_bound = CARD_F32_RATIO * max(d["cpu"], F32_FLOOR)
        print(f"{tag}: {name:24s} card f32 vs cpu f32 {d['32']:.3e} (f32 vs "
              f"f64: cpu {d['cpu']:.3e}, card {d['card']:.3e}, card tol "
              f"{card_bound:.3g}; tol {bound:.3g}); card f64 vs cpu f64 "
              f"{d['64']:.3e}", flush=True)
        if not d["64"] <= TOL_F64:
            fail(f"{tag} {name} in float64: {d['64']:.3e} > {TOL_F64:g}")
        if not d["card"] <= card_bound:
            fail(f"{tag} {name}: the card's f32 vs f64 {d['card']:.3e} > "
                 f"{card_bound:.3g} ({CARD_F32_RATIO:g} x the CPU's)")
        if not d["32"] <= bound:
            fail(f"{tag} {name}: {d['32']:.3e} > {bound:.3g}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from flybody_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script: {e}",
              file=sys.stderr)
        return 1
    import numpy as np
    from flybody_tpu_torch.fly_envs import (flight_imitation, template_task,
                                            vision_guided_flight,
                                            walk_imitation, walk_on_ball)
    from torch.profiler import ProfilerActivity, profile
    from flybody_tpu_torch.envs import substeps
    from flybody_tpu_torch.profile_step import (device_rows, hand_kernels,
                                                hand_launches, launch_trace)
    from flybody_tpu_torch.utils import telemetry as tm
    from flybody_tpu_torch.ops import admm_kernel as AK
    from flybody_tpu_torch.ops import ccd_kernel as CK
    from flybody_tpu_torch.ops import kinematics_kernel as KK
    from flybody_tpu_torch.ops import solver_kernels as SK
    from flybody_tpu_torch.ops import tree_ldl as TL
    from flybody_tpu_torch.physics import bridge
    from flybody_tpu_torch.physics import ccd as CCD
    from flybody_tpu_torch.physics import constraint as C
    from flybody_tpu_torch.physics import forward as F
    from flybody_tpu_torch.physics import kinematics as K
    from flybody_tpu_torch.physics import solver_dense as SD
    from flybody_tpu_torch.physics import solver_fused as SF
    from flybody_tpu_torch.envs.core import FlyEnv
    from flybody_tpu_torch.envs.walker import FlyWalker
    from flybody_tpu_torch.physics import io_mj
    from flybody_tpu_torch.tasks import flight_imitation as FI
    from flybody_tpu_torch.tasks import vision_flight as VF
    from flybody_tpu_torch.tasks import walk_imitation as WI
    from flybody_tpu_torch.tasks import walk_on_ball as WOB

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    f32, f64 = torch.float32, torch.float64
    # every kernel wrapper of the port, by kernel name
    wrappers = {"solve_rows": SK.solve_rows,
                "apgd_iterate": SK.apgd_iterate,
                "upsolve_build_yd": SK.upsolve_build_yd,
                "upsolve_yd": SK.upsolve_yd,
                "admm_iterate": AK.admm_iterate}

    # the running trace of zero_counts(), and the hand kernels' launches
    # that counts() last read: by wrapper ("traced") and by device name
    trace, traced, traced_names = [], {}, {}

    def zero_counts():
        """Start counting launches: a launch trace until ``counts``."""
        if trace:
            trace.pop()[0].close()
        stack = contextlib.ExitStack()
        trace.append((stack, stack.enter_context(launch_trace())))

    def counts() -> dict:
        """Each solver kernel's launches on the card since ``zero_counts``
        (``traced`` gains ccd_narrowphase and kinematics), from the
        trace."""
        if trace:
            stack, p = trace.pop()
            stack.close()
            traced.clear()
            traced.update(hand_launches(p))
            traced_names.clear()
            traced_names.update(hand_kernels(p))
            tm.clear()
        return {k: traced[k] for k in wrappers}

    def with_solver(model, solver):
        return model.replace(opt=model.opt.replace(contact_solver=solver))

    # each phase's wall seconds, printed at the end
    phase_s, phase_t = {}, [time.perf_counter()]

    def mark(phase: int) -> None:
        now = time.perf_counter()
        phase_s[phase] = round(now - phase_t[0], 1)
        phase_t[0] = now

    # ---- 1. device -------------------------------------------------------
    smi = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} | torch {torch.__version__} cuda "
          f"{torch.version.cuda}", flush=True)

    mark(1)
    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = cuda_build.build_all()
    print(f"build: {sorted(cuda_build.sources())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    mark(2)
    # ---- 3. main path ----------------------------------------------------
    env = walk_on_ball()
    lo, hi = env.action_spec()
    mid = torch.as_tensor((lo + hi) / 2, dtype=f32,
                          device=dev)[None].expand(B, -1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = env.reset(B)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    state = env.autoreset_step(state, mid)            # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state = env.autoreset_step(state, mid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = counts()
    ccd_launched = traced["ccd_narrowphase"]
    kin_launched = traced["kinematics"]
    sps = B * STEPS / dt
    print(f"main: walk_on_ball B={B} reset {reset_s:.3f} s, {STEPS} "
          f"control steps in {dt:.3f} s = {sps:.1f} env-steps/s "
          f"({1e3 * dt / STEPS:.1f} ms per control step)", flush=True)
    print(f"main: launches {launched} (expected solve_rows "
          f"{STEPS * env.n_substeps}, the others 0)", flush=True)
    if launched != dict({k: 0 for k in wrappers},
                        solve_rows=STEPS * env.n_substeps):
        fail("solve_rows was not launched once per substep")
    # the convex narrowphase: once a ccd class in each substep and in the
    # autoreset's batched reset
    ccd_want = STEPS * len(env.model.ccd_classes) * (env.n_substeps + 1)
    print(f"main: ccd_narrowphase launches {ccd_launched} (expected "
          f"{ccd_want})", flush=True)
    if ccd_launched != ccd_want:
        fail("ccd_narrowphase was not launched once per class a substep "
             "and reset")

    def kin_gate(label, launched_k, steps, n_substeps):
        """The forward kinematics kernel: once a substep and once in the
        autoreset's reset."""
        want_k = steps * (n_substeps + 1)
        print(f"{label}: kinematics launches {launched_k} (expected "
              f"{want_k})", flush=True)
        if launched_k != want_k:
            fail(f"{label}: the kinematics kernel was not launched once a "
                 f"substep and reset")

    kin_gate("main", kin_launched, STEPS, env.n_substeps)
    for k, v in state.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"obs {k} not finite")
    if not bool(torch.isfinite(state.reward).all()):
        fail("reward not finite")
    n_obs = sum(v.shape[1] for v in state.obs.values())
    print(f"main: obs {len(state.obs)} keys, {n_obs} floats per env, all "
          f"finite; reward mean {state.reward.mean().item():.4f}, done "
          f"{int(state.done.sum())}", flush=True)

    mark(3)
    # ---- 4. small-input reference: the same substep on the CPU ----------
    def first_four(data):
        """The numpy state of the first 4 envs of ``data``."""
        return {k: ({kk: vv[..., :4] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[..., :4])
                for k, v in bridge.to_numpy(data).items()}

    m = env.model
    small = first_four(state.data)
    cpu = {dt_: WOB.make_walk_on_ball("cpu", dtype=dt_).model
           for dt_ in (f32, f64)}

    def substep_check(label, model_card, solver, small=small, cpu=cpu):
        """One substep of the 4 ``small`` envs on the card against the CPU
        models ``cpu`` in float32 (bounds raised by the CPU's float32-to-
        float64 distance). Returns the card's Data."""
        mc = with_solver(model_card, solver)
        out = F.step(mc, bridge.data_from_numpy(small, mc))
        ref = {}
        for dt_, mm in cpu.items():
            mm = with_solver(mm, solver)
            ref[dt_] = F.step(mm, bridge.data_from_numpy(small, mm))
        for name in ("qacc", "qvel", "qpos", "sensordata"):
            c32 = getattr(out, name).cpu()
            r32, r64 = getattr(ref[f32], name), getattr(ref[f64], name)
            rel, rel32 = rel_norm(c32, r32), rel_norm(r32, r64)
            bound = max(TOL_SUBSTEP[name], F64_FACTOR * rel32)
            print(f"{label}: substep {name:10s} card f32 vs cpu f32 "
                  f"rel_norm {rel:.3e} (cpu f32 vs f64 {rel32:.3e}; card "
                  f"f32 vs f64 {rel_norm(c32, r64):.3e}; tol {bound:.3g})",
                  flush=True)
            if not rel <= bound:
                fail(f"{label} substep {name} rel_norm {rel:.3e} > "
                     f"{bound:.3g}")
        return out

    fused_out = substep_check("check", m, "fused")

    mark(4)
    # ---- 5. solve_rows against its plain version -------------------------
    d = F.smooth_forward(m, state.data)
    prob = SF.assemble(m, d)
    fly_args, kw = prob["args"], prob["kw"]
    fly64 = {k: as64(x) for k, x in fly_args.items()}

    p = SK.random_rows_problem(B, seed=0)
    tree_r = TL.build_tree_meta(p["parent"])
    ld, dinv = TL.factor(tree_r, torch.as_tensor(p["Ms"], dtype=f32,
                                                 device=dev))
    rnd_args = {k: torch.as_tensor(p[k], device=dev).to(
        torch.int32 if p[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_args.update(ld=ld, dinv=dinv)
    rnd_kw = dict(kl=32, kc=40, iterations=20, noslip_iterations=3,
                  power_iters=4)

    # each B1 hold's replayed envs, by its label
    tie_replays = {}

    def check_rows(label, tree, args, kwa):
        """solve_rows on the card against its plain version (float32, the
        bounds raised by float64) on ``args``; returns the kernel's
        outputs and the largest abs error."""
        n0 = SK.solve_rows.launches
        got = SK.solve_rows(tree, **args, **kwa)
        trace = []
        want = SK.solve_rows_reference(tree, **args, **kwa, trace=trace)
        want64 = SK.solve_rows_reference(
            tree, **{k: as64(x) for k, x in args.items()}, **kwa)
        torch.cuda.synchronize()
        if SK.solve_rows.launches != n0 + 1:
            fail("the kernel wrapper did not launch")
        # the bounds' float64 raise from the plain version as it decided
        rel32 = [max_rel(w, w64) for w, w64 in zip(want, want64)]
        qs = args["qacc_smooth"]
        q32 = rel_norm(qs + want[3], qs.double() + want64[3])
        want, replayed = replay_ties(SK, tree, args, kwa, got, want, trace)
        shown = [(e, i, *(float(f"{x:.3g}") for x in t))
                 for e, i, *t in replayed[:8]]
        B_h = qs.shape[-1]
        cap = max(TIE_MIN_ENVS, math.ceil(TIE_SHARE * B_h))
        flips = sum(1 for r in replayed
                    if r[3] > TIE_NOISE and r[4] < TIE_GAIN * r[3])
        print(f"  {label} restart ties replayed in {len(replayed)} envs of "
              f"{B_h}, {flips} of them flips (cap {cap}; env, iteration, "
              f"|r| / sum |g dz|, error before, after; TIE {TIE:g}): "
              f"{shown}{' ...' if len(replayed) > 8 else ''}", flush=True)
        tie_replays[label] = {"envs": len(replayed), "flips": flips,
                              "share": flips / B_h, "cap": cap}
        if flips > cap:
            fail(f"{label}: restart flips replayed in {flips} envs > cap "
                 f"{cap}")
        err = hold(label, ("f", "v", "qfrc", "dqacc"), got, want, want64,
                   rel32=rel32)
        qp = qs + want[3]
        rel = rel_norm(qs + got[3], qp)
        bound = max(TOL_QACC, F64_FACTOR * q32)
        print(f"  {label} qacc   rel_norm {rel:.3e} (plain f32 vs f64 "
              f"{q32:.3e}; tol {bound:.3g})", flush=True)
        if not rel <= bound:
            fail(f"{label} qacc rel_norm {rel:.3e} > {bound:.3g}")
        return got, err

    rows = {}
    b1_f = None
    R = fly_args["u6"].shape[0]
    n_up, n_down = len(TL.flat_up(m.tree)), len(TL.flat_down(m.tree))
    for label, tree, args, kwa in (("fly", m.tree, fly_args, kw),
                                   ("random", tree_r, rnd_args, rnd_kw)):
        got, err = check_rows(label, tree, args, kwa)
        k_ms = cuda_ms(lambda: SK.solve_rows(tree, **args, **kwa), 20)
        p_ms = cuda_ms(lambda: SK.solve_rows_reference(tree, **args, **kwa),
                       3)
        print(f"kernel: solve_rows {label} kernel {k_ms:.3f} ms, plain "
              f"{p_ms:.3f} ms", flush=True)
        if label == "fly":
            # where the time goes: the same call without the solver loop
            # (inputs, J build, rhs, up-sweep, y* = Yd f and the output
            # sweeps); the difference is power + APGD + noslip
            kw0 = dict(kwa, iterations=0, noslip_iterations=0,
                       power_iters=0)
            k0_ms = cuda_ms(lambda: SK.solve_rows(tree, **args, **kw0), 20)
            print(f"breakdown: solve_rows fly {k_ms:.3f} ms; without the "
                  f"solver loop {k0_ms:.3f} ms; the loop ({kwa['power_iters']}"
                  f" power, {kwa['iterations']} APGD, "
                  f"{2 * kwa['noslip_iterations']} noslip applications) "
                  f"{k_ms - k0_ms:.3f} ms", flush=True)
            b1_f = got[0]
            # library_ms None: no single PyTorch call computes the solve
            rows["solve_rows"] = kernel_row(
                "solve_rows", "solve_rows.cu",
                "flybody_tpu/ops/solver_kernels.py:556",
                launched["solve_rows"], err, k_ms, p_ms,
                SK.solve_rows_work(m.nv, R, B, n_up, n_down,
                                   kwa["iterations"],
                                   kwa["noslip_iterations"],
                                   kwa["power_iters"]),
                nbytes(*args.values(), *got))

    # the convex narrowphase on one more control step from the main path's
    # final state: every class, fresh and update substeps, and the reset
    # (the step's substeps eager: a graph's replay calls no wrapper)
    engages = substeps.engages
    substeps.engages = lambda model, data: False
    try:
        with CcdCalls(CK) as ccd_calls:
            env.autoreset_step(state, mid)
    finally:
        substeps.engages = engages
    n_cls = len(m.ccd_classes)
    if len(ccd_calls) != n_cls * (env.n_substeps + 1):
        fail(f"ccd: {len(ccd_calls)} narrowphase calls in a control step")
    h = hold_ccd("fly", ccd_calls, CK, CCD, n_cls)
    rows["ccd_narrowphase"] = kernel_row(
        "ccd_narrowphase", "ccd_narrowphase.cu",
        "flybody_tpu_torch/physics/ccd.py::narrowphase (plain jnp in the "
        "JAX package)", ccd_launched, h["err"], h["ms"], h["plain_ms"],
        h["flops"], h["bytes"])
    rows["ccd_narrowphase"].update(
        calls_timed=len(ccd_calls), over_float64=h["over"],
        over_cap=h["cap"])
    del ccd_calls

    mark(5)
    # ---- 6. the stage split on the fly inputs ----------------------------
    def hold_stages(label, tree, args, kwa, b1_f):
        """upsolve_build_yd on ``args`` and apgd_iterate on its Yd against
        their plain versions as in phase 5, apgd_iterate's f also against
        solve_rows' ``b1_f`` (bounds raised by the plain apgd_iterate's
        float32-to-float64 distance); each timed, apgd_iterate also with
        its solver loop off. Returns upsolve_build_yd's outputs, the plain
        version's distance from float64 per output, and {kernel: its row's
        numbers}."""
        row_a = [args[k] for k in ROW_ARGS]
        apgd_a = [args[k] for k in APGD_ARGS]
        got3 = SK.upsolve_build_yd(tree, *row_a)
        want3 = SK.upsolve_build_yd_reference(tree, *row_a)
        want3_64 = SK.upsolve_build_yd_reference(
            tree, *(as64(x) for x in row_a))
        torch.cuda.synchronize()
        err3 = hold(f"{label} upsolve_build_yd", ("yd", "b"), got3, want3,
                    want3_64)
        rel32_3 = [max_rel(w, w64) for w, w64 in zip(want3, want3_64)]
        del want3, want3_64
        yd, bvec = got3
        got2 = SK.apgd_iterate(yd, bvec, *apgd_a, **kwa)
        want2 = SK.apgd_iterate_reference(yd, bvec, *apgd_a, **kwa)
        want2_64 = SK.apgd_iterate_reference(
            yd.double(), bvec.double(), *(as64(x) for x in apgd_a), **kwa)
        torch.cuda.synchronize()
        rel32_2 = [max_rel(w, w64) for w, w64 in zip(want2, want2_64)]
        err2 = hold(f"{label} apgd_iterate vs solve_rows", ("f",),
                    got2[:1], (b1_f,), None, rel32=rel32_2[:1])
        err2 = max(err2, hold(f"{label} apgd_iterate", ("f", "ystar", "v"),
                              got2, want2, want2_64))
        del want2, want2_64
        nv_s, R_s = yd.shape[:2]
        kw0 = dict(kwa, iterations=0, noslip_iterations=0, power_iters=0)
        ms3 = cuda_ms(lambda: SK.upsolve_build_yd(tree, *row_a), 20)
        pms3 = cuda_ms(lambda: SK.upsolve_build_yd_reference(tree, *row_a),
                       3)
        ms2 = cuda_ms(lambda: SK.apgd_iterate(yd, bvec, *apgd_a, **kwa), 20)
        ms2_0 = cuda_ms(lambda: SK.apgd_iterate(yd, bvec, *apgd_a, **kw0),
                        20)
        pms2 = cuda_ms(lambda: SK.apgd_iterate_reference(yd, bvec, *apgd_a,
                                                         **kwa), 3)
        flops3 = SK.upsolve_yd_work(nv_s, R_s, B, len(TL.flat_up(tree)),
                                    build=True)
        flops2 = SK.apgd_iterate_work(nv_s, R_s, B, kwa["iterations"],
                                      kwa["noslip_iterations"],
                                      kwa["power_iters"])
        moved3 = nbytes(*row_a, *got3)
        moved2 = nbytes(yd, bvec, *apgd_a, *got2)
        print(f"breakdown: apgd_iterate {label} (nv {nv_s}, R {R_s}) "
              f"{ms2:.3f} ms; without the solver loop {ms2_0:.3f} ms; the "
              f"loop {ms2 - ms2_0:.3f} ms | {smi}", flush=True)
        return got3, rel32_3, {
            "upsolve_build_yd": (err3, ms3, pms3, flops3, moved3),
            "apgd_iterate": (err2, ms2, pms2, flops2, moved2, ms2_0)}

    def stage_keys(label, numbers):
        """The ``*_{label}`` keys of upsolve_build_yd's and apgd_iterate's
        kernel rows from ``hold_stages``' numbers."""
        for name, (err, k_ms, p_ms, flops, moved, *off) in numbers.items():
            b_ms, by = bound(flops, moved)
            print(f"kernel: {name} {label} B={B} kernel {k_ms:.3f} ms, plain "
                  f"{p_ms:.3f} ms, bound {b_ms:.4f} ms ({by}: "
                  f"{flops / 1e9:.2f} GFLOP, {moved / 1e6:.1f} MB) | {smi}",
                  flush=True)
            rows[name].update(**{
                f"max_abs_err_{label}": err, f"ms_{label}": k_ms,
                f"plain_ms_{label}": p_ms, f"bound_ms_{label}": b_ms,
                f"bound_by_{label}": by},
                **({f"loop_off_ms_{label}": off[0]} if off else {}))

    tree = m.tree
    row_in = [fly_args[k] for k in ROW_ARGS]
    up_in = [fly_args[k] for k in UP_ARGS]
    got3, rel32_3, stage_fly = hold_stages("fly", tree, fly_args, kw, b1_f)

    # upsolve_yd: the up-solve of J^T of the same rows, driven alone (its
    # one use is a J^T built beforehand), held against upsolve_build_yd
    jt = SK.build_jt_reference(*row_in[:7]).contiguous()
    zero_counts()
    got4 = SK.upsolve_yd(tree, jt, *up_in)
    torch.cuda.synchronize()
    launched4 = counts()
    if launched4 != dict({k: 0 for k in wrappers}, upsolve_yd=1):
        fail(f"upsolve_yd path launches {launched4}")
    err4 = hold("upsolve_yd vs upsolve_build_yd", ("yd", "b"), got4, got3,
                None, rel32=rel32_3)
    want4 = SK.upsolve_yd_reference(tree, jt, *up_in)
    want4_64 = SK.upsolve_yd_reference(tree, jt.double(),
                                       *(fly64[k] for k in UP_ARGS))
    torch.cuda.synchronize()
    err4 = max(err4, hold("upsolve_yd", ("yd", "b"), got4, want4, want4_64))
    # the library yardstick: Yd = U^{-1} J^T with U = L^T D^{1/2} dense,
    # both env-major and made before the clock starts (Yd only, not b)
    lib_u = SK.upsolve_dense_factor(tree, fly_args["ld"], fly_args["dinv"])
    lib_j = jt.permute(2, 0, 1).contiguous()
    lib_yd = torch.linalg.solve_triangular(lib_u, lib_j, upper=True)
    torch.cuda.synchronize()
    print(f"  upsolve_yd library yardstick (solve_triangular, Yd only) vs "
          f"plain: max_rel {max_rel(lib_yd.permute(1, 2, 0), want4[0]):.3e}",
          flush=True)
    lib4_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
        lib_u, lib_j, upper=True), 20)
    del lib_yd

    # solve_fused's stage split launches them
    stage_launches = {k: 0 for k in wrappers}
    for stage, expect in (("yd", {"upsolve_build_yd": 1}),
                          ("apgd", {"upsolve_build_yd": 1,
                                    "apgd_iterate": 1})):
        zero_counts()
        out = SF.solve_fused(m, d, _stage=stage)
        torch.cuda.synchronize()
        launched_s = counts()
        print(f"stages: solve_fused(_stage={stage!r}) launches "
              f"{launched_s}", flush=True)
        if launched_s != dict({k: 0 for k in wrappers}, **expect):
            fail(f"solve_fused(_stage={stage!r}) launches {launched_s}")
        if not torch.equal(out.qacc, d.qacc_smooth):
            fail(f"solve_fused(_stage={stage!r}): probe not finite")
        for k, v in launched_s.items():
            stage_launches[k] += v

    flops4 = SK.upsolve_yd_work(m.nv, R, B, n_up, build=False)
    # library_ms None for two: no single PyTorch call computes the J build
    # + tree up-solve + rhs, or APGD; upsolve_yd's is the dense triangular
    # solve of its Yd (not b)
    err3, ms3, pms3, flops3, moved3 = stage_fly["upsolve_build_yd"]
    rows["upsolve_build_yd"] = kernel_row(
        "upsolve_build_yd", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:218",
        stage_launches["upsolve_build_yd"], err3, ms3, pms3, flops3, moved3)
    rows["upsolve_yd"] = kernel_row(
        "upsolve_yd", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:84", launched4["upsolve_yd"],
        err4, cuda_ms(lambda: SK.upsolve_yd(tree, jt, *up_in), 20),
        cuda_ms(lambda: SK.upsolve_yd_reference(tree, jt, *up_in), 3),
        flops4, nbytes(jt, *up_in, *got4), library_ms=lib4_ms)
    print(f"kernel: upsolve_yd {rows['upsolve_yd']['ms']:.3f} ms against "
          f"its library yardstick (Yd only) {lib4_ms:.3f} ms | {smi}",
          flush=True)
    err2, ms2, pms2, flops2, moved2, ms2_0 = stage_fly["apgd_iterate"]
    rows["apgd_iterate"] = kernel_row(
        "apgd_iterate", "solve_rows.cu",
        "flybody_tpu/ops/solver_kernels.py:410",
        stage_launches["apgd_iterate"], err2, ms2, pms2, flops2, moved2)
    rows["apgd_iterate"]["loop_off_ms"] = ms2_0
    del jt, got3, got4, want4, want4_64, lib_u, lib_j

    mark(6)
    # ---- 7. the other contact solvers ------------------------------------
    cpu64 = with_solver(cpu[f64], "apgd")
    d64 = F.smooth_forward(cpu64, bridge.data_from_numpy(small, cpu64))
    qref = C.solve(cpu64, d64, iterations=800).qacc
    print(f"solvers: fused qacc vs 800-iteration apgd (cpu f64) rel_norm "
          f"{rel_norm(fused_out.qacc.cpu(), qref):.3e}", flush=True)
    for solver in ("apgd", "admm"):
        zero_counts()
        out = substep_check(f"solvers {solver}", m, solver)
        print(f"solvers: {solver} qacc vs 800-iteration apgd (cpu f64) "
              f"rel_norm {rel_norm(out.qacc.cpu(), qref):.3e}; launches "
              f"{counts()}", flush=True)
    lim, groups = C.make_efc(cpu64, d64)
    n_dense = (min(len(lim.dadr), SD.LIMIT_ACTIVE)
               + sum(min(g.condim, 3) * g.K for g in groups))
    print(f"solvers: the dense system at the shipped budgets has {n_dense} "
          f"rows (> {SD.KERNEL_MAX_ROWS}: admm_kernel runs the plain loop)",
          flush=True)

    # wob-admm: walk_on_ball's model put with its budgets overridden
    mj = WOB.load_model()
    ma = io_mj.put_model(mj, device=dev, dtype=f32,
                         **{**WOB.PUT_MODEL_KW, **WOB.WOB_ADMM_KW})
    walker = FlyWalker(ma, json.loads(str(mj["action_maps_json"])))
    env_a = FlyEnv(ma, WOB.WalkOnBall(walker), dtype=f32)
    state_a = env_a.reset(B)
    state_a = env_a.autoreset_step(state_a, mid)       # warm-up
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    for _ in range(ADMM_STEPS):
        state_a = env_a.autoreset_step(state_a, mid)
    torch.cuda.synchronize()
    dt_a = time.perf_counter() - t0
    launched_a = counts()
    print(f"wob-admm: B={B} {ADMM_STEPS} control steps in {dt_a:.3f} s = "
          f"{B * ADMM_STEPS / dt_a:.1f} env-steps/s; launches {launched_a}",
          flush=True)
    if launched_a != dict({k: 0 for k in wrappers},
                          admm_iterate=ADMM_STEPS * env_a.n_substeps):
        fail("admm_iterate was not launched once per substep")
    for k, v in state_a.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"wob-admm obs {k} not finite")
    if not bool(torch.isfinite(state_a.reward).all()):
        fail("wob-admm reward not finite")

    # admm_iterate against its plain version on the inputs of the next
    # (update) substep of the final state
    da = F.smooth_forward(ma, state_a.data, col_update=True)
    lim, groups = C.make_efc(ma, da)
    sysd = SD.dense_system(ma, da, lim, groups)
    n_rows = sysd["b"].shape[0]
    use, kl, kc, mu = SD.kernel_layout(sysd["ls"], groups, n_rows)
    if not (use and n_rows == 226):
        fail(f"wob-admm: {n_rows} rows, kernel layout {use}")
    akw = dict(kl=kl, kc=kc, iterations=20)
    a_in = (SD.inverse_operator(sysd["fac"]), sysd["bs"].contiguous(),
            sysd["z0"].contiguous(), mu.contiguous(),
            sysd["active"].contiguous())
    for its in (1, akw["iterations"]):
        kwi = dict(akw, iterations=its)
        got5 = AK.admm_iterate(*a_in, **kwi)
        want5 = AK.admm_iterate_reference(*a_in, **kwi)
        torch.cuda.synchronize()
        err5 = hold_envs(f"admm_iterate {its:2d} iterations", got5, want5,
                         TOL_ADMM_ENV)
    k0_ms = cuda_ms(lambda: AK.admm_iterate(*a_in, **dict(akw,
                                                           iterations=0)),
                    20)
    # library_ms None: no single PyTorch call runs the projected iteration
    rows["admm_iterate"] = kernel_row(
        "admm_iterate", "admm_iterate.cu",
        "flybody_tpu/ops/admm_kernel.py:94", launched_a["admm_iterate"],
        err5, cuda_ms(lambda: AK.admm_iterate(*a_in, **akw), 20),
        cuda_ms(lambda: AK.admm_iterate_reference(*a_in, **akw), 3),
        AK.admm_work(n_rows, B, akw["iterations"]),
        nbytes(*a_in, got5))

    print(f"breakdown: admm_iterate {rows['admm_iterate']['ms']:.3f} ms; "
          f"with 0 iterations (W staged, z0 projected) {k0_ms:.3f} ms",
          flush=True)

    mark(7)
    # ---- 8. training -----------------------------------------------------
    from flybody_tpu_torch.agents.dmpo import DMPOConfig
    from flybody_tpu_torch.agents.train import TrainerConfig
    tcfg = TrainerConfig(num_envs=256, unroll_length=10,
                         replay_capacity=1_000_000, min_replay_size=2560,
                         samples_per_insert=32.0,
                         dmpo=DMPOConfig(batch_size=256, n_step=5,
                                         num_samples=20))
    train_launched, trainer_t, loop = train_phase(
        env, tcfg, TRAIN_ITERATIONS, zero_counts, counts, smi)[:3]
    learner = trainer_t.learner
    # solve_rows on the training path's own inputs: the next substep of the
    # rollout's final state, at the rollout's batch
    d_t = F.smooth_forward(m, loop.env_states.data)
    prob_t = SF.assemble(m, d_t)
    print(f"train: solve_rows on the rollout's final state, B="
          f"{d_t.qacc_smooth.shape[-1]}", flush=True)
    check_rows("train", m.tree, prob_t["args"], prob_t["kw"])
    del loop, d_t, prob_t
    update_check(learner, tcfg.dmpo)
    for k, n in train_launched.items():
        rows[k]["launches_train"] = n
    print(f"kernel: solve_rows launches {launched['solve_rows']} on the main "
          f"path, {train_launched['solve_rows']} in training", flush=True)

    def env_phase(label, env, steps):
        """Phases 9-11 and 13: reset B envs from a seeded CUDA generator,
        one warm-up control step, then ``steps`` timed autoreset_step calls
        with mid-range actions; fails unless solve_rows launched once per
        substep (and nothing else) and obs and reward are finite. Returns
        the final state, the launches and the seconds per control
        step."""
        lo_e, hi_e = env.action_spec()
        mid_e = torch.as_tensor((lo_e + hi_e) / 2, dtype=f32,
                                device=dev)[None].expand(B, -1)
        gen = torch.Generator(dev).manual_seed(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = env.reset(B, gen)
        torch.cuda.synchronize()
        reset_e = time.perf_counter() - t0
        st = env.autoreset_step(st, mid_e)               # warm-up
        torch.cuda.synchronize()
        zero_counts()
        t0 = time.perf_counter()
        for _ in range(steps):
            st = env.autoreset_step(st, mid_e)
        torch.cuda.synchronize()
        dt_e = time.perf_counter() - t0
        launched_e = counts()
        print(f"{label}: {env.task.__class__.__name__} B={B} reset "
              f"{reset_e:.3f} s, {steps} control steps in {dt_e:.3f} s = "
              f"{B * steps / dt_e:.1f} env-steps/s "
              f"({1e3 * dt_e / steps:.1f} ms per control step) | {smi}",
              flush=True)
        print(f"{label}: launches {launched_e} (expected solve_rows "
              f"{steps * env.n_substeps}, the others 0)", flush=True)
        if launched_e != dict({k: 0 for k in wrappers},
                              solve_rows=steps * env.n_substeps):
            fail(f"{label}: solve_rows was not launched once per substep")
        for k, v in st.obs.items():
            if not bool(torch.isfinite(v).all()):
                fail(f"{label} obs {k} not finite")
        if not bool(torch.isfinite(st.reward).all()):
            fail(f"{label} reward not finite")
        print(f"{label}: obs {len(st.obs)} keys, "
              f"{sum(v[0].numel() for v in st.obs.values())} floats per env, "
              f"all finite; reward mean {st.reward.mean().item():.4e}, done "
              f"{int(st.done.sum())}, discount 0 in "
              f"{int((st.discount == 0).sum())}", flush=True)
        return st, launched_e, dt_e / steps

    def hold_rows(label, env, st, launched_e, cpu_model, shape):
        """Phases 9-11 on the final state ``st``: one substep of 4 envs on
        the card against the CPU models ``cpu_model(dtype)`` as in phase 4,
        then solve_rows at the env's (nv, R, instance) ``shape`` against its
        plain version as in phase 5, timed with and without the solver
        loop; B1's kernel row gains the ``*_{label}`` keys. Returns R, the
        inputs, the solver's keywords and the kernel's f."""
        me = env.model
        substep_check(label, me, "fused", small=first_four(st.data),
                      cpu={dt_: cpu_model(dt_) for dt_ in (f32, f64)})
        prob_e = SF.assemble(me, F.smooth_forward(me, st.data))
        args_e, kw_e = prob_e["args"], prob_e["kw"]
        R_e = args_e["u6"].shape[0]
        if (me.nv, R_e, SK.tile_cpl(R_e)) != shape:
            fail(f"{label}: nv {me.nv}, {R_e} rows, instance "
                 f"{SK.tile_cpl(R_e)}; expected {shape}")
        out_e, err_e = check_rows(label, me.tree, args_e, kw_e)
        k_ms_e = cuda_ms(lambda: SK.solve_rows(me.tree, **args_e, **kw_e),
                         20)
        p_ms_e = cuda_ms(lambda: SK.solve_rows_reference(me.tree, **args_e,
                                                         **kw_e), 3)
        kw0_e = dict(kw_e, iterations=0, noslip_iterations=0, power_iters=0)
        k0_ms_e = cuda_ms(lambda: SK.solve_rows(me.tree, **args_e, **kw0_e),
                          20)
        n_up_e = len(TL.flat_up(me.tree))
        flops_e = SK.solve_rows_work(me.nv, R_e, B, n_up_e,
                                     len(TL.flat_down(me.tree)),
                                     kw_e["iterations"],
                                     kw_e["noslip_iterations"],
                                     kw_e["power_iters"])
        b_ms_e, by_e = bound(flops_e, nbytes(*args_e.values(), *out_e))
        print(f"kernel: solve_rows {label} (nv {me.nv}, R {R_e}, n_up "
              f"{n_up_e}) B={B} kernel {k_ms_e:.3f} ms, plain {p_ms_e:.3f} "
              f"ms, bound {b_ms_e:.4f} ms ({by_e}: {flops_e / 1e9:.2f} "
              f"GFLOP), launches {launched_e['solve_rows']} | {smi}",
              flush=True)
        print(f"breakdown: solve_rows {label} {k_ms_e:.3f} ms; without the "
              f"solver loop {k0_ms_e:.3f} ms; the loop "
              f"{k_ms_e - k0_ms_e:.3f} ms", flush=True)
        rows["solve_rows"].update(**{
            f"launches_{label}": launched_e["solve_rows"],
            f"max_abs_err_{label}": err_e, f"ms_{label}": k_ms_e,
            f"plain_ms_{label}": p_ms_e, f"bound_ms_{label}": b_ms_e,
            f"bound_by_{label}": by_e})
        return R_e, args_e, kw_e, out_e[0]

    def hold_upsolve(label, me, args_e):
        """upsolve_yd on J^T of ``args_e``'s rows against its plain version
        as in phase 6, timed beside its bound and its library yardstick
        (one batched solve_triangular, Yd only); upsolve_yd's kernel row
        gains the ``*_{label}`` keys."""
        row_e = [args_e[k] for k in ROW_ARGS]
        up_e = row_e[7:]
        jt_e = SK.build_jt_reference(*row_e[:7]).contiguous()
        got = SK.upsolve_yd(me.tree, jt_e, *up_e)
        want = SK.upsolve_yd_reference(me.tree, jt_e, *up_e)
        want64 = SK.upsolve_yd_reference(me.tree, jt_e.double(),
                                         *(as64(x) for x in up_e))
        torch.cuda.synchronize()
        err = hold(f"{label} upsolve_yd", ("yd", "b"), got, want, want64)
        del want64
        ms = cuda_ms(lambda: SK.upsolve_yd(me.tree, jt_e, *up_e), 20)
        pms = cuda_ms(lambda: SK.upsolve_yd_reference(me.tree, jt_e, *up_e),
                      3)
        lib_u = SK.upsolve_dense_factor(me.tree, args_e["ld"],
                                        args_e["dinv"])
        lib_j = jt_e.permute(2, 0, 1).contiguous()
        lib_yd = torch.linalg.solve_triangular(lib_u, lib_j, upper=True)
        torch.cuda.synchronize()
        print(f"  {label} upsolve_yd library yardstick (solve_triangular, "
              f"Yd only) vs plain: max_rel "
              f"{max_rel(lib_yd.permute(1, 2, 0), want[0]):.3e}", flush=True)
        del lib_yd, want
        lib_ms = cuda_ms(lambda: torch.linalg.solve_triangular(
            lib_u, lib_j, upper=True), 20)
        R_e = jt_e.shape[1]
        b_ms, by = bound(SK.upsolve_yd_work(me.nv, R_e, B,
                                            len(TL.flat_up(me.tree)),
                                            build=False),
                         nbytes(jt_e, *up_e, *got))
        print(f"kernel: upsolve_yd {label} (nv {me.nv}, R {R_e}) B={B} "
              f"kernel {ms:.3f} ms, plain {pms:.3f} ms, bound {b_ms:.4f} ms "
              f"({by}), library (solve_triangular, Yd only) {lib_ms:.3f} ms "
              f"| {smi}", flush=True)
        rows["upsolve_yd"].update(**{
            f"max_abs_err_{label}": err, f"ms_{label}": ms,
            f"plain_ms_{label}": pms, f"bound_ms_{label}": b_ms,
            f"bound_by_{label}": by, f"library_ms_{label}": lib_ms})

    mark(8)
    # ---- 9. walk_imitation -----------------------------------------------
    env_i = walk_imitation()
    mi = env_i.model
    state_i, launched_i, _ = env_phase("imitation", env_i, IMIT_STEPS)
    kin_gate("imitation", traced["kinematics"], IMIT_STEPS,
             env_i.n_substeps)
    kin_launched_i = traced["kinematics"]
    hk = hold_kin("imitation", KK, K, mi, state_i.data)
    rows["kinematics"] = kernel_row(
        "kinematics", "kinematics.cu",
        "flybody_tpu_torch/physics/kinematics.py::kinematics (plain jnp in "
        "the JAX package)", kin_launched, hk["err"], hk["ms"],
        hk["plain_ms"], hk["flops"], hk["bytes"])
    rows["kinematics"]["launches_imitation"] = kin_launched_i
    # the floor in contact: selected contacts with the floor geom on one
    # side (in a plane pair the floor is geom 1) that penetrate, and those
    # of them among the fused solver's cones
    con = state_i.data.contact
    floor = mi.names["geom"]["floor"]
    pen = (con.g1 == floor) & (con.dist < 0)
    lay = SF.fused_layout(mi, C.efc_meta(mi))
    cone_rows = mi.ix(np.concatenate([np.arange(a, b)
                                      for a, b in lay["cone"]]))
    taken = torch.gather(pen, 0, cone_rows[state_i.data.sol_cone_sel.long()])
    print(f"imitation: floor contacts selected "
          f"{int((con.g1 == floor).sum()) / B:.2f} per env, penetrating "
          f"{int(pen.sum()) / B:.2f} per env ({int((pen.sum(0) > 0).sum())} "
          f"of {B} envs), among the solver's {lay['k_cone']} cones "
          f"{int(taken.sum()) / B:.2f} per env", flush=True)
    if not (int(pen.sum()) > 0 and int(taken.sum()) > 0):
        fail("imitation: no penetrating floor contact reached the solver")
    # solve_rows at 176 rows, the wide instance
    R_i, args_i, kw_i, b1_fi = hold_rows(
        "imitation", env_i, state_i, launched_i,
        lambda dt_: WI.make_walk_imitation("cpu", dtype=dt_).model,
        (108, 176, SK.CPL_WIDE))
    # the wide instance on random inputs over walk_imitation's tree
    p_w = SK.random_rows_problem(B, seed=0, nbody=mi.nbody, kl=32, kc=48,
                                 parent=np.asarray(mi.dof_parentid))
    ld_w, dinv_w = TL.factor(mi.tree, torch.as_tensor(p_w["Ms"], dtype=f32,
                                                      device=dev))
    rnd_w = {k: torch.as_tensor(p_w[k], device=dev).to(
        torch.int32 if p_w[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_w.update(ld=ld_w, dinv=dinv_w)
    check_rows("random wide", mi.tree, rnd_w,
               dict(rnd_kw, kl=32, kc=48))
    del rnd_w, p_w
    hold_upsolve("imitation", mi, args_i)
    del state_i, con, pen, taken
    # upsolve_build_yd and apgd_iterate at 176 rows
    stage_keys("imitation",
               hold_stages("imitation", mi.tree, args_i, kw_i, b1_fi)[2])
    del args_i

    mark(9)
    # ---- 10. flight_imitation --------------------------------------------
    env_f = flight_imitation()
    mf = env_f.model
    if env_f.n_substeps != 4:
        fail(f"flight: {env_f.n_substeps} substeps per control step")
    state_f, launched_f, _ = env_phase("flight", env_f, FLIGHT_STEPS)
    fluid = state_f.data.qfrc_fluid.abs().amax(dim=0)
    print(f"flight: max |qfrc_fluid| per env: least {fluid.min().item():.3e}"
          f", most {fluid.max().item():.3e}", flush=True)
    if not bool((fluid > 0).all()):
        fail(f"flight: no fluid force in {int((fluid == 0).sum())} envs")
    # solve_rows at 64 rows over 42 dofs, the narrow instance
    R_f, args_f, kw_f, b1_ff = hold_rows(
        "flight", env_f, state_f, launched_f,
        lambda dt_: FI.make_flight_imitation("cpu", dtype=dt_).model,
        (42, 64, SK.CPL_NARROW))
    del state_f
    # upsolve_build_yd, upsolve_yd and apgd_iterate at 64 rows over 42 dofs
    stage_keys("flight",
               hold_stages("flight", mf.tree, args_f, kw_f, b1_ff)[2])
    hold_upsolve("flight", mf, args_f)
    del args_f

    # the template task: the APGD solver, no hand kernel
    env_t = template_task()
    lo_t, hi_t = env_t.action_spec()
    mid_t = torch.as_tensor((lo_t + hi_t) / 2, dtype=f32,
                            device=dev)[None].expand(TEMPLATE_B, -1)
    state_t = env_t.reset(TEMPLATE_B)
    torch.cuda.synchronize()
    zero_counts()
    state_t = env_t.autoreset_step(state_t, mid_t)
    torch.cuda.synchronize()
    launched_t = counts()
    print(f"template: B={TEMPLATE_B} one control step ({env_t.n_substeps} "
          f"substeps, contact solver {env_t.model.opt.contact_solver!r}); "
          f"launches {launched_t} (expected 0 of every kernel)", flush=True)
    if any(launched_t.values()):
        fail("template: a hand kernel was launched")
    for k, v in state_t.obs.items():
        if not bool(torch.isfinite(v).all()):
            fail(f"template obs {k} not finite")
    print(f"template: obs {len(state_t.obs)} keys, "
          f"{sum(v.shape[1] for v in state_t.obs.values())} floats per env, "
          f"all finite; reward {state_t.reward.mean().item():.1f}",
          flush=True)

    mark(10)
    # ---- 11. vision_guided_flight ----------------------------------------
    from flybody_tpu_torch.agents.dmpo import DMPOConfig, DMPOLearner
    from flybody_tpu_torch.agents.networks import (VisionCritic,
                                                   VisionPolicy,
                                                   batch_concat, obs_layout)
    from flybody_tpu_torch.agents.train import EYE_KEYS
    from flybody_tpu_torch.ops import raycast
    from flybody_tpu_torch.physics import collision as COL
    env_v = vision_guided_flight()
    mv, task_v = env_v.model, env_v.task
    if env_v.n_substeps != 4:
        fail(f"vision: {env_v.n_substeps} substeps per control step")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_v, launched_v, step_s = env_phase("vision", env_v, VISION_STEPS)
    peak_v = torch.cuda.max_memory_allocated()
    dv = state_v.data
    # no eye lies inside a geom of its body that it casts against, and the
    # eyes see the terrain (EYE_TERRAIN_*)
    for (key, view), ids in zip(eye_view(task_v, dv).items(),
                                task_v.eye_geoms):
        share = view["share"]
        q01_v = float(torch.quantile(share, 0.01))
        med_v = float(share.median())
        print(f"vision: {key}: casts {len(ids)} of "
              f"{len(task_v.scene_geoms)} geoms; inside one of its body's "
              f"in {len(view['inside']['own'])} envs, another body's "
              f"(env, geom) {view['inside']['other'][:8]}; terrain the "
              f"nearest hit of {100 * float(share.min()):.2f} % of the "
              f"pixels in the least env, {100 * q01_v:.2f} % at the 1st "
              f"percentile, {100 * med_v:.2f} % in the median, "
              f"{100 * float(share.max()):.2f} % in the most", flush=True)
        if view["inside"]["own"]:
            fail(f"vision: {key} lies inside a geom of its body that it "
                 f"casts against: (env, geom) {view['inside']['own'][:8]}")
        if q01_v < EYE_TERRAIN_Q01 or not (
                EYE_TERRAIN_MEDIAN[0] <= med_v <= EYE_TERRAIN_MEDIAN[1]):
            fail(f"vision: {key} sees the terrain in {q01_v:.3f} of its "
                 f"pixels at the 1st percentile of the envs, {med_v:.3f} "
                 f"in the median (bands {EYE_TERRAIN_Q01}, "
                 f"{EYE_TERRAIN_MEDIAN})")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    task_v.render_eyes(mv, dv)
    torch.cuda.synchronize()
    render_peak = torch.cuda.max_memory_allocated() - base
    render_ms = cuda_ms(lambda: task_v.render_eyes(mv, dv), 5)
    # two renders per control step: the step's obs and the fresh batch of
    # the auto-reset
    print(f"vision: eye render (both eyes, B={B}, {task_v.rays.shape[0]}x"
          f"{task_v.rays.shape[1]}, chunks of {raycast.RENDER_CHUNK} envs) "
          f"{render_ms:.2f} ms per call, 2 calls per control step = "
          f"{2 * render_ms:.2f} ms of {1e3 * step_s:.1f} ms "
          f"({100 * 2e-3 * render_ms / step_s:.1f} %); device memory: a "
          f"render's peak {render_peak / 1e9:.2f} GB over {base / 1e9:.2f} "
          f"GB held, the phase's peak {peak_v / 1e9:.2f} GB | {smi}",
          flush=True)
    cpu_v = {dt_: VF.make_vision_flight("cpu", dtype=dt_).model
             for dt_ in (f32, f64)}
    # 4 envs lowered until their deepest terrain pair penetrates ~0.002
    # (a pair on a trench wall, its normal near horizontal, moves less
    # than the fly: lower again until one penetrates)
    ter_g = mv.names["geom"]["terrain"]
    hslots = mv.ix(np.nonzero(COL.slot_layout(mv).g1 == ter_g)[0])
    touch = first_four(dv)
    lowered = np.zeros(4)
    for _ in range(8):
        d4 = F.fwd_position(mv, bridge.data_from_numpy(touch, mv))
        dmin = COL._narrowphase(mv, d4)[0][hslots].amin(dim=0)
        dmin = dmin.double().cpu().numpy()
        dz = np.where(dmin > -0.001, dmin + 0.002, 0.0)
        touch["qpos"][2] -= dz
        lowered += dz
    out = substep_check("vision touching", mv, "fused", small=touch,
                        cpu=cpu_v)
    con = out.contact
    pen = (con.g1 == ter_g) & (con.dist < 0)
    lay_v = SF.fused_layout(mv, C.efc_meta(mv))
    cone_rows = mv.ix(np.concatenate([np.arange(a, b)
                                      for a, b in lay_v["cone"]]))
    taken = torch.gather(pen, 0, cone_rows[out.sol_cone_sel.long()])
    print(f"vision: 4 envs lowered by {lowered.round(4).tolist()} to a "
          f"deepest terrain pair at {dmin.round(4).tolist()}: "
          f"terrain contacts selected {(con.g1 == ter_g).sum(0).tolist()}, "
          f"penetrating {pen.sum(0).tolist()}, among the solver's "
          f"{lay_v['k_cone']} cones {taken.sum(0).tolist()}", flush=True)
    if not (bool(pen.any(0).all()) and bool(taken.any(0).all())):
        fail("vision: a penetrating terrain contact did not reach the "
             "solver in every env")
    del d4, out, con, pen, taken
    # solve_rows at 88 rows over 42 dofs, the narrow instance
    R_v = hold_rows("vision", env_v, state_v, launched_v,
                    lambda dt_: cpu_v[dt_], (42, 88, SK.CPL_NARROW))[0]
    # learner updates with the vision networks on the phase's obs
    keys_v, slices_v = obs_layout(state_v.obs)
    obs_v = sum(v[1] for v in slices_v.values())
    eyes_v = tuple(slices_v[k] for k in EYE_KEYS)
    pool = batch_concat(state_v.obs, keys=keys_v,
                        num_batch_dims=1).double().cpu().numpy()
    del state_v, dv
    vcfg = DMPOConfig(batch_size=VISION_BATCH, n_step=5, num_samples=20)
    gen_v = torch.Generator().manual_seed(0)
    act_v = env_v.action_size
    learner_v = DMPOLearner(
        VisionPolicy(obs_v, act_v, eyes_v, generator=gen_v).to(dev),
        VisionCritic(obs_v, act_v, eyes_v, generator=gen_v).to(dev),
        act_v, obs_v, vcfg)
    print(f"vision update: VisionPolicy and VisionCritic on {obs_v} obs "
          f"floats ({len(eyes_v)} eyes of {eyes_v[0][2]}), batch "
          f"{VISION_BATCH}", flush=True)
    update_check(learner_v, vcfg, obs_pool=pool, tag="vision update")
    del pool, learner_v

    mark(11)
    # ---- 12. agents ------------------------------------------------------
    import shutil
    import tempfile
    from flybody_tpu_torch.agents.actors import canonical_to_real, flat_obs
    from flybody_tpu_torch.agents.evaluator import make_evaluator, save_video
    from flybody_tpu_torch.agents.multitask import MultiTaskDMPOTrainer
    from flybody_tpu_torch.agents.train import DMPOTrainer
    from flybody_tpu_torch.io import checkpoint as ckpt
    from flybody_tpu_torch.utils import rendering

    def expect(label, want):
        """Fail unless this sub-phase launched solve_rows exactly ``want``
        times and no other kernel."""
        got = counts()
        print(f"{label}: launches {got} (expected solve_rows {want}, the "
              f"others 0)", flush=True)
        if got != dict({k: 0 for k in wrappers}, solve_rows=want):
            fail(f"{label}: solve_rows was not launched {want} times")
        return want

    def rows_of(model) -> int:
        return SF.fused_layout(model, C.efc_meta(model))["R"]

    R_wob, R_wi = rows_of(m), rows_of(mi)
    agent_s = {}

    def hold_final(label, model, data, want_R):
        """solve_rows against its plain version on the next substep of a
        sub-phase's final state, at that sub-phase's batch (as phase 8
        does); B1's row gains ``max_abs_err_<label>``. Its one launch
        comes after the sub-phase's count was read."""
        d_h = F.smooth_forward(model, data)
        prob = SF.assemble(model, d_h)
        R_h, B_h = prob["args"]["u6"].shape[0], d_h.qacc_smooth.shape[-1]
        print(f"{label}: solve_rows on the final state, R {R_h}, B={B_h}",
              flush=True)
        if R_h != want_R:
            fail(f"{label}: {R_h} rows, expected {want_R}")
        rows["solve_rows"][f"max_abs_err_{label}"] = check_rows(
            label, model.tree, prob["args"], prob["kw"])[1]

    def recording(env_x, name, last):
        """``env_x.<name>`` (a step function) on the instance, keeping the
        state it returned last in ``last["state"]``; ``del env_x.<name>``
        restores the method."""
        step = getattr(env_x, name)

        def wrapped(*args, **kwargs):
            last["state"] = out = step(*args, **kwargs)
            return out
        setattr(env_x, name, wrapped)

    # 12a: the intention network on walk_imitation at the published widths
    # of configs/train_config_rodent_imitation.yaml
    t12 = time.perf_counter()
    acfg = TrainerConfig(
        num_envs=AGENT_ENVS, unroll_length=AGENT_UNROLL,
        replay_capacity=1_000_000, min_replay_size=AGENT_MIN_REPLAY,
        samples_per_insert=32.0, network="intention", intention_size=60,
        encoder_layers=(1024, 1024), decoder_layers=(1024, 1024),
        critic_layers=(1024, 1024, 1024),
        dmpo=DMPOConfig(batch_size=256, n_step=5, num_samples=20,
                        intention_kl_weight=1e-4))
    launched_a, tr_a, loop_a, metrics_a, (roll_a, upd_a) = train_phase(
        env_i, acfg, AGENT_ITERATIONS, zero_counts, counts, smi,
        label="intention")
    n_a = AGENT_ITERATIONS * AGENT_ENVS * AGENT_UNROLL
    kl = metrics_a.get("intention_kl")
    if kl is None or not bool(torch.isfinite(kl)):
        fail("intention: intention_kl missing or not finite")
    n_upd_a = AGENT_ITERATIONS * tr_a.updates_per_iter
    print(f"intention: task keys {list(tr_a.obs_keys[:2])}, task prefix "
          f"{tr_a.task_obs_size} of {tr_a.obs_size} obs floats, solve_rows "
          f"at R {R_wi}; intention_kl {float(kl):.4e}; rollout "
          f"{sum(roll_a):.3f} s ({n_a / sum(roll_a):.1f} env-steps/s), "
          f"{1e3 * sum(upd_a) / n_upd_a:.2f} ms per update at the "
          f"1024-wide nets ({n_upd_a} updates) | {smi}", flush=True)
    hold_final("intention", mi, loop_a.env_states.data, R_wi)
    update_check(tr_a.learner, acfg.dmpo, tag="intention update")
    policy_a, keys_a = loop_a.train.policy, tr_a.obs_keys
    rows["solve_rows"]["launches_intention"] = launched_a["solve_rows"]
    donor_dir = tempfile.mkdtemp(prefix="chip_smoke_donor_")
    donor_path = ckpt.save(donor_dir, {"train": loop_a.train})
    del loop_a, metrics_a
    agent_s["intention"] = time.perf_counter() - t12

    # 12b: transfer: configs/train_config_bowl_transfer.yaml's two-level
    # encoder, the donor's decoder restored from its checkpoint and frozen
    t12 = time.perf_counter()
    bcfg = dataclasses.replace(
        acfg, high_level_intention_size=45, encoder_layers=(512, 512, 512),
        critic_layers=(1024, 1024, 512, 512, 512), freeze_decoder=True,
        dmpo=dataclasses.replace(acfg.dmpo, discount=0.97))
    tr_b = DMPOTrainer(env_i, bcfg)
    loop_b = tr_b.init(1)
    donor = ckpt.restore_policy_params(donor_path)
    shutil.rmtree(donor_dir)
    tr_b.restore_decoder(loop_b.train, donor)
    dec_keys = [k for k in donor if k.startswith("decoder.")]

    def decoder_is_donor(when):
        for net in ("policy", "target_policy"):
            sd = getattr(loop_b.train, net).state_dict()
            same = all(torch.equal(sd[k].cpu(), donor[k]) for k in dec_keys)
            print(f"transfer: {net} decoder ({len(dec_keys)} tensors) "
                  f"bit-identical to the donor's {when}: {same}", flush=True)
            if not same:
                fail(f"transfer: the {net} decoder differs from the donor's "
                     f"{when}")

    decoder_is_donor("before training")
    enc0 = param_vector(loop_b.train.policy.encoder)
    torch.cuda.synchronize()
    zero_counts()
    loop_b, metrics_b = tr_b.train_iteration(loop_b)
    torch.cuda.synchronize()
    launched_b = expect("transfer", AGENT_UNROLL * env_i.n_substeps)
    decoder_is_donor("after one iteration")
    moved_b = rel_norm(param_vector(loop_b.train.policy.encoder), enc0)
    print(f"transfer: learner_steps {loop_b.train.steps} (expected "
          f"{tr_b.updates_per_iter}); the encoder moved by {moved_b:.3e} "
          f"(relative norm); intention_kl "
          f"{float(metrics_b['intention_kl']):.4e}", flush=True)
    if loop_b.train.steps != tr_b.updates_per_iter or not moved_b > 0:
        fail("transfer: the encoder did not train")
    hold_final("transfer", mi, loop_b.env_states.data, R_wi)
    rows["solve_rows"]["launches_transfer"] = launched_b
    del tr_b, loop_b, metrics_b, donor
    agent_s["transfer"] = time.perf_counter() - t12

    # 12c: multi-task over walk_on_ball and walk_imitation (one 59-dim
    # action space) with configs/train_config_two_tasks.yaml's networks
    t12 = time.perf_counter()
    ccfg = TrainerConfig(
        unroll_length=AGENT_UNROLL, replay_capacity=1_000_000,
        min_replay_size=AGENT_MIN_REPLAY, samples_per_insert=32.0,
        policy_layers=(512, 512, 512), critic_layers=(512, 512, 512),
        dmpo=DMPOConfig(batch_size=512, n_step=5, num_samples=20))
    tr_c = MultiTaskDMPOTrainer(
        {"walk_on_ball": env, "walk_imitation": env_i},
        {"walk_on_ball": MULTI_ENVS, "walk_imitation": MULTI_ENVS}, ccfg)
    roll_c = {k: [] for k in tr_c.names}

    def timed(name, fn):
        def rollout(*args):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            roll_c[name].append(time.perf_counter() - t)
            return out
        return rollout

    tr_c.rollout_fns = {k: timed(k, f) for k, f in tr_c.rollout_fns.items()}
    loop_c = tr_c.init(2)
    torch.cuda.synchronize()
    zero_counts()
    iter_c = []
    for _ in range(AGENT_ITERATIONS):
        t = time.perf_counter()
        loop_c, metrics_c = tr_c.train_iteration(loop_c)
        torch.cuda.synchronize()
        iter_c.append(time.perf_counter() - t)
    want_c = {k: AGENT_ITERATIONS * AGENT_UNROLL * tr_c.envs[k].n_substeps
              for k in tr_c.names}
    launched_c = expect("multitask", sum(want_c.values()))
    # each task's B1 instance: the narrow one at walk_on_ball's R, the
    # wide one at walk_imitation's
    per_task = {k: sum(n for name, n in traced_names.items()
                       if f"solve_rows_kernel<{SK.tile_cpl(R)}>" in name)
                for k, R in (("walk_on_ball", R_wob),
                             ("walk_imitation", R_wi))}
    print(f"multitask: solve_rows launches by task {per_task} (expected "
          f"{want_c}) at R {{'walk_on_ball': {R_wob}, 'walk_imitation': "
          f"{R_wi}}}", flush=True)
    if per_task != want_c or (R_wob, R_wi) != (152, 176):
        fail("multitask: both B1 instances did not run their share")
    want_steps = len(tr_c.names) * tr_c.updates_per_table * AGENT_ITERATIONS
    sizes = {k: loop_c.replays[k].size for k in tr_c.names}
    print(f"multitask: learner_steps {loop_c.train.steps} (expected "
          f"{want_steps}), replay tables {sizes} of "
          f"{loop_c.replays[tr_c.names[0]].capacity}", flush=True)
    if loop_c.train.steps != want_steps or min(sizes.values()) != \
            AGENT_ITERATIONS * MULTI_ENVS * AGENT_UNROLL:
        fail("multitask: wrong number of updates or transitions")
    bad = [k for k, v in metrics_c.items() if "/" in k and not bool(
        torch.isfinite(torch.as_tensor(v)).all())]
    if bad:
        fail(f"multitask: non-finite per-task metrics {bad}")
    for k, (model_k, R_k) in (("walk_on_ball", (m, R_wob)),
                              ("walk_imitation", (mi, R_wi))):
        hold_final(f"multitask_{k}", model_k, loop_c.env_states[k].data, R_k)
    for i, total in enumerate(iter_c):
        rolls = {k: round(v[i], 3) for k, v in roll_c.items()}
        print(f"multitask: iteration {i + 1} {total:.3f} s = rollouts "
              f"{rolls} s + updates {total - sum(rolls.values()):.3f} s "
              f"({len(tr_c.names) * tr_c.updates_per_table} updates) | "
              f"{smi}", flush=True)
    rows["solve_rows"]["launches_multitask"] = launched_c
    del tr_c, loop_c, metrics_c
    agent_s["multitask"] = time.perf_counter() - t12

    # 12d: the evaluator on walk_imitation, episodes of 10 control steps
    t12 = time.perf_counter()
    env_e = walk_imitation(time_limit=EVAL_STEPS * env_i.task.ctrl_dt)
    if env_e.episode_steps != EVAL_STEPS:
        fail(f"evaluator: episodes of {env_e.episode_steps} control steps")
    evaluate = make_evaluator(env_e, EVAL_EPISODES, obs_keys=keys_a)
    last_e = {}
    recording(env_e, "step", last_e)
    torch.cuda.synchronize()
    zero_counts()
    t = time.perf_counter()
    stats_e = evaluate(policy_a, torch.Generator(dev).manual_seed(0))
    torch.cuda.synchronize()
    dt_e = time.perf_counter() - t
    launched_e = expect("evaluator", EVAL_STEPS * env_e.n_substeps)
    stats_e = {k: float(v) for k, v in stats_e.items()}
    print(f"evaluator: {EVAL_EPISODES} episodes of {EVAL_STEPS} control "
          f"steps in {dt_e:.3f} s, the reset included ("
          f"{1e3 * dt_e / EVAL_STEPS:.1f} ms per control step); "
          f"{json.dumps(stats_e)} | {smi}", flush=True)
    if not all(np.isfinite(v) for v in stats_e.values()) or not \
            stats_e["eval_episode_length_mean"] <= EVAL_STEPS:
        fail("evaluator: stats not finite or episodes too long")
    hold_final("eval", env_e.model, last_e["state"].data, R_wi)
    rows["solve_rows"]["launches_eval"] = launched_e
    del env_e, evaluate
    agent_s["evaluator"] = time.perf_counter() - t12

    # 12e: rendered reward channels of 12a's policy on walk_imitation
    t12 = time.perf_counter()
    t = time.perf_counter()
    lib = rendering.build()
    print(f"render: rasterizer {os.path.relpath(lib, ROOT)} built in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    lo_i, hi_i = (torch.as_tensor(x, dtype=f32, device=dev)
                  for x in env_i.action_spec())

    def policy_fn(obs):
        return canonical_to_real(policy_a(flat_obs(obs, keys_a)).mode(),
                                 lo_i, hi_i)

    last_r = {}
    recording(env_i, "autoreset_step", last_r)
    zero_counts()
    t = time.perf_counter()
    frames, resets, channels = rendering.render_with_rewards_info(
        env_i, policy_fn, torch.Generator(dev).manual_seed(0),
        n_steps=RENDER_STEPS, width=320, height=240)
    dt_r = time.perf_counter() - t
    launched_r = expect("render", RENDER_STEPS * env_i.n_substeps)
    del env_i.autoreset_step
    hold_final("render", mi, last_r["state"].data, R_wi)
    weights = {"com": 20.0, "qvel": 1.0, "end_effectors": 1.0,
               "joints": 1.0}
    for i, (frame, ch) in enumerate(zip(frames, channels)):
        if frame.shape != (240, 320, 3) or frame.dtype != np.uint8:
            fail(f"render: frame {i} is {frame.shape} {frame.dtype}")
        px = frame.reshape(-1, 3)
        sky = np.all(px == rendering.SKY, axis=1)
        floor = np.all(px == frame[-1, 160], axis=1)
        fly = int((~sky & ~floor).sum())
        colours = len(np.unique(px, axis=0))
        print(f"render: frame {i} {colours} colours, {int(sky.sum())} sky, "
              f"{int(floor.sum())} floor, {fly} fly pixels; channels "
              f"{json.dumps({k: float(f'{v:.4e}') for k, v in ch.items()})}",
              flush=True)
        if fly < 50 or colours < 3:
            fail(f"render: frame {i} does not show the fly")
        # each DeepMimic factor is exp(-d) in [0, 1] times its weight
        # (20, 1, 1, 1: walk_imitation's)
        if sorted(ch) != sorted(weights) or not all(
                np.isfinite(v) and 0.0 <= v / weights[k] <= 1.0
                for k, v in ch.items()):
            fail(f"render: reward channels {ch}")
    cam = rendering.track_camera(np.zeros(3))
    st_r = env_i.reset(1)
    t = time.perf_counter()
    for _ in range(RENDER_STEPS):
        rendering.render_frame(env_i.model, st_r.data, *cam)
    ms_frame = 1e3 * (time.perf_counter() - t) / RENDER_STEPS
    video = save_video(frames, os.path.join(tempfile.gettempdir(),
                                            "chip_smoke_eval.mp4"))
    print(f"render: {RENDER_STEPS} control steps with frames and channels "
          f"in {dt_r:.3f} s; the rasterizer {ms_frame:.1f} host ms per "
          f"320x240 frame (the copy to the host included); episode ends at "
          f"{resets}; video {video} | {smi}", flush=True)
    if not video.endswith(".npz") or not np.array_equal(
            np.load(video)["frames"], np.stack(frames)):
        fail("render: save_video did not write the frames to an .npz")
    os.remove(video)
    rows["solve_rows"]["launches_render"] = launched_r
    del frames, st_r, policy_a, last_r, last_e
    agent_s["render"] = time.perf_counter() - t12
    walls = {k: round(v, 1) for k, v in agent_s.items()}
    print(f"agents: wall s {json.dumps(walls)} | {smi}", flush=True)

    mark(12)
    # ---- 13. rodent ------------------------------------------------------
    from flybody_tpu_torch import rodent_envs
    from flybody_tpu_torch.physics import types as T
    t13 = time.perf_counter()
    rodent_s = {}
    # (a) rodent_two_touch, the rat on a floor: 20 substeps per control step
    env_r = rodent_envs.rodent_two_touch()
    mr = env_r.model
    if env_r.n_substeps != 20:
        fail(f"rodent: {env_r.n_substeps} substeps per control step")
    state_r, launched_r, _ = env_phase("rodent", env_r, RODENT_STEPS)
    kin_gate("rodent", traced["kinematics"], RODENT_STEPS,
             env_r.n_substeps)
    kin_launched_r = traced["kinematics"]
    hk = hold_kin("rodent", KK, K, mr, state_r.data)
    rows["kinematics"].update(
        launches_rodent=kin_launched_r,
        max_abs_err_rodent=hk["err"], ms_rodent=hk["ms"],
        plain_ms_rodent=hk["plain_ms"], bound_ms_rodent=hk["bound_ms"])
    rodent_s["two_touch"] = time.perf_counter() - t13
    def lowered(label, env_x, data, ground, other=None, pitch=None):
        """The first 4 envs of ``data`` (numpy), the root turned nose down
        by ``pitch`` (with the joints at the model's qpos0) where given,
        then lowered until the deepest contact of geom ``ground`` with a
        geom of type ``other`` (any) lies 2 mm deep."""
        mx = env_x.model
        gt = np.asarray(mx.geom_type)
        g1, g2 = COL.slot_layout(mx).g1, COL.slot_layout(mx).g2
        slots = mx.ix(np.nonzero((g1 == ground) & (
            (gt[g2] == other) if other is not None else True))[0])
        small_x = first_four(data)
        if pitch is not None:
            small_x["qpos"][7:] = mx.qpos0[7:, None].cpu().numpy()
            small_x["qpos"][3:7] = np.array(
                [np.cos(pitch / 2), 0.0, np.sin(pitch / 2), 0.0],
                np.float32)[:, None]
        for _ in range(6):
            d4 = F.fwd_position(mx, bridge.data_from_numpy(small_x, mx))
            dmin = COL._narrowphase(mx, d4)[0][slots].amin(dim=0)
            small_x["qpos"][2] -= dmin.cpu().numpy() + 0.002
        print(f"{label}: 4 envs lowered onto geom {ground} to a deepest "
              f"pair at {dmin.cpu().numpy().round(4).tolist()} before the "
              f"last step", flush=True)
        return small_x

    def contacts_taken(label, mx, out, ground, other=None):
        """Fail unless each env's substep ``out`` selected a penetrating
        contact of geom ``ground`` (with a geom of type ``other``) among
        the fused solver's cones."""
        con = out.contact
        hit = con.g1 == ground
        if other is not None:
            hit = hit & (mx.const(np.asarray(mx.geom_type),
                                  torch.int64)[con.g2.long()] == other)
        pen = hit & (con.dist < 0)
        lay_x = SF.fused_layout(mx, C.efc_meta(mx))
        cone_x = mx.ix(np.concatenate([np.arange(a, b)
                                       for a, b in lay_x["cone"]]))
        taken = torch.gather(pen, 0, cone_x[out.sol_cone_sel.long()])
        print(f"{label}: contacts selected {hit.sum(0).tolist()}, "
              f"penetrating {pen.sum(0).tolist()}, among the solver's "
              f"{lay_x['k_cone']} cones {taken.sum(0).tolist()}", flush=True)
        if not bool(taken.any(0).all()):
            fail(f"{label}: a penetrating contact did not reach the solver "
                 "in every env")

    # (b) the heightfield arenas, B envs each; then 4 envs of
    # gaps' and bowl's final states lowered onto the terrain, one substep
    # card vs CPU with penetrating heightfield contacts in the solver
    hf_contacts = 0
    for name, label in (("rodent_run_gaps", "gaps"),
                        ("rodent_escape_bowl", "bowl"),
                        ("rodent_maze_forage", "maze")):
        t = time.perf_counter()
        env_h = getattr(rodent_envs, name)()
        st_h, launched_h, _ = env_phase(f"rodent_{label}", env_h,
                                        RODENT_HF_STEPS)
        con = st_h.data.contact
        ter = env_h.model.names["geom"]["terrain"]
        sel_h = con.g1 == ter
        pen_h = sel_h & (con.dist < 0)
        print(f"rodent_{label}: heightfield contacts selected "
              f"{int(sel_h.sum()) / B:.2f} per env "
              f"({int(sel_h.any(0).sum())} of {B} envs), "
              f"penetrating {int(pen_h.sum()) / B:.2f} per env",
              flush=True)
        rows["solve_rows"][f"launches_rodent_{label}"] = \
            launched_h["solve_rows"]
        if label != "maze":
            hf_contacts += int(sel_h.sum())
            touch = lowered(f"rodent_{label} touching", env_h, st_h.data,
                            ter)
            out = substep_check(
                f"rodent_{label} touching", env_h.model, "fused",
                small=touch, cpu={dt_: getattr(rodent_envs, name)(
                    device="cpu", dtype=dt_).model for dt_ in (f32, f64)})
            contacts_taken(f"rodent_{label} touching", env_h.model, out, ter)
            del out
        del env_h, st_h, con, sel_h, pen_h
        rodent_s[label] = time.perf_counter() - t
    if hf_contacts == 0:
        fail("rodent: no heightfield contact selected on gaps or bowl")
    # (c) one substep of 4 envs card vs CPU from the final state (in
    # hold_rows below) and from a head-down state: the root pitched nose
    # down (the joints at qpos0) and lowered until the skull and jaw boxes
    # press 2 mm into the floor, so the plane-box pairs run on the card
    cpu_r = {dt_: rodent_envs.rodent_two_touch(device="cpu", dtype=dt_).model
             for dt_ in (f32, f64)}
    floor = mr.names["geom"]["floor"]
    head = lowered("rodent head down", env_r, state_r.data, floor,
                   T.GEOM_BOX, pitch=1.2)
    out = substep_check("rodent head down", mr, "fused", small=head,
                        cpu=cpu_r)
    contacts_taken("rodent head down (plane-box)", mr, out, floor,
                   T.GEOM_BOX)
    del out
    # (d) solve_rows at 96 rows over 73 dofs, the narrow instance, on the
    # final state's inputs and on random inputs over the rat's tree
    hold_rows("rodent", env_r, state_r, launched_r, lambda dt_: cpu_r[dt_],
              (73, 96, SK.CPL_NARROW))
    p_r = SK.random_rows_problem(B, seed=0, nbody=mr.nbody, kl=24, kc=24,
                                 parent=np.asarray(mr.dof_parentid))
    ld_r, dinv_r = TL.factor(mr.tree, torch.as_tensor(p_r["Ms"], dtype=f32,
                                                      device=dev))
    rnd_r = {k: torch.as_tensor(p_r[k], device=dev).to(
        torch.int32 if p_r[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_r.update(ld=ld_r, dinv=dinv_r)
    rows["solve_rows"]["max_abs_err_rodent_random"] = check_rows(
        "rodent_random", mr.tree, rnd_r, dict(rnd_kw, kl=24, kc=24))[1]
    del rnd_r, p_r, state_r
    rodent_s["holds"] = time.perf_counter() - t13 - sum(rodent_s.values())
    # (e) DMPOTrainer with configs/train_config_two_taps.yaml's networks at
    # its 64 envs, training once its first rollout is in replay
    t = time.perf_counter()
    rcfg = TrainerConfig(
        num_envs=RODENT_TRAIN_ENVS, unroll_length=AGENT_UNROLL,
        replay_capacity=1_000_000,
        min_replay_size=RODENT_TRAIN_ENVS * AGENT_UNROLL,
        samples_per_insert=32.0, policy_layers=(512, 512, 512, 512),
        critic_layers=(512, 512, 512, 256),
        dmpo=DMPOConfig(batch_size=512, n_step=5, num_samples=20))
    launched_rt, tr_r, loop_r = train_phase(
        env_r, rcfg, 1, zero_counts, counts, smi, label="rodent_train",
        min_copies=0)[:3]
    hold_final("rodent_train", mr, loop_r.env_states.data, 96)
    update_check(tr_r.learner, rcfg.dmpo, tag="rodent update")
    rows["solve_rows"]["launches_rodent_train"] = launched_rt["solve_rows"]
    del tr_r, loop_r
    rodent_s["train"] = time.perf_counter() - t
    print(f"rodent: wall s "
          f"{json.dumps({k: round(v, 1) for k, v in rodent_s.items()})} | "
          f"{smi}", flush=True)

    mark(13)
    # ---- 14. tracking ----------------------------------------------------
    from flybody_tpu_torch import render_stac, train_dmpo
    from flybody_tpu_torch.inverse_kinematics import qpos_from_site_xpos
    from flybody_tpu_torch.physics import kinematics as K
    t14 = time.perf_counter()
    track_s = {}

    def head(data, n):
        """The numpy state of the first ``n`` envs of ``data``."""
        return {k: ({kk: vv[..., :n] for kk, vv in v.items()}
                    if isinstance(v, dict) else v[..., :n])
                for k, v in bridge.to_numpy(data).items()}

    def task_check(label, env_x, st, cpu_envs):
        """(c) The tracking task's observations, reward, channels,
        termination and discount of the first TASK_B envs of ``st`` on the
        card against the CPU envs' (float32; each bound raised by the CPU's
        float32-to-float64 distance). Termination and discount must agree
        but where the env's termination error lies within TIE_TERM of the
        threshold."""
        small = head(st.data, TASK_B)
        ts_small = {k: v[:TASK_B] for k, v in st.task_state.items()}
        outs = {}
        for tag, e in (("card", env_x), (f32, cpu_envs[f32]),
                       (f64, cpu_envs[f64])):
            mm, task = e.model, e.task
            dd = bridge.data_from_numpy(small, mm)
            tt = {k: v.to(mm.device) for k, v in ts_small.items()}
            sm = dd.sensordata
            vals = dict(task.observations(mm, dd, tt, sm))
            r, term, disc = task.reward_term_discount(mm, dd, tt, sm)
            vals.update({f"channel {k}": v for k, v in
                         task.reward_factors(mm, dd, tt, sm).items()},
                        reward=r)
            err = task._reward(mm, dd, tt)[2]
            outs[tag] = ({k: v.cpu() for k, v in vals.items() if v.numel()},
                         term.cpu(), disc.cpu(), err.cpu())
        worst = (0.0, "", 0.0)
        for k, c32 in outs["card"][0].items():
            r32, r64 = outs[f32][0][k], outs[f64][0][k]
            rel, rel32 = max_rel(c32, r32), max_rel(r32, r64)
            bound = max(TOL_TASK, F64_FACTOR * rel32)
            if not rel <= bound:
                fail(f"{label} task {k}: card vs cpu max_rel {rel:.3e} > "
                     f"{bound:.3g}")
            worst = max(worst, (rel / bound, k, rel))
        thr = env_x.task.termination_error_threshold
        near = (outs[f32][3] - thr).abs() <= TIE_TERM * thr
        differ = ((outs["card"][1] != outs[f32][1])
                  | (outs["card"][2] != outs[f32][2])) & ~near
        print(f"{label}: task outputs at B={TASK_B} card vs cpu, "
              f"{len(outs['card'][0])} outputs within their bounds (nearest "
              f"its bound: {worst[1]} max_rel {worst[2]:.3e}); terminated "
              f"{int(outs['card'][1].sum())}, discount 0 in "
              f"{int((outs['card'][2] == 0).sum())}, termination or "
              f"discount apart in {int(differ.sum())} envs (near the "
              f"threshold {int(near.sum())})", flush=True)
        if bool(differ.any()):
            fail(f"{label}: termination or discount differs card vs cpu")

    # (a) rodent_walk_imitation (the foot-mods rat, 20 substeps of 1 ms)
    # and (b) walk_humanoid (6 substeps of 5 ms): B envs as env_phase runs
    # them, every clip drawn and every channel finite; (c) a substep of 4
    # envs card vs CPU and (d) solve_rows held on the final state, by
    # hold_rows; the task's outputs card vs CPU
    env_track = {}
    for name, label, n_sub, nv_t in (
            ("rodent_walk_imitation", "rodent_imitation", 20, 73),
            ("walk_humanoid", "humanoid", 6, 62)):
        t = time.perf_counter()
        env_t = getattr(rodent_envs, name)()
        if env_t.n_substeps != n_sub:
            fail(f"{label}: {env_t.n_substeps} substeps per control step")
        st_t, launched_t, _ = env_phase(label, env_t, TRACK_STEPS)
        ts_t, clips_t = st_t.task_state, env_t.task.clips
        drawn = sorted(ts_t["clip"].unique().tolist())
        start_ok = bool(((ts_t["start"] >= 0) & (
            ts_t["start"] < clips_t.lengths[ts_t["clip"]])).all())
        ch = env_t.task.reward_factors(env_t.model, st_t.data, ts_t,
                                       st_t.data.sensordata)
        means = {k: float(f"{v.mean().item():.4g}") for k, v in ch.items()}
        print(f"{label}: clips drawn {drawn} of {clips_t.num_clips}, starts "
              f"within their clips {start_ok}; reward channels (mean) "
              f"{json.dumps(means)}", flush=True)
        if drawn != list(range(clips_t.num_clips)) or not start_ok:
            fail(f"{label}: the clip and start draws")
        if not all(bool(torch.isfinite(v).all()) for v in ch.values()):
            fail(f"{label}: a reward channel is not finite")
        cpu_t = {dt_: getattr(rodent_envs, name)(device="cpu", dtype=dt_)
                 for dt_ in (f32, f64)}
        hold_rows(label, env_t, st_t, launched_t,
                  lambda dt_: cpu_t[dt_].model, (nv_t, 96, SK.CPL_NARROW))
        task_check(label, env_t, st_t, cpu_t)
        env_track[label] = (env_t, cpu_t)
        del st_t
        track_s[label] = time.perf_counter() - t
    # (d) solve_rows at 96 rows over the humanoid's 62 dofs on random inputs
    env_h, _ = env_track["humanoid"]
    mh = env_h.model
    p_h = SK.random_rows_problem(B, seed=0, nbody=mh.nbody, kl=24, kc=24,
                                 parent=np.asarray(mh.dof_parentid))
    ld_h, dinv_h = TL.factor(mh.tree, torch.as_tensor(p_h["Ms"], dtype=f32,
                                                      device=dev))
    rnd_h = {k: torch.as_tensor(p_h[k], device=dev).to(
        torch.int32 if p_h[k].dtype == np.int32 else f32)
        for k in fly_args if k not in ("ld", "dinv")}
    rnd_h.update(ld=ld_h, dinv=dinv_h)
    rows["solve_rows"]["max_abs_err_humanoid_random"] = check_rows(
        "humanoid_random", mh.tree, rnd_h, dict(rnd_kw, kl=24, kc=24))[1]
    del rnd_h, p_h
    env_rat, cpu_rat = env_track["rodent_imitation"]
    mrat, clips = env_rat.model, env_rat.task.clips

    # (e) inverse kinematics: the rat's sites of clip 0's 120 frames, from
    # joints perturbed by a seeded 0.1 rad; 20 iterations card vs CPU, the
    # site error over 200 iterations on the card
    t = time.perf_counter()
    n_fr = int(clips.lengths[0])
    sites = np.arange(mrat.nsite)
    adr = np.asarray(env_rat.task.walker.joint_qposadr)
    q_clip = clips.fields["qpos"][0, :n_fr].T.contiguous()
    target = K.kinematics(mrat, io_mj.make_data(mrat, n_fr).replace(
        qpos=q_clip)).site_xpos[mrat.ix(sites)]
    q_start = q_clip.clone()
    q_start[mrat.ix(adr)] += torch.as_tensor(
        0.1 * np.random.RandomState(0).randn(len(adr), n_fr), dtype=f32,
        device=dev)

    def ik(model_x, steps):
        q = q_start.to(model_x.device, model_x.dtype)
        return qpos_from_site_xpos(
            model_x, io_mj.make_data(model_x, n_fr).replace(qpos=q), sites,
            target.to(model_x.device, model_x.dtype), adr, lr=IK_LR,
            beta=IK_BETA, max_steps=steps)

    zero_counts()
    moved = {}
    for tag, mx in (("card", mrat), (f32, cpu_rat[f32].model),
                    (f64, cpu_rat[f64].model)):
        res = ik(mx, IK_HOLD_STEPS)
        moved[tag] = (res.qpos.cpu().double() - q_start.cpu().double(),
                      res.site_error.cpu().double())
    rel = rel_norm(moved["card"][0], moved[f32][0])
    rel32 = rel_norm(moved[f32][0], moved[f64][0])
    ik_bound = max(TOL_IK, F64_FACTOR * rel32)
    err_rel = max_rel(moved["card"][1], moved[f32][1])
    err32 = max_rel(moved[f32][1], moved[f64][1])
    err_bound = max(TOL_IK, F64_FACTOR * err32)
    print(f"ik: {IK_HOLD_STEPS} iterations over {n_fr} frames ({len(sites)} "
          f"sites, {len(adr)} joints) card vs cpu: qpos change rel_norm "
          f"{rel:.3e} (cpu f32 vs f64 {rel32:.3e}; tol {ik_bound:.3g}), "
          f"site error {err_rel:.3e} (tol {err_bound:.3g})", flush=True)
    if not rel <= ik_bound or not err_rel <= err_bound:
        fail("ik: the card's iterates differ from the CPU's")
    expect("ik", 0)
    e0 = float(ik(mrat, 0).site_error)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ik(mrat, IK_STEPS)
    torch.cuda.synchronize()
    ik_ms = 1e3 * (time.perf_counter() - t0) / IK_STEPS
    e20, e200 = float(moved["card"][1]), float(res.site_error)
    print(f"ik: site error {e0:.4e} at the start, {e20:.4e} after "
          f"{IK_HOLD_STEPS} iterations, {e200:.4e} after {IK_STEPS}; "
          f"{ik_ms:.2f} ms per iteration at {n_fr} frames | {smi}",
          flush=True)
    if not e200 < e20 < e0:
        fail("ik: the site error did not fall")
    del res, moved, target, q_start, q_clip
    track_s["ik"] = time.perf_counter() - t

    # (f) DMPOTrainer with configs/train_config_rodent_imitation.yaml's
    # intention networks at its 168 envs, one iteration of unroll 5
    # training once that rollout is in replay; its checkpoint then the
    # frozen decoder of configs/train_config_gaps_transfer.yaml's trainer
    # (--transfer-ckpt), one iteration
    t = time.perf_counter()

    def track_cfg(argv):
        args_x = train_dmpo.parse_args(argv)
        return args_x, dataclasses.replace(
            train_dmpo.trainer_config(args_x), unroll_length=TRACK_UNROLL,
            min_replay_size=args_x.num_envs * TRACK_UNROLL,
            replay_capacity=TRACK_REPLAY)

    args_i, cfg_i = track_cfg(["--config", os.path.join(
        ROOT, "configs", "train_config_rodent_imitation.yaml")])
    launched_ti, tr_i, loop_i = train_phase(
        env_rat, cfg_i, 1, zero_counts, counts, smi, label="tracking_train",
        min_copies=0)[:3]
    hold_final("tracking_train", mrat, loop_i.env_states.data, 96)
    update_check(tr_i.learner, cfg_i.dmpo, tag="tracking update")
    rows["solve_rows"]["launches_tracking_train"] = \
        launched_ti["solve_rows"]
    donor_dir = tempfile.mkdtemp(prefix="chip_smoke_tracking_donor_")
    donor_path = ckpt.save(donor_dir, {"train": loop_i.train})
    del tr_i, loop_i
    args_g, cfg_g = track_cfg(["--config", os.path.join(
        ROOT, "configs", "train_config_gaps_transfer.yaml"),
        "--transfer-ckpt", donor_path])
    tr_g = train_dmpo.build_trainer(args_g, cfg_g)
    loop_g = tr_g.init(args_g.seed)
    donor = ckpt.restore_policy_params(args_g.transfer_ckpt)
    shutil.rmtree(donor_dir)
    tr_g.restore_decoder(loop_g.train, donor)
    dec_keys = [k for k in donor if k.startswith("decoder.")]

    def decoder_is_donor(when):
        for net in ("policy", "target_policy"):
            sd = getattr(loop_g.train, net).state_dict()
            same = all(torch.equal(sd[k].cpu(), donor[k]) for k in dec_keys)
            print(f"tracking transfer: {net} decoder ({len(dec_keys)} "
                  f"tensors) bit-identical to the donor's {when}: {same}",
                  flush=True)
            if not same:
                fail(f"tracking transfer: the {net} decoder differs from "
                     f"the donor's {when}")

    decoder_is_donor("before training")
    enc0 = param_vector(loop_g.train.policy.encoder)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    loop_g, metrics_g = tr_g.train_iteration(loop_g)
    torch.cuda.synchronize()
    iter_g = time.perf_counter() - t0
    rows["solve_rows"]["launches_tracking_transfer"] = expect(
        "tracking transfer", TRACK_UNROLL * tr_g.env.n_substeps)
    decoder_is_donor("after one iteration")
    moved_g = rel_norm(param_vector(loop_g.train.policy.encoder), enc0)
    width = loop_g.train.policy.decoder.mlp.linears[0].in_features
    print(f"tracking transfer: {type(tr_g.env.task).__name__} at "
          f"{cfg_g.num_envs} envs, decoder in {width} floats; learner_steps "
          f"{loop_g.train.steps} (expected {tr_g.updates_per_iter}); the "
          f"encoder moved by {moved_g:.3e}; the iteration {iter_g:.1f} s | "
          f"{smi}", flush=True)
    if loop_g.train.steps != tr_g.updates_per_iter or not moved_g > 0:
        fail("tracking transfer: the encoder did not train")
    del tr_g, loop_g, metrics_g, donor
    track_s["train"] = time.perf_counter() - t

    # (g) clip playback through its entry point into the temp directory,
    # and the rasterizer's host ms per frame of that playback
    t = time.perf_counter()
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_stac_")
    zero_counts()
    if render_stac.main(["--num-clips", "1", "--n-steps", str(STAC_FRAMES),
                         "--out-dir", out_dir]) != 0:
        fail("render_stac: exit code")
    written = sorted(os.listdir(out_dir))
    if written == ["clip_0.mp4.npz"]:
        frames = np.load(os.path.join(out_dir, written[0]))["frames"]
        shown = (frames.shape == (STAC_FRAMES, 240, 320, 3)
                 and frames.dtype == np.uint8 and frames.std() > 1.0)
    else:
        shown = written == ["clip_0.mp4"]
    t0 = time.perf_counter()
    render_stac.playback_frames(env_rat, clips.fields["qpos"][0],
                                STAC_FRAMES, 320, 240)
    ms_stac = 1e3 * (time.perf_counter() - t0) / STAC_FRAMES
    expect("render_stac", 0)
    print(f"render_stac: wrote {written} ({STAC_FRAMES} frames, shown "
          f"{shown}); playback {ms_stac:.1f} host ms per 320x240 frame "
          f"(the kinematics and the copy to the host included) | {smi}",
          flush=True)
    shutil.rmtree(out_dir)
    if not shown:
        fail("render_stac: the playback frames")
    track_s["render_stac"] = time.perf_counter() - t
    del env_track, env_rat, cpu_rat, env_h
    print(f"tracking: wall s "
          f"{json.dumps({k: round(v, 1) for k, v in track_s.items()})}, "
          f"phase {time.perf_counter() - t14:.1f} s | {smi}", flush=True)

    mark(14)
    # ---- 15. rodent vision -----------------------------------------------
    from flybody_tpu_torch.tasks.rodent_tasks import CAMERA_MAX_DIST
    t15 = time.perf_counter()
    # (a) rodent_escape_bowl with the egocentric camera at B envs: the
    # rat's 20 substeps, and a render for the step's obs and one for the
    # auto-reset's fresh batch every control step
    env_c = rodent_envs.rodent_escape_bowl(use_vision=True)
    mc, task_c = env_c.model, env_c.task
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state_c, launched_c, step_c = env_phase("rodent_vision", env_c,
                                            RODENT_VISION_STEPS)
    peak_c = torch.cuda.max_memory_allocated()
    dc = state_c.data
    cam = state_c.obs["egocentric_camera"]
    print(f"rodent_vision: egocentric_camera {tuple(cam.shape)}, min "
          f"{cam.min().item():.2f}, max {cam.max().item():.2f}", flush=True)
    if tuple(cam.shape) != (B, 32, 32) or not bool(
            ((cam >= 0) & (cam <= 255)).all()):
        fail("rodent_vision: a camera pixel outside [0, 255] or a wrong "
             "shape")
    hits_c = task_c.render_camera(dc, distance=True)
    cam_pos, cam_mat = task_c.camera_pose(dc)
    t_ter = raycast.render_eye(cam_pos, cam_mat, task_c.cam_rays,
                               task_c.height_fn, max_dist=CAMERA_MAX_DIST,
                               distance=True)
    hit_c = hits_c < CAMERA_MAX_DIST
    ter_c = (hit_c & (t_ter <= hits_c)).float().mean().item()
    seen_c = hit_c.float().mean().item()
    print(f"rodent_vision: pixels that hit something {100 * seen_c:.2f} %, "
          f"the terrain first {100 * ter_c:.2f} % (of {hit_c.numel()})",
          flush=True)
    if not ter_c > 0:
        fail("rodent_vision: no camera pixel sees the bowl's terrain")
    del hits_c, t_ter, hit_c, cam_pos, cam_mat
    render_ms_c = cuda_ms(lambda: task_c.render_camera(dc), 5)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        task_c.render_camera(dc)
        torch.cuda.synchronize()
    render_peak_c = torch.cuda.max_memory_allocated() - base
    rrows = device_rows(prof)
    dev_ms_c = sum(a.self_device_time_total for a in rrows) / 1e3
    n_render = sum(a.count for a in rrows)
    print(f"rodent_vision: camera render (B={B}, 32x32, chunks of "
          f"{raycast.RENDER_CHUNK} envs) {render_ms_c:.2f} ms per call "
          f"(CUDA events), device "
          f"{f'{dev_ms_c:.2f} ms' if dev_ms_c else 'not measured'} in "
          f"{n_render} kernels/copies (torch.profiler); 2 calls per "
          f"control step = {2 * render_ms_c:.2f} ms of {1e3 * step_c:.1f} "
          f"ms ({100 * 2e-3 * render_ms_c / step_c:.1f} %); device memory: "
          f"a render's peak {render_peak_c / 1e9:.2f} GB over "
          f"{base / 1e9:.2f} GB held, the phase's peak "
          f"{peak_c / 1e9:.2f} GB | {smi}", flush=True)
    del prof, rrows
    # (b) one substep of 4 envs card vs CPU as in phase 4, and the camera
    # of CAM_ENVS envs of the final state card vs CPU, hit distances
    cpu_c = {dt_: rodent_envs.rodent_escape_bowl(device="cpu", dtype=dt_,
                                                 use_vision=True)
             for dt_ in (f32, f64)}
    substep_check("rodent_vision", mc, "fused", small=first_four(dc),
                  cpu={dt_: e.model for dt_, e in cpu_c.items()})
    small_c = {k: ({kk: vv[..., :CAM_ENVS] for kk, vv in v.items()}
                   if isinstance(v, dict) else v[..., :CAM_ENVS])
               for k, v in bridge.to_numpy(dc).items()}
    t_card = task_c.render_camera(bridge.data_from_numpy(small_c, mc),
                                  distance=True).double().cpu()
    for dt_, e in cpu_c.items():
        t_cpu = e.task.render_camera(bridge.data_from_numpy(small_c,
                                                            e.model),
                                     distance=True).double()
        hc, hp = t_card < CAMERA_MAX_DIST, t_cpu < CAMERA_MAX_DIST
        both = hc & hp
        gap = (t_card - t_cpu).abs()
        flips = (hc != hp).float().mean().item()
        moved = (both & (gap > CAM_TOL_DIST)).float().mean().item()
        near = gap[both & (gap <= CAM_TOL_DIST)]
        print(f"rodent_vision: camera card f32 vs cpu {str(dt_)[6:]} over "
              f"{CAM_ENVS} envs: hit in {100 * hc.float().mean().item():.2f}"
              f" % / {100 * hp.float().mean().item():.2f} % of pixels; "
              f"hit/miss differs in {100 * flips:.4f} %, a hit moved over "
              f"{CAM_TOL_DIST:g} in {100 * moved:.4f} % (bound "
              f"{100 * CAM_SHARE:g} % each); the rest within "
              f"{near.max().item() if near.numel() else 0.0:.3e}", flush=True)
        if dt_ == f32 and not (flips <= CAM_SHARE and moved <= CAM_SHARE):
            fail("rodent_vision: the card's camera differs from the CPU's")
    del cpu_c, t_card, t_cpu
    # (c) solve_rows on the final state (R 96 over 73 dofs)
    hold_final("rodent_vision", mc, dc, 96)
    rows["solve_rows"]["launches_rodent_vision"] = launched_c["solve_rows"]
    keys_c, slices_c = obs_layout(state_c.obs)
    pool_c = batch_concat(state_c.obs, keys=keys_c,
                          num_batch_dims=1).double().cpu().numpy()
    del state_c, dc, cam
    # (d) DMPOTrainer with the vision networks at
    # configs/train_config_bowl.yaml's widths, batch and envs
    vcfg_c = TrainerConfig(
        num_envs=BOWL_ENVS, unroll_length=TRACK_UNROLL,
        replay_capacity=RODENT_VISION_REPLAY,
        min_replay_size=BOWL_ENVS * TRACK_UNROLL, samples_per_insert=32.0,
        network="vision", policy_layers=(512, 512, 512),
        critic_layers=(512, 512, 512),
        dmpo=DMPOConfig(batch_size=2048, n_step=5, num_samples=20))
    launched_vt, tr_vt, loop_vt = train_phase(
        env_c, vcfg_c, 1, zero_counts, counts, smi,
        label="rodent_vision_train", min_copies=0)[:3]
    if type(tr_vt.policy.vis).__name__ != "VisNetRodent":
        fail("rodent_vision_train: the policy's front-end is not "
             "VisNetRodent")
    hold_final("vision_train", mc, loop_vt.env_states.data, 96)
    rows["solve_rows"]["launches_vision_train"] = launched_vt["solve_rows"]
    print(f"rodent_vision update: VisionPolicy and VisionCritic on "
          f"{tr_vt.obs_size} obs floats (one camera of "
          f"{slices_c['egocentric_camera'][2]}), batch {VISION_BATCH}",
          flush=True)
    update_check(tr_vt.learner, dataclasses.replace(
        vcfg_c.dmpo, batch_size=VISION_BATCH), obs_pool=pool_c,
        tag="rodent vision update")
    del tr_vt, loop_vt, pool_c, env_c
    print(f"rodent_vision: phase {time.perf_counter() - t15:.1f} s | {smi}",
          flush=True)

    mark(15)
    # ---- 16. multi-GPU ---------------------------------------------------
    from flybody_tpu_torch.agents.dmpo import Transition
    from flybody_tpu_torch.agents.networks import make_policy_critic
    from flybody_tpu_torch.parallel import dryrun
    t16 = time.perf_counter()
    want_dry = dryrun.UNROLL * env.n_substeps

    def ranks_gloo():
        """(b) two gloo ranks sharing the card: the dry run's iteration,
        then one learner update on the halves of a fixed batch (and of
        its action normals) in float32 and float64, held against the same
        update on the whole batch in this process as update_check holds
        the card against the CPU."""
        obs_w, act_w = trainer_t.obs_size, env.action_size
        scfg = DMPOConfig(batch_size=256, n_step=5, num_samples=20)
        rng16 = np.random.RandomState(16)
        batch_np = dict(obs=rng16.normal(size=(256, obs_w)),
                        action=rng16.uniform(-1, 1, (256, act_w)),
                        reward=rng16.uniform(0, 1, 256),
                        discount=np.full(256, 0.99 ** 5),
                        next_obs=rng16.normal(size=(256, obs_w)))
        eps_np = rng16.normal(size=(20, 256, act_w))
        jobs, ref = [("iteration_worker", ())], {}
        nets = ("policy", "critic", "target_policy", "target_critic",
                "dual_params")
        for dt_ in (f32, f64):
            pol, crit = make_policy_critic(
                act_w, obs_w, generator=torch.Generator().manual_seed(0))
            lrn = DMPOLearner(pol.to(dt_), crit.to(dt_), act_w, obs_w, scfg)
            sd = lrn.init(torch.Generator().manual_seed(1)).state_dict()
            tb = Transition(**{k: torch.as_tensor(v, dtype=dt_)
                               for k, v in batch_np.items()})
            te = torch.as_tensor(eps_np, dtype=dt_)
            jobs.append(("split_update_worker", (lrn, sd, [tb], [te])))
            # the whole batch in one process on the card
            one = DMPOLearner(copy.deepcopy(pol).to(dev),
                              copy.deepcopy(crit).to(dev), act_w, obs_w,
                              scfg)
            st1 = one.init(torch.Generator().manual_seed(1))
            for k in nets:
                getattr(st1, k).load_state_dict(sd[k])
            first = param_vector(st1.policy, st1.critic, st1.dual_params)
            stats1 = one.update(st1, Transition(**{
                k: v.to(dev) for k, v in vars(tb).items()}), eps=te.to(dev))
            after = param_vector(st1.policy, st1.critic, st1.dual_params)
            ref[dt_] = {k: stats1[k].double().cpu()
                        for k in ("critic_loss", "policy_loss_total")}
            ref[dt_].update({"params": after, "params - init": after - first})
        torch.cuda.synchronize()
        ranks = dryrun.spawn("run_jobs", 2, (jobs,), device="cuda",
                             backend="gloo", timeout=RANKS_TIMEOUT)
        for r, (row, _, _) in enumerate(ranks):
            print(f"ranks gloo: rank {r}: {row['procs']} ranks, "
                  f"{row['envs']} envs, {row['s_per_iter']:.3f} s per "
                  f"iteration (two ranks share one card: not a scaling "
                  f"figure), solve_rows launches "
                  f"{row['solve_rows_launches']} (expected {want_dry}), "
                  f"learner_steps {row['learner_steps']}, params "
                  f"{row['params']}", flush=True)
            if row["solve_rows_launches"] != want_dry or \
                    row["learner_steps"] != 3:
                fail(f"ranks gloo: rank {r}'s dry run launches or updates")
            if not all(math.isfinite(v) for v in row["metrics"].values()):
                fail(f"ranks gloo: rank {r}'s metrics not finite")
        for i, what in ((0, "the dry run's"), (1, "the f32 split update's"),
                        (2, "the f64 split update's")):
            h = [r[i]["params"] for r in ranks]
            print(f"ranks gloo: {what} params on the two ranks {h}",
                  flush=True)
            if h[0] != h[1]:
                fail(f"ranks gloo: {what} params differ between the ranks")
        got = {}
        for i, dt_ in ((1, f32), (2, f64)):
            out = ranks[0][i]
            after = torch.cat([v.double().reshape(-1) for k in (
                "policy", "critic", "dual_params")
                for v in out["nets"][k].values()])
            got[dt_] = {k: out["stats"][0][k].double()
                        for k in ("critic_loss", "policy_loss_total")}
            got[dt_].update({"params": after, "params - init": after - (
                ref[dt_]["params"] - ref[dt_]["params - init"])})
        for name in ref[f32]:
            dist = rel_norm if ref[f32][name].numel() > 1 else (
                lambda a, b: abs(float(a) - float(b))
                / max(abs(float(b)), 1e-30))
            d32 = dist(got[f32][name], ref[f32][name])
            d64 = dist(got[f64][name], ref[f64][name])
            one_d = dist(ref[f32][name], ref[f64][name])
            two_d = dist(got[f32][name], got[f64][name])
            tol = TOL_DELTA if name == "params - init" else TOL_UPDATE
            bound = max(tol, F64_FACTOR * one_d)
            print(f"ranks split: {name:18s} two ranks vs one process f32 "
                  f"{d32:.3e} (tol {bound:.3g}), f64 {d64:.3e} (tol "
                  f"{TOL_F64:g}); f32 vs f64: one {one_d:.3e}, two "
                  f"{two_d:.3e}", flush=True)
            if not d64 <= TOL_F64:
                fail(f"ranks split {name} in float64: {d64:.3e}")
            if not two_d <= CARD_F32_RATIO * max(one_d, F32_FLOOR):
                fail(f"ranks split {name}: the two ranks' f32 vs f64 "
                     f"{two_d:.3e} > {CARD_F32_RATIO:g} x one process's")
            if not d32 <= bound:
                fail(f"ranks split {name}: {d32:.3e} > {bound:.3g}")
        rows["solve_rows"]["launches_ranks"] = sum(
            r[0]["solve_rows_launches"] for r in ranks)

    # (a) the dry run as one rank of torchrun's group over NCCL: a group
    # of one through the same code (NCCL puts no two ranks on one card);
    # it runs while (b) does, and is read after it
    env16 = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
                 + os.environ.get("PYTHONPATH", ""))
    nccl_proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "1", "-m", "flybody_tpu_torch.parallel.dryrun",
         "--device", "cuda", "--backend", "nccl"], cwd=ROOT, env=env16,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks_gloo()
        out, err = nccl_proc.communicate(timeout=RANKS_TIMEOUT)
    finally:
        if nccl_proc.poll() is None:
            nccl_proc.kill()
            nccl_proc.wait()
    nccl = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    print(f"ranks nccl: exit {nccl_proc.returncode}, rows {nccl}",
          flush=True)
    if nccl_proc.returncode != 0 or len(nccl) != 1 or (
            nccl[0]["procs"] != 1
            or nccl[0]["solve_rows_launches"] != want_dry
            or nccl[0]["learner_steps"] != 3):
        fail(f"ranks nccl: the dry run under torchrun: {err[-3000:]}")
    print(f"ranks: phase {time.perf_counter() - t16:.1f} s | {smi}",
          flush=True)

    mark(16)
    # ---- 17. result ------------------------------------------------------
    shapes = {"": (m.nv, R, m.tree), "_imitation": (mi.nv, R_i, mi.tree),
              "_flight": (mf.nv, R_f, mf.tree)}
    occupancy = [(name, at, SK.kernel_info(name, nv_, R_, tr.nM,
                                           SK.pack_tables(tr)))
                 for name in ("solve_rows", "upsolve_build_yd",
                              "apgd_iterate")
                 for at, (nv_, R_, tr) in shapes.items()]
    occupancy += [("solve_rows", "_vision", SK.kernel_info(
        "solve_rows", mv.nv, R_v, mv.tree.nM, SK.pack_tables(mv.tree))),
                  ("solve_rows", "_rodent", SK.kernel_info(
        "solve_rows", mr.nv, 96, mr.tree.nM, SK.pack_tables(mr.tree))),
                  ("solve_rows", "_humanoid", SK.kernel_info(
        "solve_rows", mh.nv, 96, mh.tree.nM, SK.pack_tables(mh.tree))),
                  ("upsolve_yd", "", SK.kernel_info(
        "upsolve_yd", m.nv, R, m.tree.nM, SK.pack_tables(m.tree))),
                  ("admm_iterate", "", AK.kernel_info(n_rows))]
    occupancy += [("ccd_narrowphase", f"_{int(a1)}{int(a2)}",
                   CK.kernel_info(a1, a2))
                  for a1 in (False, True) for a2 in (False, True)]
    occupancy += [("kinematics", "", KK.kernel_info(f32)),
                  ("kinematics", "_f64", KK.kernel_info(f64))]
    for name, at, info in occupancy:
        cpl = (f" ({info['cpl']} columns per lane)" if "cpl" in info
               else "")
        clusters = (f", {info['clusters']} clusters of "
                    f"{SK.APGD_CLUSTER} active" if info.get("clusters")
                    else "")
        print(f"occupancy: {name}{' at ' + at[1:] if at else ''}{cpl}: "
              f"{info['regs']} registers per thread, {info['local_bytes']} B "
              f"local (spill) per thread, shared memory "
              f"{info['static_smem']} B static + {info['dynamic_smem']} B "
              f"dynamic per block, {info['blocks_per_sm']} blocks and "
              f"{info['warps_per_sm']} warps per SM{clusters}", flush=True)
        rows[name][f"occupancy{at}"] = {
            "regs": info["regs"], "spill_bytes": info["local_bytes"],
            "smem_bytes": info["static_smem"] + info["dynamic_smem"],
            "blocks_per_sm": info["blocks_per_sm"],
            "warps_per_sm": info["warps_per_sm"],
            **({"clusters": info["clusters"]} if info.get("clusters")
               else {})}
    # beside each max_abs_err*: the envs its hold replayed at restart ties
    for label, rep in tie_replays.items():
        key = "" if label == "fly" else "_" + label.replace(" ", "_")
        rows["solve_rows"][f"replayed{key}"] = rep
    order = ("solve_rows", "apgd_iterate", "upsolve_build_yd", "upsolve_yd",
             "admm_iterate", "ccd_narrowphase", "kinematics")
    print(f"wall s per phase {json.dumps(phase_s)}, in all "
          f"{sum(phase_s.values()):.1f} s", flush=True)
    print(json.dumps({"kernels": [rows[k] for k in order]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
