#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU, and check it.

  python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card's name and power limit (nvidia-smi);
  2. build the hand-written kernel (csrc/fused_preprocess.cu) with nvcc;
  3. hold the kernel against its plain PyTorch version on the card at
     640x480 and 641x479 (bilateral radius 3, the unrolled instantiation)
     and at 320x240 with sigma_xy = 1.0 (radius 2, the generic
     instantiation); inputs with 2% holes, 1% beyond max_depth, random
     cfactor, a = 0.01; tolerances depth 1e-5, normals 1e-4, radius 1e-6
     (absolute). At 640x480 time both, in turns (plain, kernel, kernel,
     plain; each turn the median of 50, CUDA events; the time reported is
     the mean of the two turns): the kernel's device time per
     launch (launches replayed back to back from a CUDA graph, so the host
     is out of the number) and the time of one call of its wrapper from
     the host (outputs allocated, one launch); and work out the kernel's
     bound from these inputs: bytes over the memory rate against float32
     operations over the float32 peak, the larger of the two;
  4. write a 640x480 TUM dataset of the heightmap world along the
     constant-twist trajectory, 51 frames (6 keyframes at the default
     keyframe interval of 10);
  5. run the odometry-only CLI (``badslam_tpu_torch.main``) on it with the
     kernel's launch count reset just before, and check: rc 0, one launch
     per frame, finite poses, ATE RMSE <= 2.77 mm;
  6. print warm frames/s, per-phase ms and peak device memory;
  7. run the CLI with sequential BA on (the reference's defaults: keyframe
     every 10 frames, 10 BA iterations per keyframe, sparsification 4,
     min_observation_count 1/2/3), the launch counts reset just before, the
     host mirrors verified after every BA call, and check: rc 0, one launch
     per frame, finite poses, ATE RMSE <= 2.77 mm, 6 keyframes, live
     surfels > 0, every BA call ran >= 1 iteration, the exported PLY has as
     many points as live surfels, all finite, and their median |error|
     against the heightmap is < 1e-3 m, and one launch of each pose_h_b
     kernel (csrc/pose_h_b.cu, built on its first use) per shared pose GN
     step ("BA pose GN steps"); print frames/s, per-phase ms, BA
     iterations per call, the pose steps and lanes a launch, store sizes
     and peak device memory;
  8. run bundle adjustment twice from one map state and check that poses
     and surfel stores are bitwise equal; once with the alternating scheme
     and once with ``use_pcg`` and both intrinsics flags on (the calibration
     is then compared too);
  9. self-calibration recovery: the multi-view plane map (8 keyframes see 8
     planes from scattered poses, sparsification 4) with the depth camera
     off by (0.4, -0.3, 0.25, -0.2) px, 60 alternated intrinsics steps;
     check: largest intrinsics error < 0.05 px, |a| < 0.05, max |cfactor| <
     0.05; print the error and the ms per step;
 10. joint recovery: the same map and perturbation through one
     ``bundle_adjustment`` call with ``use_pcg`` and both intrinsics flags
     (two outer iterations); check: the depth intrinsics end nearer the true
     camera than they started and every pose, surfel and calibration value
     is finite; then one more solve and its ``debug_verify_result``: print
     the residual of the normal equations and its scale;
 11. run the CLI with ``--optimize_intrinsics --keyframe_interval 5
     --final_ba_iterations 1`` (11 keyframes, so self-calibration runs from
     the tenth keyframe on and in the final BA), exporting poses, map,
     calibration and state, and check: rc 0, one launch per frame, ATE and
     map gates as in 7, 11 keyframes, the "BA intrinsics optimization" span
     ran, the exported depth intrinsics lie within 0.1 px of the dataset's
     camera; then hold the kernel against its plain version once more, on
     one frame of this run with the calibration object the run ended with;
 12. the same with ``--use_pcg``: the "BA PCG" span ran and the alternated
     intrinsics span did not; print ms per outer iteration and the inner
     iterations per solve;
 13. round trip: a CLI run that loads the state of 11 and processes no
     frame exports the same poses, the same calibration and the same surfel
     count, with one kernel launch per restored keyframe and one for the
     odometry's base keyframe; a run that imports the exported calibration
     exports the same three files;
 14. loop detection on the CLI: the run of 7 without --no_loop_detection,
     so the detector's thread runs (6 keyframes cannot reach its
     recent-exclusion window of 10, so no candidate may come up); check: no
     loop event, and the trajectory equals 7's bit for bit; print the
     detector's ms per keyframe, from extraction to result;
 15. config2 of benchmarks/run_configs.py at 640x480 through the port's
     BadSlam: 11 frames of the checker-textured plane world, a keyframe
     every 2 frames, BA on, 0.06 m and 0.08 m of drift put into keyframes 3
     and 4, frame 10 revisits frame 0; check: the closure is applied and
     matched to keyframe 0, and the revisit lies within a quarter of the
     drift of the truth (config2's gate); print the inliers, the ms of the
     add_keyframe call that closes the loop and the ms of the pose-graph
     solve alone (the closure's graph solved again from outside);
 16. the BoW-scale blackout (the reference's
     test_loop_closure_applied_at_bow_scale) at 640x480: 73 frames, BA off,
     a keyframe every 2 frames, a tracking blackout over frames 40-55;
     check: the vocabulary is active, a closure is applied, the blackout
     left weak odometry edges, the last revisit lies within 0.02 m of the
     truth; print the detector's ms per keyframe and the ms per closing
     call;
 17. the reference CLI's bare defaults (BA on its thread, on a
     low-priority CUDA stream, the frame's work on a high-priority one;
     loop detection on its thread) against the same command line with
     --sequential_ba, one run each (sequential, then defaults), each with
     the gates of 7 (ATE, map, keyframes, PLY), and for the defaults: ATE
     RMSE <= 1.18 mm (the formula's 640x480 value), the BA iterations ran
     on the thread and no BA call on the main thread, the streams'
     priorities, both threads stopped, the loops line "Loops closed: 0,
     ignored: 0"; print warm frames/s and the CLI's wall time (the BA
     thread's drain at the end included) of both;
 18. the defaults with --optimize_intrinsics --keyframe_interval 5: the
     gates of 17 and 11's intrinsics gate (exported depth intrinsics within
     0.1 px of the dataset's camera, and moved); the BA thread published
     its calibration at least once; print how many snapshots the
     front-end took at a frame's start (it depends on the threads'
     timing); then the hand-off in a fixed order, off the CLI: 11 frames
     quiesced after each, one BA-thread iteration with self-calibration,
     one more frame, whose preprocessing and odometry must read the
     published snapshot, equal to the BA thread's calibration, and whose
     kernel outputs must equal the plain version's with it (error 0.0);
 19. the defaults with --pyramid_level_for_depth 1
     --pyramid_level_for_color 1, 21 frames: ATE <= 2.77 mm, map median <
     1e-3 m, the map at 320x240, and the kernel held against its plain
     version on a 320x240 frame of the run with its calibration;
 20. the same with --median_filter_and_densify_iterations 1;
 21. the same with --sequential_ba --export_reconstruction (cell 1): the
     dense cloud holds more than twice the surfels, finite, median |error|
     < 1e-3 m, and the back-end has its own calibration object back;
 22. the odometry-only run of 5 over its first 21 frames without and then
     with the frame prefetcher: print "Preprocessing" warm mean ms and warm
     frames/s of each;
 23. check that no module of JAX or of the JAX package was imported;
 24. the pipelined front-end on the CLI: phase 7's command line with
     --pipelined_frontend in place of --sequential_ba, without
     device-accurate timings or the BA iteration stream, one run each of
     the --sequential_ba line, of it and of 26's (sequential, pipelined,
     concurrent), each with the gates
     of 7 (ATE against 2.77 mm, printed beside the formula's 1.18 mm, map
     median, 6 keyframes, PLY) and one launch per frame; print warm
     frames/s, the CLI's wall time and peak device memory of each;
 25. the first 21 of those frames in process through BadSlam, built as
     the CLI builds it (page-locked prefetcher), under
     torch.cuda.set_sync_debug_mode("error") from the first process_frame
     to the last; then finalize_pipelined and the ATE and map gates; the
     kernel held against its plain version on a frame of the run (error
     0.0); and torch.profiler over three warm frames (a keyframe and two
     more) of the host front-end and of each pipelined one: launches and
     synchronizing calls inside the frames' span, GN iterations and
     device-busy share per frame, the share also derived without the
     profiler's slowdown (profiled busy ms over the same mode's warm CLI
     ms), and the kernel's launches over the run (one per frame);
 26. --pipelined_frontend --pipelined_concurrent_ba: on the CLI in 24's
     turns, and in process as 25, the guard covering both threads; print
     the streams' priorities, the BA iterations run and dropped, and
     whether both threads stopped;
 27. the device loop closure: tests/test_pipelined.py's drifted map at
     640x480 (config2's scene with the pipelined front-end), the revisit
     frame under the sync guard; check: the event reads device-pending
     before finalize_pipelined and is applied after it, matched to
     keyframe 0, and the revisit lies within 0.04 m of the truth (the
     drift was 0.08 m); print the closing frame's ms and the closure
     program's launches under torch.profiler;
 28. self-calibration under the pipelined front-end with
     --optimize_intrinsics (the step acts from the tenth keyframe), in
     process under the sync guard: the joint PCG solve inline on 12 frames
     of 14's dataset with a keyframe every frame, and the alternated step
     on the BA thread on 25 frames with a keyframe every second one;
     check: no synchronizing call, the ATE gate, the step ran and moved
     the cameras, the front-end took a calibration the thread published,
     one launch per frame;
 29. the bare defaults over the first 21 frames with --render_preview and
     --profile_dir: the gates of 19 (rc 0, one launch per frame, ATE <=
     2.77 mm, map median < 1e-3 m); one color and one depth PNG per
     keyframe at 640x480, the depth PNG's hit pixels within a median 1e-3
     m of the heightmap seen from the keyframe's exported pose; a trace
     that parses and holds the preprocess kernel once per frame; print
     the trace's bytes and write time, and the render's ms per viewpoint
     (CUDA events) and launches;
 30. the card's render of 29's map against the port's CPU render of it
     from every keyframe: hit masks differ in at most 0.1% of the pixels,
     depth where both hit by at most 1e-2 m (print both counts); then a
     seeded cloud of 2M surfels at 640x480 (31 chunks): ms per viewpoint,
     launches and peak device memory;
 31. the snapshot inspector on 11's saved state with --render,
     --export_point_cloud and --export_poses: the PLY has 11's surfel
     count, the trajectory equals 11's exported poses, one preview pair
     per keyframe;
 32. the four sharded steps of parallel/sharded_ba.py on virtual meshes
     over the card (every position on cuda:0): the BA iteration on 8
     shards, the 2-D iteration on 2 x 4 (kf x surfels), the PCG step on 8
     shards without and with the intrinsics unknowns, on phase 9's map at
     640x480 (every keyframe and surfel active; 10 pose GN iterations,
     15 CG iterations), each held against the one-device step on the same
     state: positions 1e-5 and poses 1e-4 (the iteration), 1e-4 and 2e-4
     (2-D), 2e-3 and 2e-4 (PCG; intrinsics 1e-3 px); print ms and kernel
     launches (torch.profiler) per step on the mesh and on one device, and
     the collectives per step;
 33. phase 7's command line in process over a 4-shard virtual mesh over
     the card (the CLI offers no virtual mesh): the gates of 7 (ATE <=
     2.77 mm, map median < 1e-3 m, one launch per frame, keyframes, PLY),
     the trajectory within 1e-4 m of phase 7's and the live surfels within
     1% + 16 of them; then two BA runs over the mesh from phase 8's state,
     bitwise equal; print warm frames/s, ms per BA iteration, the bytes
     the gathers of the store moved, the collectives and peak device
     memory beside phase 7's;
 34. 21 frames each on the 4-shard mesh: the bare defaults (BA and
     detection threads; 17's thread checks and 19's gates), the pipelined
     front-end in process under the sync guard (ATE and map gates), and
     a state saved on the mesh after 14 frames resumed on one device
     against a state saved on one device resumed on the mesh (ATE and map
     gates; the two trajectories within 1e-4 m, surfels within 1% + 16);
 35. --mesh_devices 2 on phase 7's command line: with one card visible it
     exits non-zero with a message naming the visible count; with two it
     is held to phase 7's gates and trajectory;
 36. the cold start: phase 7's command line in a fresh process per run
     (no library handle and no kernel module loaded; build/ holds the
     kernel's library from phase 2), without and with --prewarm
     --prewarm_keyframes 6, in turns (without, with, with, without);
     check: rc 0, phase 7's ATE and map gates, one launch per live frame
     (counted from where prewarm returns) and one per warm frame, the four
     trajectories equal to the last bit, and with --prewarm the kernel's
     library loaded inside the prewarm (its logged breakdown); print per
     run frame 0's and frame 1's ms, the first BA call's ms, the largest
     frame's, warm frames/s, the prewarm's seconds and breakdown, the
     seconds from the child's start to frame 0, launches live and warm,
     and peak device memory of the live frames and of the prewarm, and
     phase 2's nvcc seconds; then 21 frames of the pipelined front-end in
     process, prewarm(max_ba_keyframes=3) outside
     torch.cuda.set_sync_debug_mode("error") and every frame inside it,
     with the ATE gate;
 37. the pose_h_b kernels on phase 7's map and keyframes (640x480, every
     keyframe a lane, all but the first moved by a seeded 2 mm / 1 mrad)
     against their plain versions in models/pose_opt.py, for both residual
     kinds and each alone: the accumulate kernel over every lane gives
     each lane's residual count of accumulate_pose_h_b, and over one lane's
     surfels off their tap cells' edges H and b within 5e-5 of the
     magnitude of their summands (tests/test_torch_ba_models.py's
     tolerance); the step kernel on the plain H and b gives
     step_lanes_plain's poses within 1e-6 and the same lane states; the
     whole shared pose GN on the card gives each lane's
     estimate_frame_pose within 1e-5, the same ``moved``, and one launch
     of each kernel per step; then, in turns (plain, kernel, kernel,
     plain), each kernel's device time per launch (from a CUDA graph), one
     wrapper call and its plain version, and each kernel's bound (bytes
     over the memory rate against float32 operations over the peak, the
     pairs counted from the data).
Every phase prints its wall seconds, and the script the total before the
kernels' line. Phases 37 and 36 run right after 7. Phases 29-31, then 17-22,
24-26, 28 and 32-35 run after 14, on its dataset, and before 15; 27 runs
last, before 23. Phase 29 comes before every other
torch.profiler session of the process: once one has run, the next
session can lose its first kernel record (torch 2.11: phase 29's trace
lacked one of its 21 preprocess launches when it ran after 25-27), which a
CLI run, one session per process, never meets.

The next-to-last line is the kernels' JSON summary (fused_depth_preprocess,
then the two pose_h_b kernels with phase 7's launches); the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device and no network.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

FRAMES = 51
KEYFRAME_INTERVAL_BA = 10
# With a keyframe every 5 frames the run reaches 11 keyframes: the schedule
# of --optimize_intrinsics starts with the tenth.
KEYFRAME_INTERVAL_SELF_CALIBRATION = 5
# The item-5 input paths run over the first 21 frames (3 keyframes).
INPUT_PATH_FRAMES = 21
# The self-calibration checks' perturbation of the depth camera (fx, fy, cx,
# cy, in pixels) and their gates: the reference's, for the recovery on the
# multi-view plane map; for a run on a true camera, how far the exported
# depth intrinsics may lie from the dataset's.
CAMERA_PERTURBATION_PX = (0.4, -0.3, 0.25, -0.2)
RECOVERY_GATE = 0.05
# The alternating run: the reference's own run on the 160x120 twin of this
# dataset (tools/self_calibration_twin.py, on a CPU) ends 0.025 px from the
# true camera. The joint run: the reference's ends 0.177 px away there (CG
# runs to its cap on the joint system and its last iterate carries float32
# rounding), so its gate is twice that.
CLI_INTRINSICS_GATE_PX = {"alternating": 0.1, "joint": 0.355}
# ATE bounds. The gate is the reference's record for the odometry-only
# configuration (30 frames at 160x120); its formula, 2 * per-frame
# interpolation bias * frames / sqrt(3) with the bias halving per
# resolution doubling, gives the 640x480 value, which has no record yet.
ATE_GATE_M = 2.77e-3
ATE_FORMULA_640_M = float(2.0 * 8e-5 * (160.0 / 640.0) * FRAMES
                          / np.sqrt(3.0))
# Median |error| of the exported surfels against the analytic heightmap
# (the reference's map-quality gate for this world).
MAP_MEDIAN_GATE_M = 1e-3
BA_PHASES = ("Bundle adjustment", "BA surfel creation",
             "BA surfel activation", "BA geometry optimization",
             "BA initial surfel merge", "BA pose optimization",
             "BA final surfel merge and compact",
             "BA final surfel del. and radius upd.", "BA surfel compaction")
SELF_CALIBRATION_PHASES = ("BA PCG", "BA intrinsics optimization")
CALIBRATION_SUFFIXES = (".depth_intrinsics.txt", ".color_intrinsics.txt",
                        ".deformation.txt")
TOLERANCES = {"filtered": 1e-5, "normals": 1e-4, "radius_sq": 1e-6}
PREPROCESS = dict(sigma_xy=1.5, sigma_inv_depth=0.005, radius_factor=2.0,
                  max_depth=5.0)
# The generic-radius case: int(2.0 * 1.0 + 0.5) = 2.
PREPROCESS_RADIUS_2 = dict(PREPROCESS, sigma_xy=1.0)

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory rate, float32 rate outside the tensor cores (an FMA counts
# as two operations), and the special-function units' 16 results per clock
# on each of 132 SMs at the 1.98 GHz that the float32 peak assumes.
H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12
H100_SFU_PER_S = 132 * 16 * 1.98e9
# float32 operations the function needs, counted from the plain version
# (ops/depth_proc.py): each float add, subtract and multiply whose result
# is used counts one; compares, selects, min/max and index arithmetic count
# nothing. expf, IEEE division, reciprocal and square root count as the
# instruction sequences nvcc emits for them on sm_90a without
# --use_fast_math, read from the kernel's SASS (cuobjdump -sass of the
# built library), an FFMA as two: expf four FFMA, an FADD, a MUFU.EX2 and
# an FMUL; a division a MUFU.RCP and five FFMA; a reciprocal a MUFU.RCP,
# two FFMA and an FADD; a square root a MUFU.RSQ, two FMUL and two FFMA.
OPS_EXP, OPS_DIV, OPS_RCP, OPS_SQRT = 11, 11, 6, 7
# One bilateral tap with a valid center and a valid sample: the difference
# of inverse depths (1), its square (1), times 1/(2 sigma^2) (1), subtracted
# from the spatial term (1), expf, the weight sum (1), weight x sample (1),
# the value sum (1).
OPS_PER_TAP = 7 + OPS_EXP
# Once per valid pixel: its inverse depth, which every tap on it reads.
OPS_PER_VALID_PIXEL = OPS_RCP
# Once per pixel that passes the cutoff (any other comes out zero):
#   the filter's quotient                                        division
#   calibration 1/(1/d + c exp(-a/d)): -a x, c x, +    3, 2 reciprocals, expf
#   five unprojections d(fx' px + cx'), d(fy' py + cy')                5 x 6
#   two pick_difference: two squared distances (3 -, 3 x, 2 +),
#     their ratio, the one difference that is selected (3 -)
#                                                      2 x (19 + division)
#   cross product (6 x, 3 -)                                               9
#   its length (3 x, 2 +)                                    5, square root
#   sign / length, times x and y                                2, division
#   radii: the center's unprojection and, for each of 4 neighbours, an
#     unprojection and a squared distance                    6 + 4 x (6 + 8)
OPS_PER_CENTER_PIXEL = (3 + 30 + 38 + 9 + 5 + 2 + 62
                        + 4 * OPS_DIV + 2 * OPS_RCP + OPS_EXP + OPS_SQRT)
# Special-function results: one per tap and per valid pixel, and per center
# pixel 4 divisions, 2 reciprocals, one expf and one square root.
SFU_PER_CENTER_PIXEL = 8
# float32 operations of pose_h_b_accumulate_kernel (csrc/pose_h_b.cu),
# counted from its source as above, per (surfel, open lane) pair by how far
# the pair gets; each pair is counted only for the code it must have run,
# so the sum is a lower bound:
#   every valid surfel of an open lane: the transform (a rotation of 3
#     products and 6 FMA, then 3 additions)                              18
#   in front of the camera: px, py (a division, a product, a sum each)   26
#   on a pixel with a measured depth: its reciprocal, the calibration
#     (3, expf, reciprocal), the normal's rotation (15), nx, ny (4), the
#     stddev's denominator (7), its division, the threshold (reciprocal,
#     1), the depth difference (1), the view dot product (5)             76
#   associated: the measured normal's z (4, square root), its dot (5)    16
#   the depth term: u (2), r (9), J (15), the Tukey weight (4), J w (6),
#     H's upper triangle (21 FMA), b (6 FMA), the count (1)              91
#   the descriptor terms, where the pixel lies in the color image: the
#     color pixel (4), two tangents (2 crosses, 2 x (5, division, square
#     root, 1), 6 scalings), two points (6) and their transforms (36) and
#     projections (4 x (division, 2)), 3 bilinear samples with gradients
#     (25 each), 2 residuals (3 each), 2 gradient scalings (6 each), 2
#     Jacobians (reciprocal, 25 each), 2 weights (1 each), 2 terms into H
#     and b (60 each), the count (1)                                    448
POSE_OPS_TESTED, POSE_OPS_FRONT = 18, 2 * (2 + OPS_DIV)
POSE_OPS_MEASURED = 36 + OPS_DIV + 3 * OPS_RCP + OPS_EXP
POSE_OPS_ASSOCIATED = 9 + OPS_SQRT
POSE_OPS_DEPTH_TERM = 91
POSE_OPS_DESCRIPTOR_TERMS = (356 + 2 * (OPS_DIV + OPS_SQRT) + 4 * OPS_DIV
                             + 2 * OPS_RCP)
# pose_h_b_step_kernel per open lane, the same way: the Jacobi scaling (6
# reciprocal square roots, 72 products, 6), the 6x6 LU (125, 6
# reciprocals), three triangular solves (60 and 6 divisions each), two
# refinement steps (84 each), the unscaling (6), se3.exp without its sinf
# and cosf (the small-angle branch, 158), the pose product (84) and the
# convergence test (18).
POSE_STEP_OPS_PER_LANE = (6 * (OPS_SQRT + OPS_RCP) + 72 + 6 + 125
                          + 6 * OPS_RCP + 3 * (60 + 6 * OPS_DIV) + 2 * 84
                          + 6 + 158 + 84 + 18)
# Bytes a surfel (position, normal, squared radius, descriptor) and its
# valid flag; per pair a depth and a cfactor value, a normal (2 floats) and
# the 12 intensity taps of the 3 samples.
POSE_SURFEL_BYTES, POSE_VALID_BYTES = 36, 1
# The seeded perturbation of phase 37's keyframe poses (the tests' 2 mm /
# 1 mrad) and its seed.
POSE_PERTURBATION = (2e-3, 1e-3)
POSE_SEED = 37
# Tolerances of phase 37: H and b against the plain version on the surfels
# off their tap cells' edges, as a share of the magnitude of their summands
# (tests/test_torch_ba_models.py's; up to 1.1e-5 measured there); the step
# alone and the whole pose GN against their plain versions (m and unitless
# rotation entries).
POSE_H_B_TOLERANCE = 5e-5
POSE_STEP_TOLERANCE = 1e-6
POSE_LOOP_TOLERANCE = 1e-5

def fail(msg: str) -> None:
  print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
  sys.exit(1)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
  """ATE RMSE after the closed-form SE(3) (Horn/Umeyama) alignment of the
  estimated positions onto the ground truth (the port's ``eval``)."""
  from badslam_tpu_torch import eval as port_eval
  return port_eval.ate_rmse(est, gt)[0]


def cuda_median_ms(fn, runs: int = 50) -> float:
  import torch
  for _ in range(3):
    fn()
  times = []
  for _ in range(runs):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    times.append(start.elapsed_time(end))
  return statistics.median(times)


def device_ms_per_launch(fn, launches: int = 20, runs: int = 50) -> float:
  """Device time of one call of ``fn``: ``launches`` calls captured in a
  CUDA graph and replayed back to back between two events (median of
  ``runs`` replays), so host time between launches is not in it."""
  import torch
  fn()
  torch.cuda.synchronize()
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    for _ in range(launches):
      fn()
  return cuda_median_ms(graph.replay, runs) / launches


def preprocess_bound(raw, *, sigma_xy, radius_factor, max_depth, **_) -> dict:
  """The least time an H100 could take for fused_depth_preprocess on
  ``raw``: the larger of its bytes (the frame read once, four planes
  written once) over the memory rate and its float32 operations over the
  float32 peak. The work is counted from the data: a tap where the center
  passes the cutoff and the sample is valid, a reciprocal per valid pixel,
  the rest of the chain per pixel that passes the cutoff."""
  import torch
  import torch.nn.functional as F
  h, w = raw.shape
  radius = int(radius_factor * sigma_xy + 0.5)
  valid = raw > 0.0
  center = valid & (raw <= max_depth)
  padded = F.pad(valid[None, None], (radius,) * 4)[0, 0]
  taps = 0
  for dy in range(-radius, radius + 1):
    for dx in range(-radius, radius + 1):
      if dx * dx + dy * dy <= radius * radius:
        sample = padded[radius + dy:radius + dy + h,
                        radius + dx:radius + dx + w]
        taps += int((center & sample).sum())
  n_valid, n_center = int(valid.sum()), int(center.sum())
  nbytes = 5 * 4 * h * w
  ops = (taps * OPS_PER_TAP + n_valid * OPS_PER_VALID_PIXEL
         + n_center * OPS_PER_CENTER_PIXEL)
  sfu = taps + n_valid + n_center * SFU_PER_CENTER_PIXEL
  bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
  ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
  return {"bytes": nbytes, "ops": ops, "taps": taps, "valid": n_valid,
          "center": n_center, "bytes_ms": bytes_ms,
          "ops_ms": ops_ms, "sfu_ms": sfu / H100_SFU_PER_S * 1e3,
          "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def kernel_inputs(width: int, height: int, seed: int, device):
  from badslam_tpu_torch.models.calibration import DepthCalibration
  from badslam_tpu_torch.ops.depth_model import cfactor_shape
  from badslam_tpu_torch.utils import synthetic
  cam = synthetic.default_test_camera(width, height)
  depth, _ = synthetic.render_heightmap(cam, np.eye(4, dtype=np.float32))
  rng = np.random.default_rng(seed)
  depth[rng.random(depth.shape) < 0.02] = 0.0
  depth[rng.random(depth.shape) < 0.01] = 9.0  # beyond max_depth
  cell = 4
  cfactor = rng.uniform(-0.01, 0.01, cfactor_shape(height, width, cell))
  calib = DepthCalibration.from_numpy(
      [cam.fx, cam.fy, cam.cx, cam.cy], 0.01, cfactor, 40.0, cell,
      (width, height), device)
  import torch
  return torch.from_numpy(depth).to(device), calib


def compare_kernel(case: str, raw, calib, kwargs) -> float:
  """The kernel against its plain version on one frame; returns the
  largest absolute error over the three outputs."""
  import torch
  from badslam_tpu_torch.ops import fused_preprocess as fp
  height, width = raw.shape
  got = fp.fused_depth_preprocess(raw, calib, **kwargs)
  want = fp.fused_depth_preprocess_reference(raw, calib, **kwargs)
  torch.cuda.synchronize()
  if int((want[0] > 0).sum()) < width * height // 2:
    fail(f"{case}: too few valid pixels to compare")
  worst = 0.0
  for name, g, w in zip(TOLERANCES, got, want):
    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
      fail(f"{case} {name}: bad shape or non-finite values")
    err = float((g - w).abs().max())
    mismatched = int(((g - w).abs() > TOLERANCES[name]).sum())
    print(f"kernel vs plain {case} {name}: max_abs_err {err!r}"
          f" (tolerance {TOLERANCES[name]}, {mismatched} over)")
    if err > TOLERANCES[name]:
      fail(f"{case} {name}: max_abs_err {err} > {TOLERANCES[name]}")
    worst = max(worst, err)
  return worst


def check_kernel(device) -> dict:
  """Phase 3: kernel vs plain version at the main path's shapes, and at a
  radius that the generic instantiation serves."""
  from badslam_tpu_torch.ops import fused_preprocess as fp
  worst = 0.0
  timing = None
  for width, height, kwargs in ((640, 480, PREPROCESS),
                                (641, 479, PREPROCESS),
                                (320, 240, PREPROCESS_RADIUS_2)):
    radius = int(kwargs["radius_factor"] * kwargs["sigma_xy"] + 0.5)
    raw, calib = kernel_inputs(width, height, seed=width, device=device)
    worst = max(worst, compare_kernel(f"{width}x{height} radius {radius}",
                                      raw, calib, kwargs))
    if timing is None:
      def run_plain():
        return fp.fused_depth_preprocess_reference(raw, calib, **PREPROCESS)

      def run_kernel():
        return fp.fused_depth_preprocess(raw, calib, **PREPROCESS)

      # Plain, kernel, kernel, plain; each reported time is the mean of
      # its two turns' medians.
      plain = [cuda_median_ms(run_plain)]
      kernel, call = [], []
      for _ in range(2):
        kernel.append(device_ms_per_launch(run_kernel))
        call.append(cuda_median_ms(run_kernel))
      plain.append(cuda_median_ms(run_plain))
      bound = preprocess_bound(raw, **PREPROCESS)
      timing = {"ms": statistics.mean(kernel),
                "call_ms": statistics.mean(call),
                "plain_ms": statistics.mean(plain),
                "bound_ms": bound["bound_ms"],
                "bound_by": bound["bound_by"]}
      print(f"640x480 preprocess, each turn's median of 50: kernel on the "
            f"device "
            f"{kernel} ms per launch; one wrapper call from the host {call} "
            f"ms; plain {plain} ms")
      print(f"640x480 preprocess bound: {bound['bytes']} bytes -> "
            f"{bound['bytes_ms'] * 1e3!r} us; {bound['ops']} float32 "
            f"operations ({bound['taps']} taps, {bound['valid']} valid and "
            f"{bound['center']} center pixels) -> {bound['ops_ms'] * 1e3!r}"
            f" us; special-function results -> {bound['sfu_ms'] * 1e3!r} us;"
            f" bound {bound['bound_ms'] * 1e3!r} us by {bound['bound_by']};"
            f" the kernel reaches "
            f"{bound['bound_ms'] / timing['ms'] * 100!r}% of it")
  return {"max_abs_err": worst, **timing}


def write_dataset(workdir: str) -> str:
  """Phase 4."""
  from badslam_tpu_torch.utils import tum_synth
  data = os.path.join(workdir, "tum640")
  t0 = time.perf_counter()
  tum_synth.write_tum_dataset(data, tum_synth.straight_trajectory(FRAMES),
                              width=640, height=480, quiet=True)
  print(f"wrote {FRAMES}-frame 640x480 dataset in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  return data


def run_cli(argv, label: str, launches_expected: int = FRAMES,
            mesh=None) -> dict:
  """One run of the port's CLI with the kernels' launch counts set to 0 just
  before and read just after (``pose_launches``: the pose_h_b accumulate
  and step launches); its standard output is echoed. ``slam`` in
  the result is the system the CLI built (it holds device memory: drop it
  before the next run's peak is measured). ``mesh``: the system is built
  over it (a virtual mesh over one card, which the CLI does not offer)."""
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.ops import pose_h_b
  from badslam_tpu_torch.slam import system
  from badslam_tpu_torch.utils.timing import Timing
  built = []
  original = system.BadSlam

  def recording_bad_slam(*args, **kwargs):
    if mesh is not None:
      kwargs["mesh"] = mesh
    built.append(original(*args, **kwargs))
    return built[-1]

  Timing.set_device_accurate(False)
  Timing.reset()
  gc.collect()   # an earlier run's system must not count into this peak
  # Nor the cuBLAS workspaces that PyTorch keeps for the life of the
  # process, one per (thread's handle, stream): every run under parallel BA
  # brings two new ones.
  clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
  if clear_workspaces is not None:
    clear_workspaces()
  left = torch.cuda.memory_allocated()
  if left:
    alive = sum(isinstance(o, original) for o in gc.get_objects())
    print(f"{label}: {left} bytes still allocated before the run (in its "
          f"peak); {alive} BadSlam objects alive")
  torch.cuda.reset_peak_memory_stats()
  out = io.StringIO()
  system.BadSlam = recording_bad_slam
  fp.fused_depth_preprocess.launches = 0
  pose_h_b.accumulate.launches = pose_h_b.step.launches = 0
  try:
    with contextlib.redirect_stdout(out):
      rc = port_main.main(argv)
  finally:
    system.BadSlam = original
  launches = fp.fused_depth_preprocess.launches
  pose_launches = (pose_h_b.accumulate.launches, pose_h_b.step.launches)
  peak = torch.cuda.max_memory_allocated()
  print(out.getvalue().rstrip(), flush=True)
  if rc != 0:
    fail(f"{label}: the CLI returned {rc}")
  if launches != launches_expected:
    fail(f"{label}: fused_depth_preprocess launched {launches} times, "
         f"expected {launches_expected}")
  return {"launches": launches, "pose_launches": pose_launches,
          "peak": peak, "stdout": out.getvalue(), "stats": Timing.stats(),
          "slam": built[-1]}


def check_trajectory(poses_path: str, data: str, label: str) -> float:
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  _, est = read_tum_trajectory(poses_path)
  _, gt = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  if est.shape != (FRAMES, 4, 4) or not np.isfinite(est).all():
    fail(f"{label} trajectory: shape {est.shape}, finite "
         f"{np.isfinite(est).all()}")
  ate = ate_rmse(est[:, :3, 3].astype(np.float64),
                 gt[:, :3, 3].astype(np.float64))
  if not ate <= ATE_GATE_M:
    fail(f"{label}: ATE {ate} m > {ATE_GATE_M} m")
  return ate


def print_phases(stats, phases, skip, how: str = "device-accurate") -> None:
  """count, mean and median ms of each phase; ``skip`` maps a phase to the
  number of leading (cold) samples left out; ``how`` says what the spans
  measure."""
  for phase in phases:
    if phase not in stats:
      print(f"phase {phase}: count 0")
      continue
    s = stats[phase]
    warm = s.samples[skip.get(phase, 0):] or s.samples
    print(f"phase {phase}: count {s.count}, warm mean "
          f"{statistics.mean(warm) * 1e3!r} ms, median "
          f"{statistics.median(warm) * 1e3!r} ms ({how})")


def run_main_path(workdir: str, data: str) -> dict:
  """Phases 5-6: the odometry-only CLI, counting kernel launches."""
  poses_path = os.path.join(workdir, "poses.txt")
  timings_path = os.path.join(workdir, "timings.txt")
  argv = [data, "--keyframe_interval", "5", "--num_scales", "5",
          "--max_depth", "5.0", "--max_num_ba_iterations_per_keyframe", "0",
          "--no_loop_detection", "--sequential_ba", "--restrict_fps_to", "0",
          "--device_accurate_timings", "--export_poses", poses_path,
          "--export_final_timings", timings_path]
  run = run_cli(argv, "odometry-only path")
  ate = check_trajectory(poses_path, data, "odometry-only path")
  print(f"odometry-only ATE RMSE {ate!r} m over {FRAMES} frames; gate "
        f"{ATE_GATE_M} m (160x120 record), formula bound at 640x480 "
        f"{ATE_FORMULA_640_M!r} m (no record to hold it to)")

  stats = run["stats"]
  frame_s = stats["[BadSlam::ProcessFrame]"].samples
  print(f"odometry-only warm frames/s (frames 2..{FRAMES - 1}): "
        f"{(len(frame_s) - 2) / sum(frame_s[2:])!r}; first two frames "
        f"{frame_s[0] * 1e3:.1f} ms, {frame_s[1] * 1e3:.1f} ms")
  print_phases(stats, ("Preprocessing", "Odometry", "Keyframe creation"),
               {"Preprocessing": 2, "Odometry": 2, "Keyframe creation": 1})
  print(f"odometry-only peak device memory (max_memory_allocated): "
        f"{run['peak']} bytes")
  with open(timings_path) as f:
    print(f.read().rstrip())
  return {"launches": run["launches"], "ate": ate}


def check_map_run(run: dict, label: str, data: str, poses_path: str,
                  ply_path: str, keyframe_interval: int) -> dict:
  """What every CLI run with BA on must show: the trajectory and map gates,
  the keyframe count, live surfels, and a PLY that holds them."""
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.utils import synthetic
  ate = check_trajectory(poses_path, data, label)
  done = re.search(r"Done: (\d+) frames .* (\d+) keyframes, (\d+) surfels",
                   run["stdout"])
  store = re.search(r"Surfel store: watermark (\d+) of capacity (\d+); "
                    r"keyframe store: capacity (\d+)", run["stdout"])
  if not done or not store:
    fail(f"{label}: no Done / Surfel store line in the CLI's output")
  keyframes, surfels = int(done.group(2)), int(done.group(3))
  watermark, capacity, kf_capacity = (int(g) for g in store.groups())
  expected_keyframes = (FRAMES - 1) // keyframe_interval + 1
  if keyframes != expected_keyframes or keyframes < 4:
    fail(f"{label}: {keyframes} keyframes, expected {expected_keyframes}")
  if surfels <= 0:
    fail(f"{label}: no live surfels")
  pos, nrm, _ = ply.load_point_cloud_ply(ply_path)
  if pos.shape != (surfels, 3) or not (np.isfinite(pos).all()
                                       and np.isfinite(nrm).all()):
    fail(f"{label}: PLY holds {pos.shape} points, {surfels} live surfels")
  err = synthetic.surfel_map_error(pos)
  print(f"{label} map error against the heightmap: {json.dumps(err)} "
        f"(gate: median_abs_m < {MAP_MEDIAN_GATE_M})")
  if not err["median_abs_m"] < MAP_MEDIAN_GATE_M:
    fail(f"{label}: map median |error| {err['median_abs_m']} m")
  print(f"{label}: {keyframes} keyframes (store capacity {kf_capacity}), "
        f"{surfels} live surfels, watermark {watermark}, capacity "
        f"{capacity}")
  return {"ate": ate, "keyframes": keyframes, "surfels": surfels}


def ba_iterations_per_call(stream_path: str, label: str) -> list:
  """The --save_timings stream (one line per BA iteration) as the number of
  iterations of each BA call."""
  per_call = {}
  with open(stream_path) as f:
    for line in f:
      m = re.match(r"BA_count (\d+) inner_iteration (\d+) keyframe_count "
                   r"(\d+) surfel_count (\d+)", line)
      if not m:
        fail(f"{label}: bad --save_timings line {line!r}")
      per_call[int(m.group(1))] = int(m.group(2)) + 1
  return [per_call[c] for c in sorted(per_call)]


def warm_frames_per_s(run: dict) -> float:
  frame_s = run["stats"]["[BadSlam::ProcessFrame]"].samples
  return (len(frame_s) - 2) / sum(frame_s[2:])


def print_ba_run(run: dict, label: str, iterations: list, phases) -> None:
  stats = run["stats"]
  print(f"{label} warm frames/s (frames 2..{FRAMES - 1}, BA included): "
        f"{warm_frames_per_s(run)!r}")
  print_phases(stats, ("Preprocessing", "Odometry", "Keyframe creation")
               + phases,
               {"Preprocessing": 2, "Odometry": 2, "Keyframe creation": 1})
  ba_s = sum(stats["Bundle adjustment"].samples)
  print(f"{label}: iterations of each of {len(iterations)} BA schemes (the "
        f"frame loop's, then any final BA's) {iterations}; the "
        f"{stats['Bundle adjustment'].count} calls of the frame loop took "
        f"{ba_s * 1e3!r} ms")
  print(f"{label} peak device memory (max_memory_allocated): {run['peak']} "
        f"bytes")


def ba_path_argv(workdir: str, data: str, tag: str) -> list:
  """Phase 7's command line (the reference CLI's defaults with sequential BA
  and without loop detection), exporting into files named by ``tag``."""
  return [data, "--sequential_ba", "--no_loop_detection",
          "--restrict_fps_to", "0", "--max_depth", "5.0", "--num_scales", "5",
          "--device_accurate_timings",
          "--export_poses", os.path.join(workdir, f"poses_{tag}.txt"),
          "--export_point_cloud", os.path.join(workdir, f"map_{tag}.ply"),
          "--save_timings", os.path.join(workdir, f"iterations_{tag}.txt"),
          "--export_final_timings", os.path.join(workdir,
                                                 f"timings_{tag}.txt")]


def run_verified_cli(argv, label: str) -> dict:
  """run_cli with the host mirrors recounted on the device and checked after
  every BA call."""
  from badslam_tpu_torch.slam import direct_ba
  direct_ba.DEBUG_VERIFY_COUNT = True
  try:
    return run_cli(argv, label)
  finally:
    direct_ba.DEBUG_VERIFY_COUNT = False


def run_ba_path(workdir: str, data: str, odometry_ate: float) -> dict:
  """Phase 7: the CLI with sequential BA on, at the reference's defaults."""
  label = "BA path"
  poses_path = os.path.join(workdir, "poses_ba.txt")
  ply_path = os.path.join(workdir, "map_ba.ply")
  stream_path = os.path.join(workdir, "iterations_ba.txt")
  timings_path = os.path.join(workdir, "timings_ba.txt")
  run = run_verified_cli(ba_path_argv(workdir, data, "ba"), label)
  checked = check_map_run(run, label, data, poses_path, ply_path,
                          KEYFRAME_INTERVAL_BA)
  print(f"{label} ATE RMSE {checked['ate']!r} m over {FRAMES} frames (gate "
        f"{ATE_GATE_M} m); odometry-only on the same frames "
        f"{odometry_ate!r} m")
  iterations = ba_iterations_per_call(stream_path, label)
  stats = run["stats"]
  calls = stats["Bundle adjustment"].count if "Bundle adjustment" in stats \
      else 0
  if (calls < checked["keyframes"] - 1 or len(iterations) != calls
      or min(iterations) < 1):
    fail(f"{label}: {calls} BA calls, iterations per call {iterations}")
  print_ba_run(run, label, iterations, BA_PHASES)
  steps = stats.get("BA pose GN steps")
  lane_steps = int(sum(stats["BA pose lane steps"].samples)) if steps else 0
  phases, steps = (steps.count, int(sum(steps.samples))) if steps else (0, 0)
  print(f"{label}: pose_h_b launches (accumulate, step) "
        f"{run['pose_launches']}; {steps} shared GN steps in {phases} pose "
        f"phases, {lane_steps} lane steps "
        f"({lane_steps / max(steps, 1)!r} lanes a launch)")
  if steps < 1 or run["pose_launches"] != (steps, steps):
    fail(f"{label}: pose_h_b launched {run['pose_launches']} times for "
         f"{steps} shared GN steps")
  ba_ms = sum(stats["Bundle adjustment"].samples) * 1e3
  print(f"{label}: {ba_ms / sum(iterations)!r} ms per BA iteration (end "
        f"tasks included); host mirrors verified after each of {calls} BA "
        f"calls")
  with open(timings_path) as f:
    print(f.read().rstrip())
  return {"launches": run["launches"], "frames_per_s": warm_frames_per_s(run),
          "surfels": checked["surfels"], "peak": run["peak"],
          "ms_per_iteration": ba_ms / sum(iterations),
          "poses": poses_path, "pose_launches": run["pose_launches"],
          "ba": run["slam"].direct_ba}


def pose_accumulate(kf, cams, T, done, surfels, use_depth: bool,
                    use_desc: bool, out, scratch) -> None:
  """One launch of pose_h_b_accumulate_kernel over the lanes ``done``
  leaves open; ``cams`` = (depth camera, color camera, calibration),
  ``scratch`` = (partials, ticket)."""
  from badslam_tpu_torch.models import pose_opt
  from badslam_tpu_torch.ops import pose_h_b
  depth_cam, color_cam, dp = cams
  dev = T.device
  pose_h_b.accumulate(
      T, done, surfels, kf.depth, kf.normals, kf.intensity,
      pose_opt._intrinsics(depth_cam, dev),
      pose_opt._intrinsics(color_cam, dev),
      (color_cam.width, color_cam.height), dp, use_depth, use_desc, out,
      *scratch)


def pose_h_b_bound(kf, cams, T, done, surfels) -> dict:
  """The least time an H100 could take for one pose_h_b_accumulate_kernel
  launch (both residual kinds) over the lanes ``done`` leaves open at the
  poses ``T``: the larger of its bytes over the memory rate and its float32
  operations over the float32 peak. The pairs are counted from the data as
  far as the kernel takes each (the POSE_OPS_* constants); the surfels
  under the watermark are read once, and a lane's depth, cfactor, normal
  and intensity values once per pair that needs them, at most the lane's
  whole image."""
  import torch
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.geometry.camera import DepthToColorTransform
  from badslam_tpu_torch.models import association
  depth_cam, color_cam, dp = cams
  h, w = kf.depth.shape[1:]
  hi, wi = kf.intensity.shape[1:]
  count = int(surfels.count)
  valid = surfels.valid & (torch.arange(
      surfels.capacity, device=surfels.valid.device) < count)
  nbytes = (count * POSE_VALID_BYTES
            + int(valid.sum()) * POSE_SURFEL_BYTES)
  ops = 0
  pairs = dict.fromkeys(("tested", "front", "in_image", "measured",
                         "associated", "descriptor"), 0)
  for lane in torch.nonzero(~done).flatten().tolist():
    a = association.associate_surfels(
        surfels.pos, surfels.normal, valid, se3.inverse(T[lane]),
        kf.depth[lane], kf.normals[lane], depth_cam, dp)
    front = valid & (a.local_pos[:, 2] > 0)
    in_image = front & depth_cam.in_image(a.pxy)
    measured = in_image & (kf.depth[lane][a.py, a.px] > 0)
    _, in_color = DepthToColorTransform.between(depth_cam, color_cam).apply(
        a.pxy)
    n = {name: int(m.sum()) for name, m in (
        ("tested", valid), ("front", front), ("in_image", in_image),
        ("measured", measured), ("associated", a.mask),
        ("descriptor", a.mask & in_color))}
    for name in pairs:
      pairs[name] += n[name]
    ops += (n["tested"] * POSE_OPS_TESTED + n["front"] * POSE_OPS_FRONT
            + n["measured"] * POSE_OPS_MEASURED
            + n["associated"] * (POSE_OPS_ASSOCIATED + POSE_OPS_DEPTH_TERM)
            + n["descriptor"] * POSE_OPS_DESCRIPTOR_TERMS)
    nbytes += (min(4 * n["in_image"], 4 * h * w)
               + min(4 * n["measured"], 4 * dp.cfactor.numel())
               + min(8 * n["associated"], 8 * h * w)
               + min(48 * n["descriptor"], 4 * hi * wi))
  bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
  ops_ms = ops / H100_FP32_OPS_PER_S * 1e3
  return {"bytes": nbytes, "ops": ops, "pairs": pairs, "bytes_ms": bytes_ms,
          "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
          "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def check_pose_kernels(ba, device) -> dict:
  """Phase 37: the pose_h_b kernels on phase 7's map and keyframes against
  their plain versions, and timed."""
  import torch
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.kernels import build
  from badslam_tpu_torch.models import pose_opt
  from badslam_tpu_torch.ops import pose_h_b
  from badslam_tpu_torch.utils.timing import Timing
  s = ba.surfels
  s = s._replace(count=s.count.to(device), **{
      name: getattr(s, name).contiguous()
      for name in ("pos", "normal", "radius_sq", "desc", "valid")})
  kf = ba.kf._replace(**{name: getattr(ba.kf, name).contiguous()
                         for name in ("depth", "normals", "intensity")})
  cams = (ba.depth_camera(), ba.color_camera(), ba.depth_params())
  k = kf.global_T_frame.shape[0]
  optimize = kf.valid.clone()
  lanes = torch.nonzero(optimize).flatten().tolist()
  rng = np.random.default_rng(POSE_SEED)
  T = kf.global_T_frame.clone()
  for lane in lanes[1:]:
    noise = np.concatenate([
        rng.uniform(-POSE_PERTURBATION[0], POSE_PERTURBATION[0], 3),
        rng.uniform(-POSE_PERTURBATION[1], POSE_PERTURBATION[1], 3)])
    T[lane] = T[lane] @ se3.exp(torch.from_numpy(
        noise.astype(np.float32)).to(device))
  scratch = (torch.empty((pose_h_b.blocks(s.capacity, device), k,
                          pose_h_b.SUMS), device=device),
             torch.zeros((), dtype=torch.int32, device=device))
  print(f"phase 7's map: {len(lanes)} keyframe lanes of {k} slots, "
        f"{int(s.count)} surfel slots ({int(s.valid.sum())} valid) of "
        f"capacity {s.capacity}; pose_h_b built in "
        f"{build.build_info['pose_h_b'][0]:.1f} s of nvcc")

  def outputs():
    return (torch.zeros((k, 6, 6), device=device),
            torch.zeros((k, 6), device=device),
            torch.zeros((k,), dtype=torch.int32, device=device))

  def lane_args(lane):
    return (T[lane], kf.depth[lane], kf.normals[lane], kf.intensity[lane])

  # The accumulate kernel: one launch over every lane for the residual
  # counts, then one a lane over its surfels off their tap cells' edges
  # for H and b.
  worst = 0.0
  for use_depth, use_desc in ((True, True), (True, False), (False, True)):
    case = {(True, True): "both", (True, False): "depth",
            (False, True): "descriptors"}[(use_depth, use_desc)]
    out = outputs()
    pose_accumulate(kf, cams, T, ~optimize, s, use_depth, use_desc, out,
                    scratch)
    counts = out[2].tolist()
    for lane in lanes:
      t, d, nrm, inten = lane_args(lane)
      want_n = int(pose_opt.accumulate_pose_h_b(
          t, s, d, nrm, inten, *cams, use_depth, use_desc,
          compute_cost=True)[3])
      if counts[lane] != want_n or want_n < 200:
        fail(f"pose_h_b {case} lane {lane}: {counts[lane]} residuals, the "
             f"plain version {want_n}")
      s_off = s._replace(valid=s.valid & pose_h_b.off_tap_cell_edges(
          t, s, d, nrm, *cams))
      done = torch.ones((k,), dtype=torch.bool, device=device)
      done[lane] = False
      out = outputs()
      pose_accumulate(kf, cams, T, done, s_off, use_depth, use_desc, out,
                      scratch)
      wH, wb, _, wn = pose_opt.accumulate_pose_h_b(
          t, s_off, d, nrm, inten, *cams, use_depth, use_desc,
          compute_cost=True)
      scale_H, scale_b = pose_h_b.h_b_scales(t, s_off, d, nrm, inten, *cams,
                                             use_depth, use_desc)
      err = max(float(((out[0][lane].cpu() - wH.cpu()).abs()
                       / scale_H).max()),
                float(((out[1][lane].cpu() - wb.cpu()).abs()
                       / scale_b).max()))
      print(f"pose_h_b accumulate vs plain {case} lane {lane}: {want_n} "
            f"residuals equal; {int(wn)} off the tap cells' edges, H and b "
            f"{err!r} of their summands' magnitude (tolerance "
            f"{POSE_H_B_TOLERANCE})")
      if int(out[2][lane]) != int(wn) or not err <= POSE_H_B_TOLERANCE:
        fail(f"pose_h_b {case} lane {lane}: H/b {err} of the summands, "
             f"{int(out[2][lane])} against {int(wn)} residuals")
      worst = max(worst, err)

  # The step kernel against step_lanes_plain on the plain H and b.
  out = outputs()
  pose_opt.accumulate_lanes_h_b_plain(
      T, ~optimize, lanes, s, kf.depth, kf.normals, kf.intensity, *cams,
      True, True, out)
  H, b, _ = out

  def step_state():
    return [T.clone(), ~optimize, torch.zeros((2,), dtype=torch.int32,
                                              device=device),
            torch.zeros((), dtype=torch.bool, device=device)]
  got, want = step_state(), step_state()
  pose_h_b.step(got[0], got[1], H, b, got[2], got[3])
  pose_opt.step_lanes_plain(want[0], want[1], H, b, want[2], want[3], lanes)
  step_err = float((got[0] - want[0]).abs().max())
  print(f"pose_h_b step vs plain: poses {step_err!r} apart (tolerance "
        f"{POSE_STEP_TOLERANCE}); state {got[2].tolist()} / "
        f"{want[2].tolist()}")
  if not (step_err <= POSE_STEP_TOLERANCE and torch.equal(got[1], want[1])
          and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3])):
    fail(f"pose_h_b step: poses {step_err} apart, or the lanes' state "
         f"differs")

  # The whole pose GN against each lane's own loop.
  before = (pose_h_b.accumulate.launches, pose_h_b.step.launches)
  with Timing.isolated() as stats:
    got_T, moved = pose_opt.estimate_frame_poses_batched(
        T, optimize, s, kf.depth, kf.normals, kf.intensity, *cams)
  steps = int(sum(stats["BA pose GN steps"].samples))
  lane_steps = int(sum(stats["BA pose lane steps"].samples))
  launches = (pose_h_b.accumulate.launches - before[0],
              pose_h_b.step.launches - before[1])
  want_T = T.clone()
  for lane in lanes:
    t, d, nrm, inten = lane_args(lane)
    want_T[lane], _ = pose_opt.estimate_frame_pose(t, s, d, nrm, inten,
                                                   *cams)
  want_moved = optimize & ~pose_opt.is_scale1_converged(
      se3.log(se3.inverse(T) @ want_T))
  loop_err = float((got_T - want_T).abs().max())
  print(f"pose GN on the card: {steps} shared steps, {lane_steps} lane "
        f"steps, launches {launches}; poses {loop_err!r} from each lane's "
        f"plain loop (tolerance {POSE_LOOP_TOLERANCE}); moved "
        f"{moved.tolist()}")
  if (launches != (steps, steps) or steps < 2
      or not loop_err <= POSE_LOOP_TOLERANCE
      or not torch.equal(moved, want_moved)):
    fail(f"pose GN: launches {launches} for {steps} steps, poses "
         f"{loop_err} apart, moved {moved.tolist()} against "
         f"{want_moved.tolist()}")

  # Times, in turns (plain, kernel, kernel, plain): the accumulate over
  # every lane with both residual kinds, and the step with every lane open
  # (b = H x for x = 0.01, which no step converges).
  out = outputs()
  done_all = ~optimize

  def run_kernel():
    pose_accumulate(kf, cams, T, done_all, s, True, True, out, scratch)

  def run_plain():
    pose_opt.accumulate_lanes_h_b_plain(
        T, done_all, lanes, s, kf.depth, kf.normals, kf.intensity, *cams,
        True, True, out)

  b_open = (H @ torch.full((k, 6, 1), 1e-2, device=device))[..., 0]
  kernel_state, plain_state = step_state(), step_state()

  def run_step():
    pose_h_b.step(kernel_state[0], kernel_state[1], H, b_open,
                  *kernel_state[2:])

  def run_step_plain():
    pose_opt.step_lanes_plain(plain_state[0], plain_state[1], H, b_open,
                              *plain_state[2:], lanes)

  timing = {}
  for name, kernel_fn, plain_fn in (("accumulate", run_kernel, run_plain),
                                    ("step", run_step, run_step_plain)):
    plain = [cuda_median_ms(plain_fn, runs=10)]
    kernel, call = [], []
    for _ in range(2):
      kernel.append(device_ms_per_launch(kernel_fn))
      call.append(cuda_median_ms(kernel_fn))
    plain.append(cuda_median_ms(plain_fn, runs=10))
    timing[name] = {"ms": statistics.mean(kernel),
                    "call_ms": statistics.mean(call),
                    "plain_ms": statistics.mean(plain)}
    print(f"pose_h_b {name} at {len(lanes)} lanes, each turn's median: "
          f"kernel on the device {kernel} ms per launch; one wrapper call "
          f"from the host {call} ms; plain {plain} ms")
  if int(kernel_state[1].sum()) != k - len(lanes):
    fail("pose_h_b step timing: a lane converged")
  bound = pose_h_b_bound(kf, cams, T, done_all, s)
  step_bytes = len(lanes) * (2 * 64 + 144 + 24 + 2)
  step_ops = len(lanes) * POSE_STEP_OPS_PER_LANE
  step_bound = {"bytes_ms": step_bytes / H100_BYTES_PER_S * 1e3,
                "ops_ms": step_ops / H100_FP32_OPS_PER_S * 1e3}
  step_bound["bound_ms"] = max(step_bound.values())
  step_bound["bound_by"] = ("operations" if step_bound["ops_ms"]
                            > step_bound["bytes_ms"] else "bytes")
  for name, bnd in (("accumulate", bound), ("step", step_bound)):
    timing[name].update(bound_ms=bnd["bound_ms"], bound_by=bnd["bound_by"])
  print(f"pose_h_b accumulate bound: pairs {json.dumps(bound['pairs'])}; "
        f"{bound['bytes']} bytes -> {bound['bytes_ms'] * 1e3!r} us; "
        f"{bound['ops']} float32 operations -> {bound['ops_ms'] * 1e3!r} "
        f"us; bound {bound['bound_ms'] * 1e3!r} us by {bound['bound_by']}; "
        f"the kernel reaches "
        f"{bound['bound_ms'] / timing['accumulate']['ms'] * 100!r}% of it")
  print(f"pose_h_b step bound: {step_bytes} bytes, {step_ops} float32 "
        f"operations -> {step_bound['bound_ms'] * 1e3!r} us by "
        f"{step_bound['bound_by']}; the kernel reaches "
        f"{step_bound['bound_ms'] / timing['step']['ms'] * 100!r}% of it "
        f"(one thread a lane: its time is the launch and the lane's "
        f"serial arithmetic)")
  return {"max_scaled_err": worst, "step_err": step_err,
          "loop_err": loop_err, "lanes": len(lanes), **timing}


# Phase 36: the cold start. Phase 7's command line in fresh processes,
# without and with --prewarm, in turns.
COLD_START_TURNS = ("plain", "prewarm", "prewarm", "plain")
COLD_START_PREWARM_KEYFRAMES = 6
COLD_START_PIPELINED_FRAMES = 21
CHILD_FLAG = "--cold-start-child"


def cold_start_child(argv: list) -> int:
  """A phase-36 run in a process of its own (``chip_smoke.py
  --cold-start-child '<argv as JSON>'``): the CLI on ``argv``, then one line
  ``cold start: {...}`` with what the parent reads. The kernel's launch
  count is set to 0 where ``prewarm`` returns (the launches before are the
  warm frames') and so is the peak memory. The odometry's Gauss-Newton
  iterations are counted per frame, warm and live."""
  t_start = time.perf_counter()
  sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.slam import system
  from badslam_tpu_torch.utils.timing import Timing
  record = {"warm_launches": 0, "prewarm_s": None, "prewarm_peak": None,
            "warm_gn": [], "live_gn": []}
  real_prewarm = system.BadSlam.prewarm
  real_process_frame = system.BadSlam.process_frame
  warming = []

  def prewarm(self, *args, **kwargs):
    t0 = time.perf_counter()
    warming.append(True)
    real_prewarm(self, *args, **kwargs)
    warming.clear()
    record["prewarm_s"] = time.perf_counter() - t0
    record["warm_launches"] = fp.fused_depth_preprocess.launches
    record["prewarm_peak"] = torch.cuda.max_memory_allocated()
    fp.fused_depth_preprocess.launches = 0
    torch.cuda.reset_peak_memory_stats()

  def process_frame(self, frame_index, *args, **kwargs):
    live = not warming
    if live and "first_frame_start_s" not in record:
      record["first_frame_start_s"] = time.perf_counter() - t_start
      # torch.broadcast_shapes imports sympy on its first call.
      record["sympy_before_frame_0"] = "sympy" in sys.modules
    gn0 = gn[0]
    real_process_frame(self, frame_index, *args, **kwargs)
    record["live_gn" if live else "warm_gn"].append(gn[0] - gn0)
    if live:
      record.setdefault("first_frame_end_s", time.perf_counter() - t_start)

  system.BadSlam.prewarm = prewarm
  system.BadSlam.process_frame = process_frame
  fp.fused_depth_preprocess.launches = 0
  with gn_iteration_count() as gn:
    rc = port_main.main(argv)
  stats = Timing.stats()
  record.update(
      rc=rc, launches=fp.fused_depth_preprocess.launches,
      peak=torch.cuda.max_memory_allocated(),
      frame_s=stats["[BadSlam::ProcessFrame]"].samples,
      ba_s=stats["Bundle adjustment"].samples,
      process_s=time.perf_counter() - t_start)
  print("cold start: " + json.dumps(record), flush=True)
  return 0


def cold_start_cli(argv: list, label: str) -> dict:
  """One cold-start child: its record, stdout and the prewarm breakdown it
  logged (None without --prewarm)."""
  proc = subprocess.run(
      [sys.executable, os.path.abspath(__file__), CHILD_FLAG,
       json.dumps(argv)], capture_output=True, text=True, timeout=600)
  line = next((ln for ln in proc.stdout.splitlines()
               if ln.startswith("cold start: ")), None)
  if proc.returncode != 0 or line is None:
    fail(f"{label}: exit code {proc.returncode}\n{proc.stdout[-3000:]}\n"
         f"{proc.stderr[-3000:]}")
  run = json.loads(line[len("cold start: "):])
  if run["rc"] != 0:
    fail(f"{label}: the CLI returned {run['rc']}")
  logged = re.search(r"prewarm breakdown: (.*)", proc.stderr)
  run["breakdown"] = None if logged is None else {
      k: float(v.rstrip("s")) for k, v in
      (item.split("=") for item in logged.group(1).split(", "))}
  run["stdout"] = proc.stdout
  return run


def run_cold_start(workdir: str, data: str, device) -> dict:
  """Phase 36: phase 7's command line in a fresh process per run (no
  library handle, no kernel module loaded; build/ already holds the
  kernel's library), without and with --prewarm --prewarm_keyframes 6 in
  COLD_START_TURNS: rc 0, phase 7's ATE and map gates, one launch per live
  frame, the four trajectories equal to the last bit, and with --prewarm
  the kernel's library loaded inside the prewarm (its logged breakdown);
  then 21 frames of the pipelined front-end in process, prewarmed outside
  torch.cuda.set_sync_debug_mode("error") and every frame inside it."""
  import torch
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.kernels import build
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.utils.timing import Timing
  out = {"launches": 0, "frames": 0, "runs": []}
  trajectories = []
  for turn, name in enumerate(COLD_START_TURNS):
    label = f"cold start {name} run {turn + 1}"
    tag = f"cold{turn}"
    argv = ba_path_argv(workdir, data, tag)
    if name == "prewarm":
      argv += ["--prewarm", "--prewarm_keyframes",
               str(COLD_START_PREWARM_KEYFRAMES)]
    run = cold_start_cli(argv, label)
    poses = os.path.join(workdir, f"poses_{tag}.txt")
    checked = check_map_run(run, label, data, poses,
                            os.path.join(workdir, f"map_{tag}.ply"),
                            KEYFRAME_INTERVAL_BA)
    trajectories.append(read_tum_trajectory(poses))
    if run["launches"] != FRAMES:
      fail(f"{label}: {run['launches']} launches in the live frames, "
           f"expected {FRAMES}")
    breakdown = run["breakdown"]
    warm_frames = 0
    if name == "prewarm":
      if breakdown is None or "kernel_load_fused_preprocess" not in breakdown:
        fail(f"{label}: the kernel's library was not loaded inside the "
             f"prewarm (breakdown {breakdown})")
      warm_frames = sum(k.startswith("warm_frame_") for k in breakdown)
      if run["warm_launches"] != warm_frames:
        fail(f"{label}: {run['warm_launches']} launches in "
             f"{warm_frames} warm frames")
    elif breakdown is not None:
      fail(f"{label}: a prewarm ran without --prewarm")
    frame_s, ba_s = run["frame_s"], run["ba_s"]
    largest = max(range(len(frame_s)), key=frame_s.__getitem__)
    fps = (len(frame_s) - 2) / sum(frame_s[2:])
    print(f"{label}: frame 0 {frame_s[0] * 1e3!r} ms, frame 1 "
          f"{frame_s[1] * 1e3!r} ms, first BA call {ba_s[0] * 1e3!r} ms, "
          f"largest frame {frame_s[largest] * 1e3!r} ms (frame {largest}); "
          f"warm frames/s (2..{FRAMES - 1}) {fps!r}; prewarm "
          f"{run['prewarm_s']!r} s; from the child's start (before it imports "
          f"torch) to frame 0's start "
          f"{run['first_frame_start_s']!r} s, to its end "
          f"{run['first_frame_end_s']!r} s, to exit {run['process_s']!r} s; "
          f"launches live {run['launches']}, warm {run['warm_launches']}; "
          f"peak device memory: live frames {run['peak']} bytes, prewarm "
          f"{run['prewarm_peak']} bytes; sympy imported before frame 0: "
          f"{run['sympy_before_frame_0']}; ATE {checked['ate']!r} m; GN "
          f"iterations per warm frame {run['warm_gn']}, per live frame 1-12 "
          f"{run['live_gn'][1:13]}")
    if breakdown is not None:
      print(f"{label} prewarm breakdown (s): {json.dumps(breakdown)}")
    out["launches"] += run["launches"] + run["warm_launches"]
    out["frames"] += FRAMES + warm_frames
    out["runs"].append({
        "name": name, "frame0_ms": frame_s[0] * 1e3,
        "frame1_ms": frame_s[1] * 1e3, "first_ba_ms": ba_s[0] * 1e3,
        "largest_ms": frame_s[largest] * 1e3, "fps": fps,
        "prewarm_s": run["prewarm_s"]})
  ts0, poses0 = trajectories[0]
  for ts, poses in trajectories[1:]:
    if not (np.array_equal(ts, ts0) and np.array_equal(poses, poses0)):
      fail("cold start: the trajectories of the four runs differ")
  print(f"cold start: the {len(trajectories)} trajectories are equal to the "
        f"last bit; the kernel's nvcc build in phase 2 took "
        f"{build.build_info['fused_preprocess'][0]!r} s (what a fresh "
        f"checkout pays in its first frame without --prewarm)")

  label = "prewarmed pipelined front-end under the sync guard"
  # Phase 7's in-process CLI run left device-accurate spans on: their
  # barriers synchronize.
  Timing.set_device_accurate(False)
  slam, video = in_process_system(workdir, data, "pipelined", device)
  try:
    fp.fused_depth_preprocess.launches = 0
    t0 = time.perf_counter()
    slam.prewarm(max_ba_keyframes=3)
    torch.cuda.synchronize()
    prewarm_s = time.perf_counter() - t0
    warm_launches = fp.fused_depth_preprocess.launches
    run = guarded_run(slam, video, data, label,
                      frames=COLD_START_PIPELINED_FRAMES)
  finally:
    slam.stop_ba_thread_and_wait()
    video.close_prefetch()
  warm_frames = sum(k.startswith("warm_frame_")
                    for k in slam.last_prewarm_breakdown)
  if warm_launches != warm_frames:
    fail(f"{label}: {warm_launches} launches in {warm_frames} warm frames")
  print(f"{label}: prewarm {prewarm_s!r} s ({warm_frames} warm frames); no "
        f"synchronizing call in {COLD_START_PIPELINED_FRAMES} frames, the "
        f"loop {run['loop_s']!r} s; ATE RMSE {run['ate']!r} m (gate "
        f"{ATE_GATE_M} m)")
  out["launches"] += run["launches"] + warm_launches
  out["frames"] += COLD_START_PIPELINED_FRAMES + warm_frames
  del slam, video
  gc.collect()
  return out


def check_ba_determinism(data: str, device, mesh=None) -> None:
  """Phase 8: bundle adjustment twice from one map state, held bitwise
  equal. The state is the map after 21 frames without BA (3 keyframes,
  the first one's surfels), the second and third keyframe moved by a
  seeded perturbation of up to 1 mm and 0.3 mrad so that BA has several
  iterations of work. With a ``mesh`` (phase 33) both schemes run over
  it."""
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.slam.direct_ba import DirectBA
  from badslam_tpu_torch.slam.system import BadSlam
  args = port_main.build_parser().parse_args(
      [data, "--sequential_ba", "--no_loop_detection", "--max_depth", "5.0",
       "--max_num_ba_iterations_per_keyframe", "0"])
  config = port_main.config_from_args(args)
  video = dataset_io.load_tum_dataset(
      data, None, raw_to_float_depth=config.raw_to_float_depth)
  slam = BadSlam(config, video, device=device)
  for i in range(2 * KEYFRAME_INTERVAL_BA + 1):
    slam.process_frame(i)
  ba = slam.direct_ba
  surfels, kf, host = ba.to_numpy()
  rng = np.random.default_rng(0)
  for i in range(1, ba.keyframe_count):
    noise = rng.uniform(-1, 1, 6) * ([1e-3] * 3 + [3e-4] * 3)
    kf["global_T_frame"][i] = kf["global_T_frame"][i] @ se3.exp(
        torch.as_tensor(noise, dtype=torch.float32)).numpy()
  where = "" if mesh is None else f" over a {mesh.size}-shard mesh"
  for label, use_pcg, intrinsics in (
      ("alternating" + where, False, False),
      ("use_pcg with both intrinsics flags" + where, True, True)):
    scheme_config = dataclasses.replace(config, use_pcg=use_pcg)
    results = []
    for _ in range(2):
      # Self-calibration writes the calibration in place: each run its own.
      twin = DirectBA.from_numpy(
          scheme_config, video.depth_camera, video.color_camera, surfels, kf,
          ba.calibration.clone(), host, device, mesh=mesh)
      outcome = twin.bundle_adjustment(
          optimize_depth_intrinsics=intrinsics,
          optimize_color_intrinsics=intrinsics, max_iterations=10,
          active_keyframe_window_start=0,
          active_keyframe_window_end=ba.keyframe_count - 1)
      torch.cuda.synchronize()
      calib = twin.calibration
      calibration = {name: t.cpu().numpy() for name, t in (
          ("depth_intr", calib.depth_intr), ("a", calib.a),
          ("cfactor", calib.cfactor), ("color_intr", twin.color_intr))}
      results.append((outcome,) + twin.to_numpy()[:2] + (calibration,))
    (out_a, s_a, k_a, c_a), (out_b, s_b, k_b, c_b) = results
    moved = float(np.abs(k_a["global_T_frame"] - kf["global_T_frame"]).max())
    camera_moved = float(np.abs(
        c_a["depth_intr"] - ba.calibration.depth_intr.cpu().numpy()).max())
    if out_a != out_b:
      fail(f"BA determinism, {label}: {out_a} against {out_b}")
    if intrinsics != (camera_moved > 0):
      fail(f"BA determinism, {label}: depth intrinsics moved by "
           f"{camera_moved}")
    for name, x, y in ([(n, s_a[n], s_b[n]) for n in s_a]
                       + [(n, k_a[n], k_b[n]) for n in k_a]
                       + [(n, c_a[n], c_b[n]) for n in c_a]):
      if x.dtype != y.dtype or x.tobytes() != y.tobytes():
        fail(f"BA determinism, {label}: {name} differs between two runs "
             f"from one state")
    print(f"BA determinism, {label}: two runs of {out_a[0]} iterations from "
          f"one state ({ba.keyframe_count} keyframes, "
          f"{int(s_a['valid'].sum())} live surfels after, poses moved by up "
          f"to {moved!r}, depth intrinsics by up to {camera_moved!r} px) are "
          f"bitwise equal in every field of both stores and of the "
          f"calibration")


MULTI_VIEW_KEYFRAMES = 8


def multi_view_map(device, width: int = 640, height: int = 480):
  """Phase 9's map: 8 keyframes see 8 planes from scattered poses,
  sparsification 4, every keyframe's surfels created with the observation
  filter. Returns (DirectBA, camera, configuration)."""
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.slam.direct_ba import DirectBA
  from badslam_tpu_torch.utils import synthetic
  keyframes = MULTI_VIEW_KEYFRAMES
  cam = synthetic.default_test_camera(width, height)
  config = BadSlamConfig(
      sparse_surfel_cell_size=4,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
      initial_keyframe_capacity=keyframes, max_depth=20.0)
  ba = DirectBA(config, cam, cam, device=device)
  for i, (keyframe, T) in enumerate(synthetic.multi_view_plane_keyframes(
      cam, n_kf=keyframes, n_planes=8, textured=True)):
    ba.add_keyframe(*keyframe, T, i)
  for i in range(keyframes):
    ba.create_surfels_for_keyframe(i, filter_new_surfels=True)
  if ba.surfel_count < 500:
    fail(f"multi-view plane map: only {ba.surfel_count} surfels")
  return ba, cam, config


def calibration_error(calib, true_intr) -> dict:
  return {"intrinsics_px": float((calib.depth_intr - true_intr).abs().max()),
          "a": abs(float(calib.a)),
          "cfactor": float(calib.cfactor.abs().max())}


def check_self_calibration_recovery(device, width: int = 640,
                                    height: int = 480) -> None:
  """Phases 9 and 10: the depth camera, perturbed, is recovered on the
  multi-view plane map by 60 alternated intrinsics steps, and moves toward
  the truth in a joint PCG bundle adjustment."""
  import torch
  from badslam_tpu_torch.models import pcg
  from badslam_tpu_torch.slam.direct_ba import DirectBA
  from badslam_tpu_torch.utils.timing import Timing

  def synchronize():
    if torch.device(device).type == "cuda":
      torch.cuda.synchronize()

  keyframes = MULTI_VIEW_KEYFRAMES
  t0 = time.perf_counter()
  ba, cam, config = multi_view_map(device, width, height)
  surfels, kf, host = ba.to_numpy()
  true_intr = ba.calibration.depth_intr.clone()
  perturbation = torch.tensor(CAMERA_PERTURBATION_PX, device=device)
  print(f"self-calibration map: {width}x{height}, {keyframes} keyframes, "
        f"{ba.surfel_count} surfels of capacity {ba.surfels.capacity}, "
        f"{ba.calibration.cfactor.numel()} cfactor cells, built in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)

  # Phase 9: 60 alternated steps, depth intrinsics only.
  calib = ba.calibration
  calib.depth_intr.add_(perturbation)
  steps = 60
  ba._optimize_intrinsics(True, False)  # warm-up; counts as a step
  synchronize()
  if torch.device(device).type == "cuda":
    torch.cuda.reset_peak_memory_stats()
  t0 = time.perf_counter()
  for _ in range(steps - 1):
    ba._optimize_intrinsics(True, False)
  synchronize()
  step_ms = (time.perf_counter() - t0) * 1e3 / (steps - 1)
  err = calibration_error(calib, true_intr)
  print(f"self-calibration recovery: after {steps} alternated steps from "
        f"{CAMERA_PERTURBATION_PX} px: {json.dumps(err)} (gate: each < "
        f"{RECOVERY_GATE}); {step_ms!r} ms per step")
  if not max(err.values()) < RECOVERY_GATE:
    fail(f"self-calibration recovery: {err}")
  if torch.device(device).type == "cuda":
    print(f"self-calibration recovery peak device memory "
          f"(max_memory_allocated): {torch.cuda.max_memory_allocated()} "
          f"bytes")

  # Phase 10: the joint step, from the same perturbed state.
  calib = calib.clone()
  calib.depth_intr.copy_(true_intr + perturbation)
  calib.a.zero_()
  calib.cfactor.zero_()
  joint = DirectBA.from_numpy(
      dataclasses.replace(config, use_pcg=True), cam, cam, surfels, kf,
      calib, host, device)
  if torch.device(device).type == "cuda":
    torch.cuda.reset_peak_memory_stats()
  before = calibration_error(calib, true_intr)
  synchronize()
  t0 = time.perf_counter()
  with Timing.isolated() as joint_stats:
    outer, _ = joint.bundle_adjustment(
        optimize_depth_intrinsics=True, optimize_color_intrinsics=True,
        do_surfel_updates=False, min_iterations=2, max_iterations=2,
        active_keyframe_window_start=0,
        active_keyframe_window_end=keyframes - 1)
    synchronize()
  joint_ms = (time.perf_counter() - t0) * 1e3
  after = calibration_error(calib, true_intr)
  color_err = float((joint.color_intr - true_intr).abs().max())
  inner = joint_stats["BA PCG inner iterations"].samples
  print(f"joint recovery by PCG: {outer} outer iterations, inner iterations "
        f"per solve {inner}, {joint_ms / outer!r} ms "
        f"per outer iteration; depth camera from {json.dumps(before)} to "
        f"{json.dumps(after)}; color intrinsics (started true) off by "
        f"{color_err!r} px")
  finite = all(bool(torch.isfinite(t).all()) for t in (
      calib.depth_intr, calib.a, calib.cfactor, joint.color_intr,
      joint.kf.global_T_frame, joint.surfels.pos[joint.surfels.valid]))
  if not finite:
    fail("joint recovery by PCG: non-finite values after the step")
  if not after["intrinsics_px"] < before["intrinsics_px"]:
    fail(f"joint recovery by PCG: the depth camera moved away from the "
         f"truth: {before} -> {after}")
  args = (joint.surfels, joint.kf, joint.depth_camera(),
          joint.color_camera(), calib, 0)
  flags = dict(use_depth=True, use_desc=True, opt_dintr=True, opt_cintr=True)
  with Timing.isolated() as solve_stats:
    delta = pcg.pcg_solve(*args, config.pcg_max_inner_iterations, **flags)
  counts = {tag: solve_stats[tag].samples[0] for tag in (
      "BA PCG inner iterations", "BA PCG keyframe passes",
      "BA PCG terms recomputed")}
  residual, scale = pcg.debug_verify_result(delta, *args, **flags)
  residual, scale = float(residual), float(scale)
  print(f"joint recovery by PCG, debug_verify_result on one more solve "
        f"({counts['BA PCG inner iterations']} inner iterations, "
        f"{counts['BA PCG keyframe passes']} passes, terms held "
        f"{counts['BA PCG terms recomputed'] == 0}): largest residual of the "
        f"normal equations {residual!r} at scale {scale!r}")
  if not (np.isfinite(residual) and np.isfinite(scale)):
    fail("joint recovery by PCG: debug_verify_result is not finite")
  if torch.device(device).type == "cuda":
    print(f"joint recovery peak device memory (max_memory_allocated): "
          f"{torch.cuda.max_memory_allocated()} bytes")


def read_depth_intrinsics(base: str) -> np.ndarray:
  with open(base + CALIBRATION_SUFFIXES[0]) as f:
    return np.array([float(v) for v in f.readline().split()[:4]])


def run_self_calibration_path(workdir: str, data: str, use_pcg: bool) -> dict:
  """Phases 11 and 12: the CLI with --optimize_intrinsics, alternating or
  joint; exports poses, map, calibration and state."""
  from badslam_tpu_torch.slam import direct_ba

  label = "joint PCG path" if use_pcg else "self-calibration path"
  tag = "pcg" if use_pcg else "selfcal"
  paths = {name: os.path.join(workdir, f"{tag}_{name}") for name in (
      "poses.txt", "map.ply", "calibration", "state.npz", "stream.txt",
      "timings.txt")}
  argv = [data, "--sequential_ba", "--no_loop_detection",
          "--optimize_intrinsics", "--keyframe_interval",
          str(KEYFRAME_INTERVAL_SELF_CALIBRATION), "--final_ba_iterations",
          "1", "--restrict_fps_to", "0", "--max_depth", "5.0",
          "--num_scales", "5", "--device_accurate_timings",
          "--export_poses", paths["poses.txt"],
          "--export_point_cloud", paths["map.ply"],
          "--export_calibration", paths["calibration"],
          "--save_state", paths["state.npz"],
          "--save_timings", paths["stream.txt"],
          "--export_final_timings", paths["timings.txt"]]
  if use_pcg:
    argv.append("--use_pcg")
  direct_ba.DEBUG_VERIFY_COUNT = True
  try:
    run = run_cli(argv, label)
  finally:
    direct_ba.DEBUG_VERIFY_COUNT = False
  checked = check_map_run(run, label, data, paths["poses.txt"],
                          paths["map.ply"],
                          KEYFRAME_INTERVAL_SELF_CALIBRATION)
  print(f"{label} ATE RMSE {checked['ate']!r} m over {FRAMES} frames (gate "
        f"{ATE_GATE_M} m)")
  stats = run["stats"]
  ran = {phase: stats[phase].count if phase in stats else 0
         for phase in SELF_CALIBRATION_PHASES}
  want_pcg, want_alternated = (True, False) if use_pcg else (False, True)
  if ((ran["BA PCG"] > 0) != want_pcg
      or (ran["BA intrinsics optimization"] > 0) != want_alternated):
    fail(f"{label}: span counts {ran}")
  print_ba_run(run, label,
               ba_iterations_per_call(paths["stream.txt"], label),
               BA_PHASES + SELF_CALIBRATION_PHASES)
  slam = run["slam"]
  ba = slam.direct_ba
  if use_pcg:
    pcg_s = stats["BA PCG"]
    inner = stats["BA PCG inner iterations"].samples
    print(f"{label}: {pcg_s.count} outer iterations, "
          f"{pcg_s.total / pcg_s.count * 1e3!r} ms per outer iteration "
          f"(normal re-estimation included), inner iterations per solve: "
          f"mean {statistics.mean(inner)!r}, min {min(inner)}, max "
          f"{max(inner)}")

  # The exported calibration against the dataset's camera (the files carry
  # the center convention; the camera object the corner convention).
  cam = slam.rgbd_video.depth_camera
  true = np.array([float(cam.fx), float(cam.fy), float(cam.cx) - 0.5,
                   float(cam.cy) - 0.5])
  exported = read_depth_intrinsics(paths["calibration"])
  drift = float(np.abs(exported - true).max())
  gate = CLI_INTRINSICS_GATE_PX["joint" if use_pcg else "alternating"]
  calib = slam.calibration
  print(f"{label}: exported depth intrinsics {exported.tolist()}, "
        f"{drift!r} px from the dataset's camera (gate {gate} px); a "
        f"{float(calib.a)!r}, max |cfactor| "
        f"{float(calib.cfactor.abs().max())!r}")
  if not 0.0 < drift <= gate:
    fail(f"{label}: exported depth intrinsics {drift} px from the camera")
  if not float(calib.cfactor.abs().max()) > 0.0:
    fail(f"{label}: self-calibration left cfactor untouched")
  worst = None
  if not use_pcg:
    # The kernel reads the calibration through its pointers at every launch:
    # hold it against the plain version with the very object this run's
    # optimizer wrote to, on one frame of the run.
    cfg = slam.config
    frame = slam.preprocess_frame(FRAMES // 2)
    worst = compare_kernel(
        f"640x480 frame {FRAMES // 2} with the run's calibration",
        frame.raw_depth, calib,
        dict(sigma_xy=cfg.bilateral_filter_sigma_xy,
             sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
             radius_factor=cfg.bilateral_filter_radius_factor,
             max_depth=cfg.max_depth))
  with open(paths["timings.txt"]) as f:
    print(f.read().rstrip())
  return {"launches": run["launches"], "paths": paths, "max_abs_err": worst,
          "keyframes": checked["keyframes"], "surfels": checked["surfels"]}


def check_round_trip(workdir: str, data: str, saved: dict) -> int:
  """Phase 13: --load_state and --import_calibration of what the
  self-calibration run wrote. Returns the kernel launches of the load."""
  paths = saved["paths"]
  common = [data, "--sequential_ba", "--no_loop_detection",
            "--optimize_intrinsics", "--keyframe_interval",
            str(KEYFRAME_INTERVAL_SELF_CALIBRATION), "--restrict_fps_to", "0",
            "--max_depth", "5.0", "--num_scales", "5",
            "--start_frame", str(FRAMES)]   # past the end: no frame runs
  poses = os.path.join(workdir, "loaded_poses.txt")
  calibration = os.path.join(workdir, "loaded_calibration")
  # One launch per restored keyframe and one for the images of the
  # odometry's base keyframe.
  restored = saved["keyframes"] + 1
  run = run_cli(common + ["--load_state", paths["state.npz"],
                          "--export_poses", poses,
                          "--export_calibration", calibration],
                "state round trip", launches_expected=restored)
  done = re.search(r"Done: 0 frames .* (\d+) keyframes, (\d+) surfels",
                   run["stdout"])
  if not done or (int(done.group(1)), int(done.group(2))) != (
      saved["keyframes"], saved["surfels"]):
    fail(f"state round trip: expected {saved['keyframes']} keyframes and "
         f"{saved['surfels']} surfels after the load")
  run["slam"].direct_ba.debug_verify_counts()
  print(f"state round trip peak device memory (max_memory_allocated): "
        f"{run['peak']} bytes")
  with open(poses) as f, open(paths["poses.txt"]) as g:
    if f.read() != g.read():
      fail("state round trip: the exported poses differ")
  imported = os.path.join(workdir, "imported_calibration")
  run_cli(common + ["--import_calibration", paths["calibration"],
                    "--export_calibration", imported],
          "calibration round trip", launches_expected=0)
  for base, what in ((calibration, "--load_state"),
                     (imported, "--import_calibration")):
    for suffix in CALIBRATION_SUFFIXES:
      with open(base + suffix) as f, open(paths["calibration"] + suffix) as g:
        if f.read() != g.read():
          fail(f"round trip: {suffix} differs after {what}")
  print(f"round trip: --load_state restored {saved['keyframes']} keyframes "
        f"and {saved['surfels']} surfels with {restored} kernel launches and "
        f"exported the same poses; --load_state and --import_calibration "
        f"both export the saved calibration, byte for byte")
  return restored


@contextlib.contextmanager
def detector_timing():
  """Records, per keyframe, the ms from the start of the loop detector's
  feature extraction to the end of its database query (on whichever thread
  runs them), and per add_keyframe call its ms and its event."""
  from badslam_tpu_torch.loop import detector as det_mod
  cls = det_mod.LoopDetector
  extract, detect, add = cls._extract, cls._detect, cls.add_keyframe
  record = {"detect_ms": [], "add": []}
  started = {}

  def timed_extract(self, *args):
    started[threading.get_ident()] = time.perf_counter()
    return extract(self, *args)

  def timed_detect(self, entry):
    out = detect(self, entry)
    t0 = started.pop(threading.get_ident(), None)
    if t0 is not None:
      record["detect_ms"].append((time.perf_counter() - t0) * 1e3)
    return out

  def timed_add(self, *args):
    t0 = time.perf_counter()
    event = add(self, *args)
    record["add"].append(((time.perf_counter() - t0) * 1e3, event))
    return event

  cls._extract, cls._detect, cls.add_keyframe = (timed_extract, timed_detect,
                                                  timed_add)
  try:
    yield record
  finally:
    cls._extract, cls._detect, cls.add_keyframe = extract, detect, add


def run_loop_detection_cli(workdir: str, data: str, ba_path: dict) -> dict:
  """Phase 14: phase 7's command line without --no_loop_detection, so the
  detector runs on its thread."""
  label = "loop detection path"
  poses_path = os.path.join(workdir, "poses_loop.txt")
  argv = ba_path_argv(workdir, data, "loop")
  argv.remove("--no_loop_detection")
  with detector_timing() as timing:
    run = run_verified_cli(argv, label)
  slam = run["slam"]
  detector = slam.loop_detector
  if detector is None or not detector.parallel:
    fail(f"{label}: no loop detector with a thread")
  if detector._detection_thread is not None:
    fail(f"{label}: the detection thread outlived the run")
  found = re.findall(r"Loops closed: (\d+), ignored: (\d+)", run["stdout"])
  if found != [("0", "0")] or detector.events:
    fail(f"{label}: loop events {detector.events}, line {found}")
  with open(poses_path) as f, open(os.path.join(workdir, "poses_ba.txt")) \
      as g:
    if f.read() != g.read():
      fail(f"{label}: the trajectory differs from the run without loop "
           f"detection")
  ms = timing["detect_ms"]
  if len(ms) != len(detector.entries) or not ms:
    fail(f"{label}: {len(ms)} timed detections for "
         f"{len(detector.entries)} entries")
  print(f"{label}: {len(ms)} keyframes through the detection thread, "
        f"extraction to result {statistics.mean(ms)!r} ms per keyframe "
        f"(each {ms}); no loop event; trajectory equal to the run without "
        f"loop detection, byte for byte")
  print(f"{label} warm frames/s (frames 2..{FRAMES - 1}, BA included): "
        f"{warm_frames_per_s(run)!r}; the run without loop detection "
        f"{ba_path['frames_per_s']!r}")
  print_phases(run["stats"], ("Keyframe creation", "Bundle adjustment"),
               {"Keyframe creation": 1})
  return {"launches": run["launches"], "detect_ms": ms}


def checker_plane_video(trajectory, width: int = 640, height: int = 480):
  from badslam_tpu_torch.utils import synthetic
  cam = synthetic.default_test_camera(width, height)
  t0 = time.perf_counter()
  video = synthetic.make_synthetic_video(
      cam, trajectory, synthetic.plane_world_normals(),
      texture_kind="checker")
  print(f"rendered {len(trajectory)} frames of the checker plane world at "
        f"{width}x{height} in {time.perf_counter() - t0:.1f} s", flush=True)
  return cam, video


def twist_trajectory(n: int, step) -> list:
  import torch
  from badslam_tpu_torch.geometry import se3
  step = np.asarray(step, np.float32)
  return [se3.exp(torch.from_numpy(i * step)).numpy() for i in range(n)]


LOOP_SCENE = dict(
    keyframe_interval=2, num_scales=3, max_depth=5.0,
    sparse_surfel_cell_size=2,
    min_observation_count_while_bootstrapping_1=1,
    min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
    initial_keyframe_capacity=8, initial_surfel_capacity=1 << 14,
    parallel_ba=False)


def check_config2(device) -> dict:
  """Phase 15: config2's drifted-map closure at 640x480."""
  import torch
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.loop import detector as det_mod
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.slam.system import BadSlam
  label = "config2 closure"
  traj = twist_trajectory(10, [0.003, 0.001, 0, 0.0008, 0, 0])
  traj.append(traj[0].copy())
  cam, video = checker_plane_video(traj)
  cfg = BadSlamConfig(**LOOP_SCENE)
  graphs = []
  optimizer_cls = det_mod.PoseGraphOptimizer

  class RecordingGraph(optimizer_cls):
    def optimize(self, num_iterations: int = 20):
      graphs.append(self)
      return super().optimize(num_iterations)

  det_mod.PoseGraphOptimizer = RecordingGraph
  try:
    detector = det_mod.LoopDetector(cfg, cam, recent_exclude=2)
    slam = BadSlam(cfg, video, device=device, loop_detector=detector)
    fp.fused_depth_preprocess.launches = 0
    with detector_timing() as timing:
      for i in range(10):
        slam.process_frame(i)
      poses = slam.direct_ba.kf.global_T_frame.cpu().numpy().copy()
      drift = 0.08
      for s_, d in ((3, 0.06), (4, drift)):
        poses[s_][0, 3] += d
      slam.direct_ba.kf = slam.direct_ba.kf._replace(
          global_T_frame=torch.from_numpy(poses).to(device))
      slam.base_kf_global_T_frame = poses[4]
      slam.process_frame(10, force_keyframe=True)
      torch.cuda.synchronize()
    launches = fp.fused_depth_preprocess.launches
  finally:
    det_mod.PoseGraphOptimizer = optimizer_cls
  if launches != len(traj):
    fail(f"{label}: fused_depth_preprocess launched {launches} times, "
         f"expected {len(traj)}")
  event = detector.events[-1] if detector.events else None
  err = float(np.linalg.norm(video.frames[10].global_T_frame[:3, 3]
                             - traj[10][:3, 3]))
  print(f"{label}: events {detector.events}; revisit error {err!r} m "
        f"(gate {0.25 * drift} m, a quarter of the {drift} m drift)")
  if not (event and event.applied and event.matched_slot == 0
          and err < 0.25 * drift):
    fail(f"{label}: not closed onto keyframe 0 within the gate")
  close_ms = [ms for ms, ev in timing["add"] if ev is event][0]
  graph = graphs[-1]
  times = []
  for _ in range(5):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.optimize()
    times.append((time.perf_counter() - t0) * 1e3)
  profile = profile_device(graph.optimize)
  print(f"{label}: {event.inlier_count} RANSAC inliers; the closing "
        f"add_keyframe call {close_ms!r} ms; the pose-graph solve alone "
        f"({len(graph.T0)} vertices, {len(graph.edges_i)} edges, 20 LM "
        f"steps) {statistics.median(times)!r} ms, median of 5 (each "
        f"{times}); detector, extraction to result "
        f"{statistics.mean(timing['detect_ms'])!r} ms per keyframe")
  print(f"{label}: one pose-graph solve under torch.profiler: "
        f"{profile['launches']} kernel launches ({profile['launches'] / 20!r}"
        f" per LM step), {profile['syncs']} synchronizing calls, device busy "
        f"{profile['busy_ms']!r} ms of {profile['wall_ms']!r} ms")
  return {"launches": launches}


def profile_device(fn, warm: bool = True) -> dict:
  """Kernel launches (host cu*LaunchKernel* calls), synchronizing CUDA
  calls and device-busy ms (the union of the device's kernel, copy and set
  intervals) of one call of ``fn`` under torch.profiler, after one call
  outside it unless ``fn`` ran warm already (``warm`` False)."""
  import torch
  if warm:
    fn()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  t0 = time.perf_counter()
  with torch.profiler.profile(activities=activities) as prof:
    fn()
    torch.cuda.synchronize()
  wall_ms = (time.perf_counter() - t0) * 1e3
  events = prof.events()
  launches = sum(1 for e in events
                 if "LaunchKernel" in e.name and e.name.startswith("cu"))
  names = sync_names(events)
  syncs = sum(names.values())
  spans = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
  busy, end = 0.0, float("-inf")
  for s_, e_ in spans:
    if e_ > end:
      busy += e_ - max(s_, end)
      end = e_
  return {"launches": launches, "syncs": syncs, "busy_ms": busy / 1e3,
          "wall_ms": wall_ms, "sync_names": names}


def sync_names(events) -> dict:
  """Synchronizing CUDA calls among profiler events, by name and count."""
  names = {}
  for e in events:
    if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                  "cudaMemcpy", "cudaEventSynchronize"):
      names[e.name] = names.get(e.name, 0) + 1
  return names


def check_bow_blackout(device) -> dict:
  """Phase 16: the BoW-scale blackout at 640x480."""
  import torch
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.loop.detector import LoopDetector
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.slam.system import WEAK_EDGE_WEIGHT, BadSlam
  label = "BoW-scale blackout"
  away = 70
  traj = twist_trajectory(away, [0.0022, 0.0008, 0, 0.0006, 0, 0])
  near0 = se3.exp(torch.tensor([0.004, 0.001, 0, 0, 0, 0])).numpy() @ traj[0]
  traj += [near0, near0, traj[0].copy()]
  cam, video = checker_plane_video(traj)
  cfg = BadSlamConfig(**dict(LOOP_SCENE,
                             max_num_ba_iterations_per_keyframe=0))

  class BlackoutSlam(BadSlam):
    def _tracking_failure_injected(self, frame_index):
      return 40 <= frame_index < 56

  detector = LoopDetector(cfg, cam)
  slam = BlackoutSlam(cfg, video, device=device, loop_detector=detector)
  fp.fused_depth_preprocess.launches = 0
  t0 = time.perf_counter()
  with detector_timing() as timing:
    for i in range(away + 3):
      slam.process_frame(i, force_keyframe=(i in (away, away + 2)))
    torch.cuda.synchronize()
  seconds = time.perf_counter() - t0
  launches = fp.fused_depth_preprocess.launches
  if launches != len(traj):
    fail(f"{label}: fused_depth_preprocess launched {launches} times, "
         f"expected {len(traj)}")
  applied = [e for e in detector.events if e.applied]
  weak = sorted(s for s, w in slam.keyframe_edge_weight.items()
                if w == WEAK_EDGE_WEIGHT)
  err = float(np.linalg.norm(video.frames[away + 2].global_T_frame[:3, 3]
                             - traj[-1][:3, 3]))
  print(f"{label}: {slam.direct_ba.keyframe_count} keyframes in "
        f"{seconds:.1f} s; vocabulary "
        f"{'active' if detector.vocab is not None else 'NOT active'}"
        f" ({detector.vocab.num_words if detector.vocab else 0} words); "
        f"{len(applied)} closures applied, {detector.num_loops_ignored} "
        f"ignored; weak edges into keyframes {weak}; revisit error {err!r} m "
        f"(gate 0.02 m)")
  print(f"{label}: events "
        f"{[(e.current_slot, e.matched_slot, e.inlier_count, e.reason) for e in detector.events]}")
  if not (detector.vocab is not None and applied and weak and err < 0.02):
    fail(f"{label}: gates not met")
  closing = [ms for ms, ev in timing["add"] if ev is not None and ev.applied]
  other = [ms for ms, ev in timing["add"] if ev is None]
  print(f"{label}: detector, extraction to result "
        f"{statistics.mean(timing['detect_ms'])!r} ms per keyframe (max "
        f"{max(timing['detect_ms'])!r}); add_keyframe "
        f"{statistics.mean(closing)!r} ms per applied closure, "
        f"{statistics.mean(other)!r} ms where no candidate came up")
  return {"launches": launches, "frames": len(traj)}


def bare_argv(workdir: str, data: str, tag: str) -> list:
  """The reference CLI's bare defaults (BA on its thread, loop detection on
  its thread, playback paced to 30 FPS), exporting into files named by
  ``tag``."""
  return [data,
          "--export_poses", os.path.join(workdir, f"poses_{tag}.txt"),
          "--export_point_cloud", os.path.join(workdir, f"map_{tag}.ply"),
          "--export_final_timings", os.path.join(workdir,
                                                 f"timings_{tag}.txt")]


@contextlib.contextmanager
def ba_thread_record():
  """Counts, over one run, the calibrations the BA thread published and the
  snapshots the front-end took, and records the two streams'
  priorities."""
  from badslam_tpu_torch.slam import system
  cls = system.BadSlam
  publish, take = cls._publish_calibration, cls._frame_calibration
  record = {"published": 0, "taken": 0, "priorities": None}

  def counted_publish(self):
    record["published"] += 1
    return publish(self)

  def counted_take(self):
    before = self._front_calibration
    out = take(self)
    if self._parallel and before is not None and out is not before:
      record["taken"] += 1
    if self._main_stream is not None:
      record["priorities"] = (self._main_stream.priority,
                              self._ba_stream.priority)
    return out

  cls._publish_calibration, cls._frame_calibration = (counted_publish,
                                                      counted_take)
  try:
    yield record
  finally:
    cls._publish_calibration, cls._frame_calibration = publish, take


def wall_seconds(stdout: str, label: str) -> float:
  """The CLI's own 'Done: N frames in X s' (the BA thread's drain at the
  end included)."""
  done = re.search(r"Done: \d+ frames in ([0-9.]+) s", stdout)
  if not done:
    fail(f"{label}: no Done line")
  return float(done.group(1))


def check_threaded_run(run: dict, record: dict, label: str) -> dict:
  """What a run with the BA thread must show: no sequential BA call, BA
  iterations on the thread, the two streams at their priorities, both
  threads gone, and the loops line."""
  stats = run["stats"]
  slam = run["slam"]
  thread_iterations = (stats["BA thread iteration"].count
                       if "BA thread iteration" in stats else 0)
  if "Bundle adjustment" in stats or thread_iterations < 1:
    fail(f"{label}: BA thread iterations {thread_iterations}, sequential "
         f"BA calls {stats.get('Bundle adjustment')}")
  if record["priorities"] is None or not (
      record["priorities"][0] < record["priorities"][1]):
    fail(f"{label}: stream priorities (main, BA) {record['priorities']}")
  if slam._ba_thread is not None or (
      slam.loop_detector is None or slam.loop_detector._detection_thread
      is not None):
    fail(f"{label}: a thread outlived the run, or no loop detector")
  found = re.findall(r"Loops closed: (\d+), ignored: (\d+)", run["stdout"])
  if found != [("0", "0")]:
    fail(f"{label}: loops line {found}")
  s = stats["BA thread iteration"]
  print(f"{label}: {thread_iterations} BA thread iterations, mean "
        f"{s.total / s.count * 1e3!r} ms each (host wall time on the BA "
        f"thread); stream priorities (main, BA) {record['priorities']}; "
        f"loops line {found[0]}")
  return {"thread_iterations": thread_iterations}


# Phase 17's runs: one of each (the script's length; phase 36 runs phase
# 7's line four times in the same call).
DEFAULTS_TURNS = ("sequential", "defaults")


def run_defaults_path(workdir: str, data: str, ba_path: dict) -> dict:
  """Phase 17: the bare defaults against --sequential_ba, the same flags
  otherwise, in DEFAULTS_TURNS."""
  out = {"launches": 0, "frames": 0,
         "fps": {"defaults": [], "sequential": []},
         "wall_s": {"defaults": [], "sequential": []}}
  for turn, name in enumerate(DEFAULTS_TURNS):
    label = f"{name} run {turn + 1}"
    tag = f"{name}{turn}"
    argv = bare_argv(workdir, data, tag)
    if name == "sequential":
      argv.append("--sequential_ba")
    with ba_thread_record() as record:
      run = run_cli(argv, label)
    checked = check_map_run(
        run, label, data, os.path.join(workdir, f"poses_{tag}.txt"),
        os.path.join(workdir, f"map_{tag}.ply"), KEYFRAME_INTERVAL_BA)
    if name == "defaults":
      check_threaded_run(run, record, label)
      if not checked["ate"] <= ATE_FORMULA_640_M:
        fail(f"{label}: ATE {checked['ate']} m > {ATE_FORMULA_640_M} m")
    fps = warm_frames_per_s(run)
    wall = wall_seconds(run["stdout"], label)
    out["fps"][name].append(fps)
    out["wall_s"][name].append(wall)
    out["launches"] += run["launches"]
    out["frames"] += FRAMES
    print(f"{label}: ATE RMSE {checked['ate']!r} m (gate "
          f"{ATE_FORMULA_640_M!r} m for the defaults), warm frames/s "
          f"{fps!r}, the CLI's wall time for {FRAMES} frames {wall!r} s, "
          f"peak device memory {run['peak']} bytes")
    print_phases(run["stats"], ("Preprocessing", "Odometry",
                                "Keyframe creation", "Bundle adjustment",
                                "BA thread iteration"),
                 {"Preprocessing": 2, "Odometry": 2, "Keyframe creation": 1},
                 how="host wall time, no device barriers")
    del run
  print(f"defaults against --sequential_ba, warm frames/s in turns: "
        f"defaults {out['fps']['defaults']}, sequential "
        f"{out['fps']['sequential']}; wall s: defaults "
        f"{out['wall_s']['defaults']}, sequential "
        f"{out['wall_s']['sequential']}; phase 7 (device-accurate timings) "
        f"{ba_path['frames_per_s']!r}")
  return out


def run_threaded_self_calibration(workdir: str, data: str) -> dict:
  """Phase 18: the defaults with --optimize_intrinsics --keyframe_interval
  5: self-calibration on the BA thread, its calibration handed to the
  front-end's stream."""
  label = "threaded self-calibration"
  calibration = os.path.join(workdir, "threaded_calibration")
  argv = bare_argv(workdir, data, "threaded_selfcal") + [
      "--optimize_intrinsics", "--keyframe_interval",
      str(KEYFRAME_INTERVAL_SELF_CALIBRATION), "--export_calibration",
      calibration]
  with ba_thread_record() as record:
    run = run_cli(argv, label)
  checked = check_map_run(
      run, label, data, os.path.join(workdir, "poses_threaded_selfcal.txt"),
      os.path.join(workdir, "map_threaded_selfcal.ply"),
      KEYFRAME_INTERVAL_SELF_CALIBRATION)
  check_threaded_run(run, record, label)
  slam = run["slam"]
  cam = slam.rgbd_video.depth_camera
  true = np.array([float(cam.fx), float(cam.fy), float(cam.cx) - 0.5,
                   float(cam.cy) - 0.5])
  drift = float(np.abs(read_depth_intrinsics(calibration) - true).max())
  gate = CLI_INTRINSICS_GATE_PX["alternating"]
  print(f"{label}: ATE RMSE {checked['ate']!r} m; {record['published']} "
        f"calibrations published by the BA thread, {record['taken']} taken "
        f"by the front-end at a frame's start; exported depth intrinsics "
        f"{drift!r} px from the dataset's camera (gate {gate} px); max "
        f"|cfactor| {float(slam.calibration.cfactor.abs().max())!r}; warm "
        f"frames/s {warm_frames_per_s(run)!r}")
  if record["published"] < 1 or not 0.0 < drift <= gate:
    fail(f"{label}: {record['published']} publications, intrinsics "
         f"{drift} px from the camera")
  device, launches = slam.device, run["launches"]
  del run, slam
  return {"launches": launches + run_handoff(data, device),
          "published": record["published"],
          "taken": record["taken"]}


def run_handoff(data: str, device) -> int:
  """Phase 18's second half: the hand-off in a fixed order, off the CLI.
  BadSlam with the defaults and --optimize_intrinsics, 11 frames quiesced
  after each (2 keyframes), then one BA-thread iteration with
  self-calibration, and one more frame: that frame's preprocessing and
  odometry, on the main stream, read the BA thread's new calibration, and
  the kernel's outputs equal the plain version's with it. Returns the
  kernel's launches."""
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.slam.system import BadSlam
  label = "calibration hand-off"
  args = port_main.build_parser().parse_args([data, "--optimize_intrinsics"])
  config = port_main.config_from_args(args)
  video = dataset_io.load_tum_dataset(
      data, None, raw_to_float_depth=config.raw_to_float_depth)
  slam = BadSlam(config, video, device=device)
  frames = []
  preprocess = slam.preprocess_frame

  def kept(*args, **kwargs):
    frames.append(preprocess(*args, **kwargs))
    return frames[-1]

  slam.preprocess_frame = kept
  n = KEYFRAME_INTERVAL_BA + 1
  fp.fused_depth_preprocess.launches = 0
  try:
    for i in range(n):
      slam.process_frame(i)
      slam.quiesce()
    before = slam.calibration.depth_intr.clone()
    slam.start_parallel_iterations(1, True, True)
    slam.quiesce()
    slam.process_frame(n)
  finally:
    slam.stop_ba_thread_and_wait()
  launches = fp.fused_depth_preprocess.launches
  calib = slam.calibration
  moved = float((calib.depth_intr - before).abs().max())
  front = slam._front_calibration
  if (launches != n + 1 or front is calib or moved <= 0.0
      or not torch.equal(front.depth_intr, calib.depth_intr)
      or not torch.equal(front.cfactor, calib.cfactor)):
    fail(f"{label}: launches {launches}, depth intrinsics moved {moved}, "
         f"the front-end's snapshot is the BA object: {front is calib}")
  cfg = slam.config
  frame = frames[-1]
  want = fp.fused_depth_preprocess_reference(
      frame.raw_depth, calib, sigma_xy=cfg.bilateral_filter_sigma_xy,
      sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
      radius_factor=cfg.bilateral_filter_radius_factor,
      max_depth=cfg.max_depth)
  err = max(float((g - w).abs().max()) for g, w in zip(
      (frame.depth, frame.normals, frame.radius_sq), want))
  print(f"{label}: one BA-thread intrinsics step moved the depth "
        f"intrinsics by {moved!r} px; frame {n}, on the main stream, read "
        f"the published snapshot; its kernel outputs against the plain "
        f"version with the BA thread's calibration: max_abs_err {err!r}")
  if err != 0.0:
    fail(f"{label}: the frame did not compute with the new calibration")
  return launches


def run_input_paths(workdir: str, data: str, frames: int) -> dict:
  """Phases 19-21: one run each with the pyramid-level inputs, the median
  filter and the dense reconstruction export, over the first ``frames``
  frames with the defaults; the kernel held once more against its plain
  version on a half-resolution frame with the run's calibration."""
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.utils import synthetic
  _, gt = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  out = {"launches": 0, "max_abs_err": 0.0}
  cases = (("pyramid level 1", ["--pyramid_level_for_depth", "1",
                                "--pyramid_level_for_color", "1"]),
           ("median filter", ["--median_filter_and_densify_iterations",
                              "1"]),
           # With BA on its thread the scheme counter never advances, so
           # the export's BA creates no surfel (in the JAX package too:
           # ROADMAP queue 3, R10); it densifies after sequential BA.
           ("reconstruction export", [
               "--sequential_ba", "--export_reconstruction",
               os.path.join(workdir, "dense.ply")]))
  for label, flags in cases:
    tag = label.split()[0]
    argv = bare_argv(workdir, data, tag) + flags + [
        "--end_frame", str(frames - 1)]
    run = run_cli(argv, label, launches_expected=frames)
    out["launches"] += run["launches"]
    _, est = read_tum_trajectory(os.path.join(workdir, f"poses_{tag}.txt"))
    if est.shape != (frames, 4, 4) or not np.isfinite(est).all():
      fail(f"{label}: trajectory {est.shape}")
    ate = ate_rmse(est[:, :3, 3].astype(np.float64),
                   gt[:frames, :3, 3].astype(np.float64))
    pos, _, _ = ply.load_point_cloud_ply(
        os.path.join(workdir, f"map_{tag}.ply"))
    err = synthetic.surfel_map_error(pos)["median_abs_m"]
    line = (f"{label}: {frames} frames, ATE RMSE {ate!r} m (gate "
            f"{ATE_GATE_M} m), {len(pos)} surfels, map median |error| "
            f"{err!r} m (gate {MAP_MEDIAN_GATE_M} m)")
    if not ate <= ATE_GATE_M or not err < MAP_MEDIAN_GATE_M:
      fail(line)
    slam = run["slam"]
    if tag == "pyramid":
      if slam.direct_ba.depth_size != (320, 240):
        fail(f"{label}: depth size {slam.direct_ba.depth_size}")
      cfg = slam.config
      frame = slam.preprocess_frame(frames // 2)
      out["max_abs_err"] = max(out["max_abs_err"], compare_kernel(
          f"320x240 pyramid-level frame {frames // 2} with the run's "
          f"calibration", frame.raw_depth, slam.calibration,
          dict(sigma_xy=cfg.bilateral_filter_sigma_xy,
               sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
               radius_factor=cfg.bilateral_filter_radius_factor,
               max_depth=cfg.max_depth)))
    if tag == "reconstruction":
      dense, _, _ = ply.load_point_cloud_ply(os.path.join(workdir,
                                                          "dense.ply"))
      dense_err = synthetic.surfel_map_error(dense)["median_abs_m"]
      line += (f"; reconstruction at cell 1: {len(dense)} surfels, median "
               f"|error| {dense_err!r} m")
      if (not len(dense) > 2 * len(pos) or not np.isfinite(dense).all()
          or not dense_err < MAP_MEDIAN_GATE_M
          or slam.direct_ba.calibration is not slam.calibration):
        fail(line)
    print(line)
    del run, slam
  return out


def compare_prefetch(workdir: str, data: str) -> dict:
  """Phase 22: the odometry-only run (phase 5's flags) over the first
  INPUT_PATH_FRAMES frames without and then with the frame prefetcher: the
  "Preprocessing" phase's warm mean."""
  from badslam_tpu_torch.io import dataset as dataset_io
  argv = [data, "--keyframe_interval", "5", "--num_scales", "5",
          "--max_depth", "5.0", "--max_num_ba_iterations_per_keyframe", "0",
          "--no_loop_detection", "--sequential_ba", "--restrict_fps_to", "0",
          "--device_accurate_timings", "--quiet",
          "--end_frame", str(INPUT_PATH_FRAMES - 1)]
  enable = dataset_io.RGBDVideo.enable_prefetch
  ms = {"without": [], "with": []}
  fps = {"without": [], "with": []}
  launches = 0
  for name in ("without", "with"):
    if name == "without":
      dataset_io.RGBDVideo.enable_prefetch = lambda self, **kwargs: False
    try:
      run = run_cli(argv, f"odometry-only {name} prefetcher",
                    launches_expected=INPUT_PATH_FRAMES)
    finally:
      dataset_io.RGBDVideo.enable_prefetch = enable
    launches += run["launches"]
    warm = run["stats"]["Preprocessing"].samples[2:]
    ms[name].append(statistics.mean(warm) * 1e3)
    fps[name].append(warm_frames_per_s(run))
    del run
  print(f"Preprocessing warm mean ms, odometry-only: without the "
        f"prefetcher {ms['without']}, with it {ms['with']} (page-locked, "
        f"non-blocking copies); warm frames/s without {fps['without']}, "
        f"with {fps['with']}")
  return {"launches": launches, "ms": ms}



# --- the pipelined front-end (phases 24-27) ---

# Phases 24 and 26 in turns: the same command line with --sequential_ba,
# with --pipelined_frontend, and with --pipelined_concurrent_ba added, two
# runs each, in an order that balances drift.
PIPELINED_TURNS = ("sequential", "pipelined", "concurrent", "concurrent",
                   "pipelined", "sequential")
PROFILED_FRAMES = (10, 11, 12)   # a keyframe and the two frames after it
# Phase 25's runs under the sync guard: three keyframes, BA from the
# second on (the CLI runs of 24 and 26 cover all 51 frames).
GUARDED_FRAMES = 21


def pipelined_argv(workdir: str, data: str, tag: str, mode: str) -> list:
  """Phase 7's command line without device-accurate timings and without the
  BA iteration stream (its surfel count is a read of the map), with
  --sequential_ba, or with --pipelined_frontend in its place (``mode``
  "pipelined"), plus --pipelined_concurrent_ba ("concurrent")."""
  argv = ba_path_argv(workdir, data, tag)
  argv.remove("--device_accurate_timings")
  i = argv.index("--save_timings")
  del argv[i:i + 2]
  if mode != "sequential":
    argv.remove("--sequential_ba")
    argv.append("--pipelined_frontend")
  if mode == "concurrent":
    argv.append("--pipelined_concurrent_ba")
  return argv


def pl_thread_report(slam, stats, label: str) -> dict:
  """The pipelined BA thread's iterations (run, dropped by the backlog cap),
  the two streams' priorities, and whether both threads stopped."""
  iterations = (stats["BA thread iteration"].count
                if "BA thread iteration" in stats else 0)
  priorities = None
  if slam._main_stream is not None:
    priorities = (slam._main_stream.priority, slam._ba_stream.priority)
  alive = [t.name for t in threading.enumerate()
           if t.name == "pl_ba_thread" and t.is_alive()]
  stopped = slam._pl_ba_thread is None and not alive
  print(f"{label}: {iterations} BA thread iterations, "
        f"{slam.pl_ba_dropped} dropped by the backlog cap, stream "
        f"priorities (main, BA) {priorities}, both threads stopped "
        f"{stopped}")
  if (iterations < 1 or "Bundle adjustment" in stats or not stopped
      or priorities is None or not priorities[0] < priorities[1]):
    fail(f"{label}: BA thread iterations {iterations}, inline BA "
         f"{stats.get('Bundle adjustment')}, priorities {priorities}, "
         f"stopped {stopped}")
  return {"iterations": iterations, "dropped": slam.pl_ba_dropped,
          "priorities": priorities}


def run_pipelined_cli(workdir: str, data: str) -> dict:
  """Phases 24 and 26 (the CLI): --sequential_ba, --pipelined_frontend and
  --pipelined_frontend --pipelined_concurrent_ba in turns, each with the
  gates of 7 (ATE, map, keyframes, PLY) and one launch per frame."""
  out = {"launches": 0, "frames": 0}
  for mode in ("sequential", "pipelined", "concurrent"):
    out[mode] = {"fps": [], "wall_s": []}
  for turn, mode in enumerate(PIPELINED_TURNS):
    label = f"{mode} CLI run {turn + 1}"
    tag = f"pl_{mode}{turn}"
    run = run_cli(pipelined_argv(workdir, data, tag, mode), label)
    checked = check_map_run(
        run, label, data, os.path.join(workdir, f"poses_{tag}.txt"),
        os.path.join(workdir, f"map_{tag}.ply"), KEYFRAME_INTERVAL_BA)
    stats = run["stats"]
    if mode == "concurrent":
      pl_thread_report(run["slam"], stats, label)
    elif mode == "pipelined":
      calls = (stats["Bundle adjustment"].count
               if "Bundle adjustment" in stats else 0)
      print(f"{label}: {calls} inline transfer-free BA iterations")
      if calls < 1:
        fail(f"{label}: no BA iteration ran")
    fps = warm_frames_per_s(run)
    wall = wall_seconds(run["stdout"], label)
    out[mode]["fps"].append(fps)
    out[mode]["wall_s"].append(wall)
    out["launches"] += run["launches"]
    out["frames"] += FRAMES
    print(f"{label}: ATE RMSE {checked['ate']!r} m (gate {ATE_GATE_M} m; "
          f"the formula's 640x480 value {ATE_FORMULA_640_M!r} m), warm "
          f"frames/s {fps!r}, the CLI's wall time for {FRAMES} frames "
          f"{wall!r} s, {checked['keyframes']} keyframes, "
          f"{run['launches']} kernel launches, peak device memory "
          f"{run['peak']} bytes")
    print_phases(stats, ("Preprocessing", "Odometry", "Keyframe creation",
                         "Bundle adjustment", "BA thread iteration"),
                 {"Preprocessing": 2, "Odometry": 2, "Keyframe creation": 1},
                 how="host wall time, no device barriers")
    del run
  print("pipelined front-ends against --sequential_ba, warm frames/s in "
        "turns: " + "; ".join(f"{m} {out[m]['fps']}" for m in
                              ("sequential", "pipelined", "concurrent"))
        + "; wall s: " + "; ".join(f"{m} {out[m]['wall_s']}" for m in
                                   ("sequential", "pipelined", "concurrent")))
  return out


@contextlib.contextmanager
def gn_iteration_count():
  """Counts the odometry's Gauss-Newton iterations launched (each evaluates
  its convergence test once)."""
  from badslam_tpu_torch.models import odometry
  real = odometry.is_scale_n_converged
  count = [0]

  def counted(*args, **kwargs):
    count[0] += 1
    return real(*args, **kwargs)

  odometry.is_scale_n_converged = counted
  try:
    yield count
  finally:
    odometry.is_scale_n_converged = real


def in_process_system(workdir: str, data: str, mode: str, device,
                      extra: tuple = (), mesh=None):
  """A BadSlam built as the CLI builds it from ``mode``'s command line
  (plus the flags ``extra``): the same configuration, the dataset with the
  page-locked prefetcher; over ``mesh`` if one is given."""
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.slam.system import BadSlam
  args = port_main.build_parser().parse_args(
      pipelined_argv(workdir, data, f"in_{mode}", mode) + list(extra))
  config = port_main.config_from_args(args)
  video = dataset_io.load_tum_dataset(
      data, None, raw_to_float_depth=config.raw_to_float_depth)
  video.enable_prefetch(pin_memory=True)
  return BadSlam(config, video, device=device, mesh=mesh), video


PROFILED_SPAN = "profiled frames"


def profile_frames(slam, video, frames, label: str) -> dict:
  """Launches, synchronizing calls and device-busy ms per frame over
  ``frames`` under torch.profiler (as tools/profile_slice.py counts them),
  after the frames before them ran unprofiled. Launches and synchronizing
  calls are counted inside the span that holds the profiled frames (the
  synchronize that closes the window, and any of the profiler's own, lie
  outside it and are listed apart). The kernel's launches are counted over
  every frame, and must be one per frame."""
  import torch
  from badslam_tpu_torch.ops import fused_preprocess as fp
  fp.fused_depth_preprocess.launches = 0
  for i in range(frames[0]):
    slam.process_frame(i)
    video.frames[i].clear_cache()
  torch.cuda.synchronize()
  activities = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
  with gn_iteration_count() as gn:
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=activities) as prof:
      with torch.profiler.record_function(PROFILED_SPAN):
        for i in frames:
          slam.process_frame(i)
          video.frames[i].clear_cache()
      torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
  kernel_launches = fp.fused_depth_preprocess.launches
  if kernel_launches != frames[-1] + 1:
    fail(f"{label}: fused_depth_preprocess launched {kernel_launches} times "
         f"in {frames[-1] + 1} frames")
  events = prof.events()
  cpu = torch.autograd.DeviceType.CPU
  spans = [e for e in events
           if e.name == PROFILED_SPAN and e.device_type == cpu]
  if len(spans) != 1:
    fail(f"{label}: {len(spans)} spans named {PROFILED_SPAN!r}")
  start, end = spans[0].time_range.start, spans[0].time_range.end
  inside = [e for e in events if e.device_type == cpu
            and start <= e.time_range.start and e.time_range.end <= end]
  outside = [e for e in events if e.device_type == cpu
             and not (start <= e.time_range.start
                      and e.time_range.end <= end)]
  launches = sum(1 for e in inside
                 if "LaunchKernel" in e.name and e.name.startswith("cu"))
  names = sync_names(inside)
  # The span's own device-side annotation covers the idle gaps too.
  device = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.name != PROFILED_SPAN)
  busy, last = 0.0, float("-inf")
  for s_, e_ in device:
    if e_ > last:
      busy += e_ - max(s_, last)
      last = e_
  n = len(frames)
  return {"launches": launches / n, "syncs": sum(names.values()) / n,
          "busy_ms": busy / 1e3 / n, "wall_ms": wall_ms / n,
          "busy_share": busy / 1e3 / wall_ms, "gn": gn[0] / n,
          "sync_names": names, "outside": sync_names(outside),
          "kernel_launches": kernel_launches}


def guarded_run(slam, video, data: str, label: str,
                frames: int = FRAMES) -> dict:
  """The first ``frames`` frames of the dataset through ``slam`` under
  torch.cuda.set_sync_debug_mode("error"), from the first process_frame
  to the last (the BA thread's iterations included); then the stop and
  finalize_pipelined, outside. Returns the loop's host seconds, the
  GN iterations, the kernel's launches and the trajectory's ATE."""
  import torch
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.ops import fused_preprocess as fp
  torch.cuda.synchronize()
  fp.fused_depth_preprocess.launches = 0
  with gn_iteration_count() as gn:
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
      for i in range(frames):
        slam.process_frame(i)
        video.frames[i].clear_cache()
      slam._drain_pl_ba()
    except RuntimeError as e:
      fail(f"{label}: a synchronizing call inside the guarded loop: {e}")
    finally:
      torch.cuda.set_sync_debug_mode(0)
    loop_s = time.perf_counter() - t0
  launches = fp.fused_depth_preprocess.launches
  slam.stop_ba_thread_and_wait()
  slam.finalize_pipelined()
  torch.cuda.synchronize()
  total_s = time.perf_counter() - t0
  if launches != frames:
    fail(f"{label}: fused_depth_preprocess launched {launches} times, "
         f"expected {frames}")
  _, gt = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  est = np.stack([f.global_T_frame for f in video.frames[:frames]])
  if not np.isfinite(est).all():
    fail(f"{label}: non-finite poses")
  ate = ate_rmse(est[:, :3, 3].astype(np.float64),
                 gt[:frames, :3, 3].astype(np.float64))
  if not ate <= ATE_GATE_M:
    fail(f"{label}: ATE {ate} m > {ATE_GATE_M} m")
  return {"loop_s": loop_s, "total_s": total_s, "gn": gn[0],
          "launches": launches, "ate": ate}


def check_run_frame_kernel(slam, label: str) -> float:
  """The kernel against its plain version on one frame of a run, with the
  calibration the run ended with: the error must be 0.0."""
  cfg = slam.config
  frame = slam.preprocess_frame(FRAMES // 2)
  err = compare_kernel(
      f"{label}: 640x480 frame {FRAMES // 2}", frame.raw_depth,
      slam.calibration,
      dict(sigma_xy=cfg.bilateral_filter_sigma_xy,
           sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
           radius_factor=cfg.bilateral_filter_radius_factor,
           max_depth=cfg.max_depth))
  if err != 0.0:
    fail(f"{label}: the kernel differs from its plain version by {err}")
  return err


def run_pipelined_in_process(workdir: str, data: str, device,
                             pl_cli: dict) -> dict:
  """Phases 25 and 26 (in process): GUARDED_FRAMES frames through BadSlam
  under the sync guard, inline and with the BA thread; the ATE and map
  gates; the
  kernel on one frame of the inline run; and torch.profiler over three warm
  frames of the host front-end and of each pipelined one. The profiler
  slows the host, so the device-busy share of a warm frame without it is
  derived from two runs: the profiled device-busy ms per frame over the
  mean warm ms per frame of the same mode's CLI runs in ``pl_cli``."""
  import torch
  from badslam_tpu_torch.utils import synthetic
  from badslam_tpu_torch.utils.timing import Timing
  out = {"launches": 0, "frames": 0, "max_abs_err": 0.0}
  for mode in ("pipelined", "concurrent"):
    label = f"{mode} in process under the sync guard"
    Timing.reset()
    slam, video = in_process_system(workdir, data, mode, device)
    try:
      run = guarded_run(slam, video, data, label, frames=GUARDED_FRAMES)
    finally:
      slam.stop_ba_thread_and_wait()
      video.close_prefetch()
    pos, _, _ = slam.direct_ba.export_point_cloud()
    err = synthetic.surfel_map_error(pos)
    if not err["median_abs_m"] < MAP_MEDIAN_GATE_M:
      fail(f"{label}: map median |error| {err['median_abs_m']} m")
    out["launches"] += run["launches"]
    out["frames"] += GUARDED_FRAMES
    print(f"{label}: no synchronizing call in {GUARDED_FRAMES} frames; the "
          f"loop "
          f"{run['loop_s']!r} s on the host, {run['total_s']!r} s to the "
          f"finalized trajectory; ATE RMSE {run['ate']!r} m (gate "
          f"{ATE_GATE_M} m); map median |error| {err['median_abs_m']!r} m; "
          f"{run['gn'] / (GUARDED_FRAMES - 1)!r} GN iterations launched per "
          f"tracked "
          f"frame; {slam.direct_ba.keyframe_count} keyframes, "
          f"{slam.direct_ba.surfel_count} live surfels")
    if mode == "concurrent":
      pl_thread_report(slam, Timing.stats(), label)
    else:
      out["max_abs_err"] = check_run_frame_kernel(slam, label)
    del slam, video
    gc.collect()

  for mode in ("sequential", "pipelined", "concurrent"):
    label = f"{mode} front-end, frames {PROFILED_FRAMES} profiled"
    slam, video = in_process_system(workdir, data, mode, device)
    try:
      prof = profile_frames(slam, video, PROFILED_FRAMES, label)
    finally:
      slam.stop_ba_thread_and_wait()
      video.close_prefetch()
    out["launches"] += prof["kernel_launches"]
    out["frames"] += PROFILED_FRAMES[-1] + 1
    cli_ms = 1e3 / statistics.mean(pl_cli[mode]["fps"])
    prof["derived_share"] = prof["busy_ms"] / cli_ms
    print(f"{label}: per frame {prof['launches']!r} kernel launches, "
          f"{prof['syncs']!r} synchronizing calls ({prof['sync_names']}; "
          f"outside the frames' span, in the whole window: "
          f"{prof['outside']}), {prof['gn']!r} GN iterations, device busy "
          f"{prof['busy_ms']!r} ms of {prof['wall_ms']!r} ms "
          f"({prof['busy_share'] * 100!r}% under the profiler, which slows "
          f"the host); derived: {prof['busy_ms']!r} ms over the CLI runs' "
          f"mean warm {cli_ms!r} ms per frame = "
          f"{prof['derived_share'] * 100!r}%; fused_depth_preprocess "
          f"launched {prof['kernel_launches']} times in "
          f"{PROFILED_FRAMES[-1] + 1} frames")
    out[mode] = prof
    del slam, video
    gc.collect()
  torch.cuda.synchronize()
  return out


# Phase 28: self-calibration under the pipelined front-end, the intrinsics
# step acting from the tenth keyframe. Per run: mode, joint PCG, frames,
# keyframe interval. The joint run takes a keyframe every frame (12
# frames, 12 keyframes, intrinsics from frame 9); the BA thread's run 25
# frames with a keyframe every second one (13 keyframes, intrinsics from
# frame 18), so that frames follow the thread's published calibrations.
PL_CALIBRATION_RUNS = (("pipelined", True, 12, 1),
                       ("concurrent", False, 25, 2))


def run_pipelined_self_calibration(workdir: str, data: str, device) -> dict:
  """Phase 28: --optimize_intrinsics with --pipelined_frontend, in process
  under the sync guard (PL_CALIBRATION_RUNS): the joint PCG solve inline
  (the depth intrinsics among its unknowns), and the alternated step on
  the BA thread, which hands the front-end each calibration it writes.
  Gates: no synchronizing call, the ATE, the step ran and moved the
  cameras, the front-end took a published calibration, one kernel launch
  per frame."""
  from badslam_tpu_torch.utils.timing import Timing
  out = {"launches": 0, "frames": 0}
  for mode, pcg, n, interval in PL_CALIBRATION_RUNS:
    label = (f"{mode} self-calibration "
             f"({'joint PCG' if pcg else 'alternated'}, {n} frames) under "
             f"the sync guard")
    Timing.reset()
    slam, video = in_process_system(
        workdir, data, mode, device,
        ("--optimize_intrinsics", "--keyframe_interval", str(interval))
        + (("--use_pcg",) if pcg else ()))
    initial = np.array([[float(c.fx), float(c.fy), float(c.cx), float(c.cy)]
                        for c in (video.depth_camera, video.color_camera)],
                       np.float32)
    try:
      run = guarded_run(slam, video, data, label, frames=n)
    finally:
      slam.stop_ba_thread_and_wait()
      video.close_prefetch()
    stats = Timing.stats()
    step = "BA PCG" if pcg else "BA intrinsics optimization"
    steps = stats[step].count if step in stats else 0
    ba = slam.direct_ba
    depth = ba.calibration.depth_intr.cpu().numpy()
    color = ba.color_intr.cpu().numpy()
    moved = float(np.abs(np.stack([depth, color]) - initial).max())
    front = None
    if mode == "concurrent":
      pl_thread_report(slam, stats, label)
      front = slam._front_calibration.depth_intr.cpu().numpy()
    print(f"{label}: no synchronizing call in {n} frames; the loop "
          f"{run['loop_s']!r} s on the host; ATE RMSE {run['ate']!r} m "
          f"(gate {ATE_GATE_M} m); {steps} '{step}' spans; depth intrinsics "
          f"{depth.tolist()}, color {color.tolist()} (from "
          f"{initial.tolist()}: {moved!r} px at most), a "
          f"{float(ba.calibration.a)!r}; the front-end's last depth "
          f"intrinsics {None if front is None else front.tolist()}; "
          f"{ba.keyframe_count} keyframes, surfel store capacity "
          f"{ba.surfels.capacity}")
    print_phases(stats, ("Odometry", "Bundle adjustment",
                         "BA thread iteration", step, "BA surfel creation",
                         "BA geometry optimization", "BA pose optimization"),
                 {}, how="host wall time, no device barriers")
    if steps < 1 or not moved > 1e-3:
      fail(f"{label}: the intrinsics step ran {steps} times and moved the "
           f"cameras {moved} px")
    if front is not None and not np.abs(front - initial[0]).max() > 0:
      fail(f"{label}: the front-end never took a published calibration")
    out["launches"] += run["launches"]
    out["frames"] += n
    del slam, video
    gc.collect()
  return out


def pin_frames(video) -> None:
  """Page-locked copies of in-memory frames, as the CLI's prefetcher
  makes them, so that their uploads do not block the host."""
  import torch
  for f in video.frames:
    f._pinned = (torch.from_numpy(f.rgb()).pin_memory(),
                 torch.from_numpy(f.depth_raw().view(np.int16)).pin_memory())


def check_device_closure(device) -> dict:
  """Phase 27: tests/test_pipelined.py's drifted map at 640x480 with the
  pipelined front-end: 10 frames, 0.06 m and 0.08 m of drift put into the
  device poses of keyframes 3 and 4, then the revisit of frame 0 under the
  sync guard."""
  import torch
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.loop import device_closure
  from badslam_tpu_torch.loop.detector import LoopDetector
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.slam.system import BadSlam
  label = "device closure"
  traj = twist_trajectory(10, [0.003, 0.001, 0, 0.0008, 0, 0])
  traj.append(traj[0].copy())
  cam, video = checker_plane_video(traj)
  pin_frames(video)
  cfg = BadSlamConfig(**dict(LOOP_SCENE, pipelined_frontend=True,
                             enable_loop_detection=True))
  detector = LoopDetector(cfg, cam, recent_exclude=2)
  slam = BadSlam(cfg, video, device=device, loop_detector=detector)
  calls = []
  real = device_closure.verify_and_close

  def recording(*args):
    calls.append(args)
    return real(*args)

  device_closure.verify_and_close = recording
  fp.fused_depth_preprocess.launches = 0
  try:
    for i in range(10):
      slam.process_frame(i)
    poses = slam.direct_ba.kf.global_T_frame.cpu().numpy().copy()
    drift = 0.08
    for s_, d in ((3, 0.06), (4, drift)):
      poses[s_][0, 3] += d
    slam.direct_ba.kf = slam.direct_ba.kf._replace(
        global_T_frame=torch.from_numpy(poses).to(device))
    torch.cuda.synchronize()
    before = len(calls)
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
      slam.process_frame(10, force_keyframe=True)
    except RuntimeError as e:
      fail(f"{label}: a synchronizing call in the closing frame: {e}")
    finally:
      torch.cuda.set_sync_debug_mode(0)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    device_ms = (time.perf_counter() - t0) * 1e3
    pending = detector.events[-1].reason if detector.events else None
    slam.finalize_pipelined()
  finally:
    device_closure.verify_and_close = real
  launches = fp.fused_depth_preprocess.launches
  if launches != len(traj):
    fail(f"{label}: fused_depth_preprocess launched {launches} times, "
         f"expected {len(traj)}")
  event = detector.events[-1] if detector.events else None
  err = float(np.linalg.norm(video.frames[10].global_T_frame[:3, 3]
                             - traj[10][:3, 3]))
  print(f"{label}: events {detector.events}; the closing event read "
        f"{pending!r} before finalize; revisit error {err!r} m (gate 0.04 m "
        f"of the {drift} m drift)")
  if not (pending == "device-pending" and event and event.applied
          and event.matched_slot == 0 and err < 0.04
          and len(calls) == before + 1):
    fail(f"{label}: not closed onto keyframe 0 within the gate")
  prof = profile_device(lambda: real(*calls[-1]), warm=False)
  print(f"{label}: the closing frame {host_ms!r} ms on the host, "
        f"{device_ms!r} ms to its device work's end; the closure program "
        f"alone under torch.profiler: {prof['launches']} kernel launches, "
        f"{prof['syncs']} synchronizing calls (with the window's closing "
        f"one and one of the profiler's own: {prof['sync_names']}), device "
        f"busy "
        f"{prof['busy_ms']!r} ms of {prof['wall_ms']!r} ms")
  return {"launches": launches, "frames": len(traj)}


# --- the rest of the library (phases 29-31) ---

# Phase 30's gates, the card's render of a map against the port's own CPU
# render of it (tests/test_torch_render.py): the hit masks differ in at most
# this share of the pixels, and where both hit, depth by at most this (a
# splat edge that moves by one ulp of a projected coordinate can hand a
# pixel to a neighbouring surfel, ~1.7 cm away at 1 m with this camera's
# 4-pixel cells, on a surface whose slope reaches ~0.5).
RENDER_FLIP_GATE = 1e-3
RENDER_DEPTH_GATE_M = 1e-2
# Phase 30's seeded cloud: 2M surfels, 31 chunks of 65,536.
SEEDED_SURFELS = 2_000_000
KERNEL_NAME = "fused_depth_preprocess_kernel"


def render_cost(fn) -> dict:
  """Device ms of one call of ``fn`` (CUDA events, median of 20 after 3
  warm-up calls) and its kernel launches (torch.profiler)."""
  return {"ms": cuda_median_ms(fn, runs=20),
          "launches": profile_device(fn)["launches"]}


def run_previews_and_trace(workdir: str, data: str) -> dict:
  """Phase 29: the bare defaults over INPUT_PATH_FRAMES frames with
  --render_preview and --profile_dir."""
  from badslam_tpu_torch import render
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.utils import synthetic
  label = "previews and trace"
  frames = INPUT_PATH_FRAMES
  previews = os.path.join(workdir, "previews")
  trace_dir = os.path.join(workdir, "trace")
  argv = bare_argv(workdir, data, "render") + [
      "--end_frame", str(frames - 1), "--render_preview", previews,
      "--profile_dir", trace_dir]
  run = run_cli(argv, label, launches_expected=frames)
  _, gt = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  _, est = read_tum_trajectory(os.path.join(workdir, "poses_render.txt"))
  if est.shape != (frames, 4, 4) or not np.isfinite(est).all():
    fail(f"{label}: trajectory {est.shape}")
  ate = ate_rmse(est[:, :3, 3].astype(np.float64),
                 gt[:frames, :3, 3].astype(np.float64))
  pos, _, _ = ply.load_point_cloud_ply(os.path.join(workdir,
                                                    "map_render.ply"))
  err = synthetic.surfel_map_error(pos)["median_abs_m"]
  line = (f"{label}: {frames} frames, ATE RMSE {ate!r} m (gate "
          f"{ATE_GATE_M} m), {len(pos)} surfels, map median |error| {err!r} "
          f"m (gate {MAP_MEDIAN_GATE_M} m)")
  if not ate <= ATE_GATE_M or not err < MAP_MEDIAN_GATE_M:
    fail(line)
  print(line)

  # One preview pair per keyframe, its depth on the heightmap seen from the
  # keyframe's exported pose.
  slam = run["slam"]
  ba = slam.direct_ba
  slots = np.flatnonzero(ba.kf.valid.cpu().numpy())
  kf_frames = ba.kf.frame_index.cpu().numpy()[slots]
  want = sorted(f"kf_{f:06d}_{k}.png" for f in kf_frames
                for k in ("color", "depth"))
  if sorted(os.listdir(previews)) != want:
    fail(f"{label}: previews {sorted(os.listdir(previews))}, expected {want}")
  from PIL import Image
  cam = slam.rgbd_video.depth_camera
  size = (cam.height, cam.width)
  medians = []
  for f in kf_frames:
    color = np.asarray(Image.open(os.path.join(previews,
                                               f"kf_{f:06d}_color.png")))
    raw = np.asarray(Image.open(os.path.join(previews,
                                             f"kf_{f:06d}_depth.png")))
    if color.shape != size + (3,) or raw.shape != size \
        or raw.dtype != np.uint16:
      fail(f"{label}: preview of frame {f}: {color.shape}, {raw.shape} "
           f"{raw.dtype}")
    truth, _ = synthetic.render_heightmap(cam, est[f])
    hit = (raw > 0) & (truth > 0)
    medians.append(float(np.median(np.abs(raw[hit] / 5000.0 - truth[hit]))))
    if not hit.mean() > 0.5 or not medians[-1] < MAP_MEDIAN_GATE_M:
      fail(f"{label}: frame {f}'s depth preview: {hit.mean()!r} of the "
           f"pixels hit, median |error| {medians[-1]!r} m")
  print(f"{label}: {len(kf_frames)} keyframe previews at {cam.width}x"
        f"{cam.height}, depth "
        f"median |error| against the heightmap from the exported pose "
        f"{medians} m (gate {MAP_MEDIAN_GATE_M} m)")

  # The trace.
  m = re.search(r"Wrote profiler trace (\S+) \((\d+) bytes in ([\d.]+) "
                r"s\)", run["stdout"])
  if not m:
    fail(f"{label}: no profiler trace line in the CLI's output")
  import gzip
  t0 = time.perf_counter()
  with gzip.open(m.group(1), "rt") as f:
    events = json.load(f)["traceEvents"]
  read_s = time.perf_counter() - t0
  kernels = [e for e in events if e.get("cat") == "kernel"]
  ours = sum(KERNEL_NAME in e.get("name", "") for e in kernels)
  recorded = {e.get("args", {}).get("correlation") for e in kernels}
  unmatched = sum(1 for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "LaunchKernel" in e.get("name", "")
                  and e.get("args", {}).get("correlation") not in recorded)
  cpu_threads = {e.get("tid") for e in events if e.get("cat") == "cpu_op"}
  streams = {e.get("tid") for e in kernels}
  print(f"{label}: trace {m.group(1)}: {m.group(2)} bytes, written in "
        f"{m.group(3)} s (read back in {read_s:.1f} s), {len(events)} "
        f"events, {len(kernels)} kernels on {len(streams)} streams "
        f"({unmatched} launches without a kernel record), {ours} of them "
        f"{KERNEL_NAME}; CPU ops of {len(cpu_threads)} threads")
  if ours != frames:
    fail(f"{label}: the trace holds {ours} launches of {KERNEL_NAME}, "
         f"expected {frames}")

  # The render itself, from the first keyframe's viewpoint.
  f_T_g = se3.inverse(ba.kf.global_T_frame[int(slots[0])])
  colors = render.surfel_display_colors(ba.surfels, "color")
  splats = lambda: render.render_surfel_splats(
      ba.surfels.pos, colors, ba.surfels.valid, f_T_g, ba.color_intr, *size)
  cost = render_cost(splats)
  t0 = time.perf_counter()
  for _ in range(5):
    render.render_map(ba, f_T_g)
  map_ms = (time.perf_counter() - t0) / 5 * 1e3
  print(f"{label}: render of {ba.surfels.capacity} surfel slots "
        f"({ba.surfel_count} live) at {cam.width}x{cam.height}: "
        f"{cost['ms']!r} ms per "
        f"viewpoint on the device (CUDA events), {cost['launches']} kernel "
        f"launches; render_map with its host copies {map_ms!r} ms")
  return {"launches": run["launches"], "frames": frames, "slam": slam,
          "slot": int(slots[0]), "render_ms": cost["ms"],
          "render_launches": cost["launches"]}


def check_render_on_card(previewed: dict, device) -> dict:
  """Phase 30: the card's render of phase 29's map against the port's CPU
  render of it, from every keyframe's viewpoint; then a seeded cloud of
  SEEDED_SURFELS surfels at 640x480."""
  import torch
  from badslam_tpu_torch import render
  from badslam_tpu_torch.geometry import se3
  ba = previewed["slam"].direct_ba
  s = ba.surfels
  colors = render.surfel_display_colors(s, "normals")
  slots = np.flatnonzero(ba.kf.valid.cpu().numpy())
  width, height = ba.color_size
  flips, depth_diff, depth_pixels = 0, 0.0, 0
  for k in slots:
    f_T_g = se3.inverse(ba.kf.global_T_frame[int(k)])
    gpu = [t.cpu() for t in render.render_surfel_splats(
        s.pos, colors, s.valid, f_T_g, ba.color_intr, height, width)]
    cpu = render.render_surfel_splats(
        s.pos.cpu(), colors.cpu(), s.valid.cpu(), f_T_g.cpu(),
        ba.color_intr.cpu(), height, width)
    flips += int((gpu[2] != cpu[2]).sum())
    both = gpu[2] & cpu[2]
    diff = (gpu[0] - cpu[0]).abs()[both]
    depth_pixels += int((diff > 0).sum())
    depth_diff = max(depth_diff, float(diff.max()))
  pixels = len(slots) * height * width
  line = (f"card against CPU render of phase 29's map from {len(slots)} "
          f"viewpoints: {flips} hit-mask flips of {pixels} pixels (gate "
          f"{RENDER_FLIP_GATE * pixels:.0f}), depth differs at {depth_pixels} "
          f"pixels where both hit, by at most {depth_diff!r} m (gate "
          f"{RENDER_DEPTH_GATE_M} m)")
  if flips > RENDER_FLIP_GATE * pixels or depth_diff > RENDER_DEPTH_GATE_M:
    fail(line)
  print(line)

  g = torch.Generator(device=device).manual_seed(29)
  n = SEEDED_SURFELS
  pos = torch.stack([torch.rand(n, generator=g, device=device) * 3.0 - 1.5,
                     torch.rand(n, generator=g, device=device) * 2.4 - 1.2,
                     torch.rand(n, generator=g, device=device) * 3.7 + 0.3],
                    dim=-1)
  col = torch.rand((n, 3), generator=g, device=device)
  valid = torch.ones(n, dtype=torch.bool, device=device)
  T = torch.eye(4, device=device)
  intr = torch.tensor([240.0, 240.0, 319.5, 239.5], device=device)
  splats = lambda: render.render_surfel_splats(pos, col, valid, T, intr, 480,
                                               640)
  hit = splats()[2]
  torch.cuda.synchronize()
  torch.cuda.reset_peak_memory_stats()
  base = torch.cuda.memory_allocated()
  cost = render_cost(splats)
  peak = torch.cuda.max_memory_allocated()
  chunks = -(-n // render._RENDER_CHUNK)
  print(f"seeded cloud of {n} surfels ({chunks} chunks) at 640x480: "
        f"{cost['ms']!r} ms per viewpoint (CUDA events), {cost['launches']} "
        f"kernel launches, {float(hit.float().mean())!r} of the pixels hit; "
        f"peak device memory {peak} bytes, {peak - base} above the inputs")
  return {"flips": flips, "depth_diff": depth_diff, "cloud_ms": cost["ms"],
          "cloud_launches": cost["launches"], "cloud_peak": peak}


def check_inspector(workdir: str, saved: dict) -> None:
  """Phase 31: the snapshot inspector on phase 11's saved state."""
  from badslam_tpu_torch import snapshot_inspector
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  label = "snapshot inspector"
  out_dir = os.path.join(workdir, "inspected")
  cloud = os.path.join(workdir, "inspected.ply")
  poses = os.path.join(workdir, "inspected_poses.txt")
  out = io.StringIO()
  t0 = time.perf_counter()
  with contextlib.redirect_stdout(out):
    rc = snapshot_inspector.main([
        saved["paths"]["state.npz"], "--render", out_dir,
        "--export_point_cloud", cloud, "--export_poses", poses])
  seconds = time.perf_counter() - t0
  print(out.getvalue().rstrip())
  if rc != 0:
    fail(f"{label}: returned {rc}")
  pos, _, _ = ply.load_point_cloud_ply(cloud)
  _, inspected = read_tum_trajectory(poses)
  _, exported = read_tum_trajectory(saved["paths"]["poses.txt"])
  names = os.listdir(out_dir)
  if (len(pos) != saved["surfels"] or inspected.shape != (FRAMES, 4, 4)
      or not np.array_equal(inspected, exported)
      or len(names) != 2 * saved["keyframes"]):
    fail(f"{label}: {len(pos)} surfels (saved {saved['surfels']}), poses "
         f"{inspected.shape} equal to phase 11's: "
         f"{np.array_equal(inspected, exported)}, {len(names)} previews for "
         f"{saved['keyframes']} keyframes")
  print(f"{label}: {len(pos)} surfels and {FRAMES} poses exported, equal to "
        f"phase 11's; {len(names) // 2} keyframe previews; {seconds:.1f} s")


# --- distribution (phases 32-35) ---

# Phase 32's meshes: 8 shards, and 2 x 4 (kf x surfels), over the one card;
# phases 33-34: 4 shards.
MESH_SHARDS = 4
# Phase 34's runs: the first 21 frames; the state is saved after 14.
MESH_SAVE_FRAMES = 14
# A mesh run's trajectory against the one-device run's (metres, positions),
# and its live surfels within 1% + 16 of the one-device run's.
MESH_TRAJECTORY_GATE_M = 1e-4


def virtual_mesh(device, shape, axes):
  """A mesh whose every position is ``device``."""
  from badslam_tpu_torch.parallel.spmd import Mesh
  devices = np.empty(int(np.prod(shape)), dtype=object)
  for i in range(devices.size):
    devices[i] = device
  return Mesh(devices.reshape(shape), axes)


def surfels_agree(count: int, reference: int) -> bool:
  return abs(count - reference) <= 0.01 * reference + 16


def step_cost(fn, profiled: bool) -> dict:
  """Wall ms of one call of ``fn``, from the host's first launch to the
  device's end (the caller ran it once before), and, where ``profiled``,
  its kernel launches under torch.profiler."""
  import torch
  torch.cuda.synchronize()
  t0 = time.perf_counter()
  fn()
  torch.cuda.synchronize()
  ms = (time.perf_counter() - t0) * 1e3
  launches = (profile_device(fn, warm=False)["launches"] if profiled
              else "not profiled")
  return {"ms": ms, "launches": launches}


def check_sharded_steps(device) -> None:
  """Phase 32: the four sharded steps of parallel/sharded_ba.py on virtual
  meshes over the card, on phase 9's map, against the one-device steps."""
  import torch
  from badslam_tpu_torch.models import geometry_opt, pcg, pose_opt
  from badslam_tpu_torch.parallel import sharded_ba, spmd
  from badslam_tpu_torch.parallel.sharded_ba import KF_AXIS, SURFEL_AXIS
  t0 = time.perf_counter()
  ba, cam, config = multi_view_map(device)
  ba.kf = ba.kf._replace(
      activation=torch.where(ba.kf.valid, 2, 0).to(torch.int32))
  ba.surfels = ba.surfels._replace(active=ba.surfels.valid)
  s, kf, c = ba.surfels, ba.kf, ba.calibration
  params = (c.a, c.cfactor, c.baseline_fx)
  cell = config.sparse_surfel_cell_size
  mesh1 = virtual_mesh(device, (8,), (SURFEL_AXIS,))
  mesh2 = virtual_mesh(device, (2, 4), (KF_AXIS, SURFEL_AXIS))
  s1 = sharded_ba.shard_surfels(s, mesh1)
  s2 = sharded_ba.shard_surfels_2d(s, mesh2)
  kf2 = sharded_ba.shard_keyframes_2d(kf, mesh2)
  print(f"sharded steps: phase 9's map at {cam.width}x{cam.height}, "
        f"{ba.keyframe_count} keyframes, {ba.surfel_count} surfels of "
        f"capacity {s.capacity}, on a virtual 8-shard mesh and a 2 x 4 mesh "
        f"over {device}; built in {time.perf_counter() - t0:.1f} s",
        flush=True)

  def single_iteration(max_pose_iterations):
    s_ref = geometry_opt.optimize_geometry_iteration(s, kf, cam, cam, c)
    optimize = kf.valid & (kf.activation != 0)
    T, _ = pose_opt.estimate_frame_poses_batched(
        kf.global_T_frame, optimize, s_ref, kf.depth, kf.normals,
        kf.intensity, cam, cam, c, max_iterations=max_pose_iterations)
    return {"positions": s_ref.pos, "poses": T}

  def single_pcg(intrinsics):
    delta = pcg.pcg_solve(s, kf, cam, cam, c, 0, 15, opt_dintr=intrinsics,
                          opt_cintr=intrinsics)
    s_out, kf_out = pcg.apply_pcg_delta(s, kf, delta)
    out = {"positions": s_out.pos, "poses": kf_out.global_T_frame}
    if intrinsics:
      di, ci, _, _ = pcg.apply_pcg_delta_intrinsics(
          c.depth_intr, ba.color_intr, c.a, c.cfactor, delta, True, True)
      out.update(depth_intr=di, color_intr=ci)
    return out

  def fields(out):
    got = {"positions": spmd.gather(out[0].pos),
           "poses": spmd.gather(out[1].global_T_frame)}
    if len(out) == 7:
      got.update(depth_intr=out[2], color_intr=out[3])
    return got

  # Ten pose GN iterations in both iterations: the launches repeat per
  # shard, and the profiled call of each step must stay short.
  it1 = sharded_ba.make_sharded_ba_iteration(mesh1, cam, cam, cell,
                                             max_pose_iterations=10)
  it2 = sharded_ba.make_sharded_ba_iteration_2d(mesh2, cam, cam, cell,
                                                max_pose_iterations=10)
  pcg1 = sharded_ba.make_sharded_pcg_step(mesh1, cam, cam, cell,
                                          max_inner_iterations=15)
  pcg1i = sharded_ba.make_sharded_pcg_step(
      mesh1, cam, cam, cell, max_inner_iterations=15, opt_dintr=True,
      opt_cintr=True)
  # The launches are counted under torch.profiler for one step, the PCG
  # step on 8 shards, the cheapest: the profiler takes ~0.1-0.25 ms per
  # launch, and the sharded steps launch 80,000-180,000 kernels.
  cases = (
      ("1-D iteration, 8 shards", lambda: it1(s1, kf, *params),
       lambda: single_iteration(10), {"positions": 1e-5, "poses": 1e-4},
       False),
      ("2-D iteration, 2 x 4", lambda: it2(s2, kf2, *params),
       lambda: single_iteration(10), {"positions": 1e-4, "poses": 2e-4},
       False),
      ("PCG step, 8 shards", lambda: pcg1(s1, kf, *params, 0),
       lambda: single_pcg(False), {"positions": 2e-3, "poses": 2e-4}, True),
      ("PCG step with the intrinsics unknowns, 8 shards",
       lambda: pcg1i(s1, kf, *params, 0), lambda: single_pcg(True),
       {"positions": 2e-3, "poses": 2e-4, "depth_intr": 1e-3,
        "color_intr": 1e-3}, False))
  for label, sharded, single, tolerances, profiled in cases:
    got, want = fields(sharded()), single()
    errors = {k: float((got[k] - want[k]).abs().max()) for k in tolerances}
    spmd.reset_collective_stats()
    cost = step_cost(sharded, profiled)
    stats = spmd.collective_stats()
    per_step = {k: v / (2 if profiled else 1) for k, v in stats.items()}
    single_cost = step_cost(single, profiled)
    line = (f"sharded {label}: largest difference from the one-device "
            f"step {errors} (tolerances {tolerances}); {cost['ms']!r} ms "
            f"and {cost['launches']} kernel launches per step on the mesh, "
            f"{single_cost['ms']!r} ms and {single_cost['launches']} "
            f"launches on one device; {per_step['collectives']!r} "
            f"collectives reducing {per_step['bytes']!r} bytes of partials "
            f"per step")
    if not all(errors[k] <= tolerances[k] for k in tolerances):
      fail(line)
    print(line, flush=True)


def run_mesh_ba_path(workdir: str, data: str, ba_path: dict,
                     device) -> dict:
  """Phase 33: phase 7's command line in process over a MESH_SHARDS-shard
  virtual mesh over the card, then two BA runs over it from one state."""
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.parallel import spmd
  from badslam_tpu_torch.parallel.sharded_ba import SURFEL_AXIS
  label = f"{MESH_SHARDS}-shard mesh BA path"
  mesh = virtual_mesh(device, (MESH_SHARDS,), (SURFEL_AXIS,))
  poses_path = os.path.join(workdir, "poses_mesh.txt")
  spmd.reset_collective_stats()
  run = run_cli(ba_path_argv(workdir, data, "mesh"), label, mesh=mesh)
  collectives = spmd.collective_stats()
  checked = check_map_run(run, label, data, poses_path,
                          os.path.join(workdir, "map_mesh.ply"),
                          KEYFRAME_INTERVAL_BA)
  _, est = read_tum_trajectory(poses_path)
  _, ref = read_tum_trajectory(ba_path["poses"])
  diff = float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max())
  iterations = ba_iterations_per_call(
      os.path.join(workdir, "iterations_mesh.txt"), label)
  stats = run["stats"]
  ba_ms = sum(stats["Bundle adjustment"].samples) * 1e3
  ba = run["slam"].direct_ba
  gather = stats.get("Mesh surfel gather")
  line = (f"{label}: trajectory within {diff!r} m of phase 7's (gate "
          f"{MESH_TRAJECTORY_GATE_M} m); ATE RMSE {checked['ate']!r} m; "
          f"{checked['surfels']} live surfels against phase 7's "
          f"{ba_path['surfels']} (gate 1% + 16); warm frames/s "
          f"{warm_frames_per_s(run)!r} against phase 7's "
          f"{ba_path['frames_per_s']!r}; {ba_ms / sum(iterations)!r} ms per "
          f"BA iteration against phase 7's "
          f"{ba_path['ms_per_iteration']!r} (BA iterations per call "
          f"{iterations}); {ba.mesh_gathers} gathers of the store moved "
          f"{ba.mesh_gather_bytes} bytes in "
          f"{0.0 if gather is None else gather.total * 1e3!r} ms; "
          f"{collectives['collectives']} collectives reduced "
          f"{collectives['bytes']} bytes of partials; peak device memory "
          f"{run['peak']} bytes against phase 7's {ba_path['peak']}")
  if (not diff <= MESH_TRAJECTORY_GATE_M
      or not surfels_agree(checked["surfels"], ba_path["surfels"])):
    fail(line)
  print(line, flush=True)
  print_phases(stats, BA_PHASES + ("Mesh surfel gather",
                                   "Mesh surfel sharding"), {})
  launches = run["launches"]
  del run, ba
  gc.collect()
  check_ba_determinism(data, device, mesh=mesh)
  return {"launches": launches, "frames": FRAMES}


def check_partial_run(workdir: str, data: str, tag: str, frames: int,
                      label: str) -> dict:
  """The trajectory (ATE) and map (median |error|) gates of a run over the
  first ``frames`` frames that exported into files named by ``tag``."""
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  from badslam_tpu_torch.utils import synthetic
  _, gt = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  _, est = read_tum_trajectory(os.path.join(workdir, f"poses_{tag}.txt"))
  if est.shape != (frames, 4, 4) or not np.isfinite(est).all():
    fail(f"{label}: trajectory {est.shape}")
  ate = ate_rmse(est[:, :3, 3].astype(np.float64),
                 gt[:frames, :3, 3].astype(np.float64))
  pos, _, _ = ply.load_point_cloud_ply(os.path.join(workdir,
                                                    f"map_{tag}.ply"))
  err = synthetic.surfel_map_error(pos)["median_abs_m"]
  line = (f"{label}: {frames} frames, ATE RMSE {ate!r} m (gate "
          f"{ATE_GATE_M} m), {len(pos)} surfels, map median |error| {err!r} "
          f"m (gate {MAP_MEDIAN_GATE_M} m)")
  if not ate <= ATE_GATE_M or not err < MAP_MEDIAN_GATE_M:
    fail(line)
  print(line, flush=True)
  return {"poses": est, "surfels": len(pos)}


def run_mesh_paths(workdir: str, data: str, device) -> dict:
  """Phase 34: over INPUT_PATH_FRAMES frames on a MESH_SHARDS-shard virtual
  mesh: the bare defaults (BA and detection threads), the pipelined
  front-end in process under the sync guard, and a state saved on the mesh
  resumed on one device and the reverse."""
  from badslam_tpu_torch.parallel.sharded_ba import SURFEL_AXIS
  from badslam_tpu_torch.utils import synthetic
  mesh = virtual_mesh(device, (MESH_SHARDS,), (SURFEL_AXIS,))
  frames = INPUT_PATH_FRAMES
  out = {"launches": 0, "frames": 0, "restored": 0}

  label = "bare defaults on the mesh"
  argv = bare_argv(workdir, data, "mesh_defaults") + [
      "--end_frame", str(frames - 1)]
  with ba_thread_record() as record:
    run = run_cli(argv, label, launches_expected=frames, mesh=mesh)
  check_threaded_run(run, record, label)
  check_partial_run(workdir, data, "mesh_defaults", frames, label)
  print(f"{label}: warm frames/s {warm_frames_per_s(run)!r}, the CLI's "
        f"wall time {wall_seconds(run['stdout'], label)!r} s, peak device "
        f"memory {run['peak']} bytes", flush=True)
  out["launches"] += run["launches"]
  out["frames"] += frames
  del run
  gc.collect()

  label = "pipelined front-end on the mesh under the sync guard"
  slam, video = in_process_system(workdir, data, "pipelined", device,
                                  mesh=mesh)
  try:
    run = guarded_run(slam, video, data, label, frames=frames)
  finally:
    slam.stop_ba_thread_and_wait()
    video.close_prefetch()
  pos, _, _ = slam.direct_ba.export_point_cloud()
  err = synthetic.surfel_map_error(pos)["median_abs_m"]
  line = (f"{label}: no synchronizing call in {frames} frames; the loop "
          f"{run['loop_s']!r} s on the host; ATE RMSE {run['ate']!r} m (gate "
          f"{ATE_GATE_M} m); map median |error| {err!r} m (gate "
          f"{MAP_MEDIAN_GATE_M} m); {slam.direct_ba.mesh_gathers} gathers "
          f"of {slam.direct_ba.mesh_gather_bytes} bytes")
  if not err < MAP_MEDIAN_GATE_M:
    fail(line)
  print(line, flush=True)
  out["launches"] += run["launches"]
  out["frames"] += frames
  del slam, video
  gc.collect()

  # Save after MESH_SAVE_FRAMES frames, resume for the rest: mesh to one
  # device and one device to the mesh.
  common = [data, "--sequential_ba", "--no_loop_detection",
            "--restrict_fps_to", "0", "--max_depth", "5.0",
            "--num_scales", "5"]
  saved = {}
  for name, saver in (("mesh", mesh), ("single", None)):
    state = os.path.join(workdir, f"state_{name}.npz")
    run = run_cli(common + ["--end_frame", str(MESH_SAVE_FRAMES - 1),
                            "--save_state", state],
                  f"state saved on {'the mesh' if saver else 'one device'}",
                  launches_expected=MESH_SAVE_FRAMES, mesh=saver)
    done = re.search(r"Done: \d+ frames .* (\d+) keyframes, (\d+) surfels",
                     run["stdout"])
    saved[name] = (state, int(done.group(1)))
    out["launches"] += run["launches"]
    out["frames"] += MESH_SAVE_FRAMES
    del run
  resumed = {}
  for name, loader, tag in (("mesh", None, "mesh_to_single"),
                            ("single", mesh, "single_to_mesh")):
    state, keyframes = saved[name]
    label = tag.replace("_", " ")
    # One launch per restored keyframe, one for the odometry's base
    # keyframe, one per frame after the resume.
    expected = keyframes + 1 + frames - MESH_SAVE_FRAMES
    run = run_cli(common + [
        "--load_state", state, "--start_frame", str(MESH_SAVE_FRAMES),
        "--end_frame", str(frames - 1),
        "--export_poses", os.path.join(workdir, f"poses_{tag}.txt"),
        "--export_point_cloud", os.path.join(workdir, f"map_{tag}.ply")],
        f"resumed {label}", launches_expected=expected, mesh=loader)
    if (loader is not None) != (run["slam"].direct_ba.mesh is not None):
      fail(f"resumed {label}: the back-end's mesh is "
           f"{run['slam'].direct_ba.mesh}")
    resumed[tag] = check_partial_run(workdir, data, tag, frames,
                                     f"resumed {label}")
    out["launches"] += run["launches"]
    out["restored"] += keyframes + 1
    out["frames"] += frames - MESH_SAVE_FRAMES
    del run
  a, b = resumed["mesh_to_single"], resumed["single_to_mesh"]
  diff = float(np.abs(a["poses"][:, :3, 3] - b["poses"][:, :3, 3]).max())
  line = (f"state saved on the mesh and resumed on one device against the "
          f"reverse, after {MESH_SAVE_FRAMES} of {frames} frames: "
          f"trajectories within {diff!r} m (gate {MESH_TRAJECTORY_GATE_M} "
          f"m), {a['surfels']} and {b['surfels']} surfels")
  if (not diff <= MESH_TRAJECTORY_GATE_M
      or not surfels_agree(b["surfels"], a["surfels"])):
    fail(line)
  print(line, flush=True)
  gc.collect()
  return out


def check_mesh_devices_cli(workdir: str, data: str, ba_path: dict) -> dict:
  """Phase 35: --mesh_devices 2 on phase 7's command line: refused with
  the visible count on one card, held to phase 7's gates on two."""
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.io.dataset import read_tum_trajectory
  label = "--mesh_devices 2 on the CLI"
  visible = torch.cuda.device_count()
  argv = ba_path_argv(workdir, data, "mesh_devices") + ["--mesh_devices",
                                                        "2"]
  if visible < 2:
    code = 0
    with contextlib.redirect_stdout(io.StringIO()):
      try:
        code = port_main.main(argv)
      except SystemExit as e:
        code = e.code
    expected = f"--mesh_devices 2: only {visible} CUDA device(s) visible"
    line = f"{label}: {visible} card visible: exit {code!r}"
    if code in (0, None) or expected not in str(code):
      fail(f"{line}; expected a refusal naming the visible count")
    print(line, flush=True)
    return {"launches": 0, "frames": 0}
  poses_path = os.path.join(workdir, "poses_mesh_devices.txt")
  run = run_cli(argv, label)
  checked = check_map_run(run, label, data, poses_path,
                          os.path.join(workdir, "map_mesh_devices.ply"),
                          KEYFRAME_INTERVAL_BA)
  _, est = read_tum_trajectory(poses_path)
  _, ref = read_tum_trajectory(ba_path["poses"])
  diff = float(np.abs(est[:, :3, 3] - ref[:, :3, 3]).max())
  line = (f"{label}: {visible} cards; trajectory within {diff!r} m of "
          f"phase 7's, ATE RMSE {checked['ate']!r} m, {checked['surfels']} "
          f"surfels against {ba_path['surfels']}")
  if (not diff <= MESH_TRAJECTORY_GATE_M
      or not surfels_agree(checked["surfels"], ba_path["surfels"])):
    fail(line)
  print(line, flush=True)
  return {"launches": run["launches"], "frames": FRAMES}


def main() -> int:
  here = os.path.dirname(os.path.abspath(__file__))
  sys.path.insert(0, here)
  import torch
  if not torch.cuda.is_available():
    fail("no CUDA device (torch.cuda.is_available() is False)")
  try:
    import badslam_tpu_torch  # noqa: F401
  except ImportError as e:
    fail(f"the port package is not next to this script: {e}")
  from badslam_tpu_torch.kernels import build

  device = torch.device("cuda", 0)
  name = torch.cuda.get_device_name(0)
  smi = subprocess.run(
      ["nvidia-smi", "--query-gpu=name,power.limit",
       "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
  if smi.returncode != 0:
    fail(f"nvidia-smi: {smi.stderr.strip()}")
  card = smi.stdout.strip().splitlines()[0]
  import cv2
  print(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}; cv2 "
        f"{cv2.__version__}")
  print(card, flush=True)

  t0 = time.perf_counter()
  start = t0
  build.load("fused_preprocess")
  seconds, ptxas = build.build_info["fused_preprocess"]
  print(f"built fused_preprocess in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {seconds:.1f} s)")
  for line in ptxas.splitlines():
    if "registers" in line or "spill" in line or "smem" in line:
      print(f"  ptxas: {line.strip()}")

  seconds = {}

  def timed(phase: str, fn, *args, **kwargs):
    """``fn``'s result, its wall seconds printed and kept under
    ``phase``."""
    t0 = time.perf_counter()
    result = fn(*args, **kwargs)
    seconds[phase] = time.perf_counter() - t0
    print(f"phase {phase}: {seconds[phase]:.1f} s wall", flush=True)
    return result

  kernel = timed("3", check_kernel, device)
  with tempfile.TemporaryDirectory() as workdir:
    data = timed("4", write_dataset, workdir)
    path = timed("5-6", run_main_path, workdir, data)
    ba_path = timed("7", run_ba_path, workdir, data, path["ate"])
    pose = timed("37", check_pose_kernels, ba_path.pop("ba"), device)
    cold = timed("36", run_cold_start, workdir, data, device)
    timed("8", check_ba_determinism, data, device)
    timed("9-10", check_self_calibration_recovery, device)
    self_calibration = timed("11", run_self_calibration_path, workdir, data,
                             use_pcg=False)
    joint = timed("12", run_self_calibration_path, workdir, data,
                  use_pcg=True)
    restored = timed("13", check_round_trip, workdir, data,
                     self_calibration)
    loop_cli = timed("14", run_loop_detection_cli, workdir, data, ba_path)
    # Before any other torch.profiler session of this process: after one,
    # the first kernel record of the next session can be lost (CUPTI).
    previewed = timed("29", run_previews_and_trace, workdir, data)
    timed("30", check_render_on_card, previewed, device)
    del previewed["slam"]
    timed("31", check_inspector, workdir, self_calibration)
    defaults = timed("17", run_defaults_path, workdir, data, ba_path)
    threaded = timed("18", run_threaded_self_calibration, workdir, data)
    inputs = timed("19-21", run_input_paths, workdir, data,
                   INPUT_PATH_FRAMES)
    prefetch = timed("22", compare_prefetch, workdir, data)
    pl_cli = timed("24, 26 (CLI)", run_pipelined_cli, workdir, data)
    pl_proc = timed("25, 26 (in process)", run_pipelined_in_process,
                    workdir, data, device, pl_cli)
    pl_calibration = timed("28", run_pipelined_self_calibration, workdir,
                           data, device)
    timed("32", check_sharded_steps, device)
    mesh_ba = timed("33", run_mesh_ba_path, workdir, data, ba_path, device)
    mesh_paths = timed("34", run_mesh_paths, workdir, data, device)
    mesh_cli = timed("35", check_mesh_devices_cli, workdir, data, ba_path)
  config2 = timed("15", check_config2, device)
  blackout = timed("16", check_bow_blackout, device)
  pl_closure = timed("27", check_device_closure, device)
  # The kernel's launches on the main paths: one per frame of each CLI run
  # and of the two loop scenes, one per warm frame of a prewarm, and the
  # restored keyframes of the state round trips.
  launches = (path["launches"] + ba_path["launches"]
              + self_calibration["launches"] + joint["launches"] + restored
              + loop_cli["launches"] + defaults["launches"]
              + threaded["launches"] + inputs["launches"]
              + prefetch["launches"] + config2["launches"]
              + blackout["launches"] + pl_cli["launches"]
              + pl_proc["launches"] + pl_calibration["launches"]
              + pl_closure["launches"] + previewed["launches"]
              + mesh_ba["launches"] + mesh_paths["launches"]
              + mesh_cli["launches"] + cold["launches"])
  restored += mesh_paths["restored"]
  frames = (6 * FRAMES + 6 * INPUT_PATH_FRAMES
            + (KEYFRAME_INTERVAL_BA + 2) + 11 + blackout["frames"]
            + defaults["frames"]
            + pl_cli["frames"] + pl_proc["frames"]
            + pl_calibration["frames"] + pl_closure["frames"]
            + mesh_ba["frames"] + mesh_paths["frames"] + mesh_cli["frames"]
            + cold["frames"])
  kernel["max_abs_err"] = max(kernel["max_abs_err"],
                              self_calibration["max_abs_err"],
                              inputs["max_abs_err"], pl_proc["max_abs_err"])
  foreign = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "badslam_tpu"))
  if foreign:
    fail(f"modules of JAX or of the JAX package were imported: {foreign}")
  print("phase wall seconds: " + json.dumps(
      {k: round(v, 1) for k, v in seconds.items()})
        + f"; the whole script {time.perf_counter() - start:.1f} s",
        flush=True)

  summary = {"kernels": [{
      "name": "fused_depth_preprocess", "route": "cuda",
      "source": "badslam_tpu_torch/csrc/fused_preprocess.cu",
      "replaces": "badslam_tpu/ops/pallas_preprocess.py:76",
      "launches": launches,
      "launches_per_frame": (launches - restored) / frames,
      "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
      "call_ms": kernel["call_ms"], "plain_ms": kernel["plain_ms"],
      "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
      "library_ms": None}] + [{
      "name": f"pose_h_b_{name}_kernel", "route": "cuda",
      "source": "badslam_tpu_torch/csrc/pose_h_b.cu",
      "replaces": replaces, "launches": launched,
      "lanes": pose["lanes"], err_key: pose[err_name],
      **{key: pose[name][key] for key in ("ms", "call_ms", "plain_ms",
                                          "bound_ms", "bound_by")},
      "library_ms": None}
      for name, replaces, launched, err_key, err_name in (
          ("accumulate", "badslam_tpu/models/pose_opt.py:60 "
           "(accumulate_pose_h_b, an XLA program)",
           ba_path["pose_launches"][0], "max_scaled_err", "max_scaled_err"),
          ("step", "badslam_tpu/models/pose_opt.py:171 (the step of "
           "estimate_frame_poses_batched's lax.while_loop)",
           ba_path["pose_launches"][1], "max_abs_err", "step_err"))]}
  print(json.dumps(summary))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  if sys.argv[1:2] == [CHILD_FLAG]:
    sys.exit(cold_start_child(json.loads(sys.argv[2])))
  sys.exit(main())
