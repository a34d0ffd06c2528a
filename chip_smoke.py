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
     min_observation_count 1/2/3), the launch count reset just before, the
     host mirrors verified after every BA call, and check: rc 0, one launch
     per frame, finite poses, ATE RMSE <= 2.77 mm, 6 keyframes, live
     surfels > 0, every BA call ran >= 1 iteration, the exported PLY has as
     many points as live surfels, all finite, and their median |error|
     against the heightmap is < 1e-3 m; print frames/s, per-phase ms, BA
     iterations per call, store sizes and peak device memory;
  8. run bundle adjustment twice from one map state and check that poses
     and surfel stores are bitwise equal;
  9. check that no module of JAX or of the JAX package was imported.

The next-to-last line is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``. Needs one CUDA device and no network.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FRAMES = 51
KEYFRAME_INTERVAL_BA = 10
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

def fail(msg: str) -> None:
  print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
  sys.exit(1)


def ate_rmse(est: np.ndarray, gt: np.ndarray) -> float:
  """ATE RMSE after the closed-form SE(3) (Horn/Umeyama) alignment of the
  estimated positions onto the ground truth."""
  mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
  u, _, vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
  s = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))])
  R = u @ s @ vt
  aligned = (est - mu_e) @ R.T + mu_g
  return float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))


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


def check_kernel(device) -> dict:
  """Phase 3: kernel vs plain version at the main path's shapes, and at a
  radius that the generic instantiation serves."""
  import torch
  from badslam_tpu_torch.ops import fused_preprocess as fp
  worst = 0.0
  timing = None
  for width, height, kwargs in ((640, 480, PREPROCESS),
                                (641, 479, PREPROCESS),
                                (320, 240, PREPROCESS_RADIUS_2)):
    radius = int(kwargs["radius_factor"] * kwargs["sigma_xy"] + 0.5)
    case = f"{width}x{height} radius {radius}"
    raw, calib = kernel_inputs(width, height, seed=width, device=device)
    got = fp.fused_depth_preprocess(raw, calib, **kwargs)
    want = fp.fused_depth_preprocess_reference(raw, calib, **kwargs)
    torch.cuda.synchronize()
    if int((want[0] > 0).sum()) < width * height // 2:
      fail(f"{case}: too few valid pixels to compare")
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
  from badslam_tpu_torch.utils import synthetic
  data = os.path.join(workdir, "tum640")
  t0 = time.perf_counter()
  synthetic.write_tum_dataset(data, synthetic.straight_trajectory(FRAMES),
                              width=640, height=480)
  print(f"wrote {FRAMES}-frame 640x480 dataset in "
        f"{time.perf_counter() - t0:.1f} s", flush=True)
  return data


def run_cli(argv, label: str) -> dict:
  """One run of the port's CLI with the kernel's launch count set to 0 just
  before and read just after; its standard output is echoed."""
  import torch
  from badslam_tpu_torch import main as port_main
  from badslam_tpu_torch.ops import fused_preprocess as fp
  from badslam_tpu_torch.utils.timing import Timing
  Timing.set_device_accurate(False)
  Timing.reset()
  torch.cuda.reset_peak_memory_stats()
  out = io.StringIO()
  fp.fused_depth_preprocess.launches = 0
  with contextlib.redirect_stdout(out):
    rc = port_main.main(argv)
  launches = fp.fused_depth_preprocess.launches
  peak = torch.cuda.max_memory_allocated()
  print(out.getvalue().rstrip(), flush=True)
  if rc != 0:
    fail(f"{label}: the CLI returned {rc}")
  if launches != FRAMES:
    fail(f"{label}: fused_depth_preprocess launched {launches} times in "
         f"{FRAMES} frames")
  return {"launches": launches, "peak": peak, "stdout": out.getvalue(),
          "stats": Timing.stats()}


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


def print_phases(stats, phases, skip) -> None:
  """count, mean and median ms of each phase; ``skip`` maps a phase to the
  number of leading (cold) samples left out."""
  for phase in phases:
    if phase not in stats:
      print(f"phase {phase}: count 0")
      continue
    s = stats[phase]
    warm = s.samples[skip.get(phase, 0):] or s.samples
    print(f"phase {phase}: count {s.count}, warm mean "
          f"{statistics.mean(warm) * 1e3!r} ms, median "
          f"{statistics.median(warm) * 1e3!r} ms (device-accurate)")


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


def run_ba_path(workdir: str, data: str, odometry_ate: float) -> dict:
  """Phase 7: the CLI with sequential BA on, at the reference's defaults."""
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.slam import direct_ba
  from badslam_tpu_torch.utils import synthetic

  poses_path = os.path.join(workdir, "poses_ba.txt")
  ply_path = os.path.join(workdir, "map.ply")
  stream_path = os.path.join(workdir, "ba_iterations.txt")
  timings_path = os.path.join(workdir, "timings_ba.txt")
  argv = [data, "--sequential_ba", "--no_loop_detection",
          "--restrict_fps_to", "0", "--max_depth", "5.0", "--num_scales", "5",
          "--device_accurate_timings", "--export_poses", poses_path,
          "--export_point_cloud", ply_path, "--save_timings", stream_path,
          "--export_final_timings", timings_path]
  # Recount on the device and check the host mirrors after every BA call.
  direct_ba.DEBUG_VERIFY_COUNT = True
  try:
    run = run_cli(argv, "BA path")
  finally:
    direct_ba.DEBUG_VERIFY_COUNT = False
  ate = check_trajectory(poses_path, data, "BA path")
  print(f"BA path ATE RMSE {ate!r} m over {FRAMES} frames (gate "
        f"{ATE_GATE_M} m); odometry-only on the same frames "
        f"{odometry_ate!r} m")

  done = re.search(r"Done: (\d+) frames .* (\d+) keyframes, (\d+) surfels",
                   run["stdout"])
  store = re.search(r"Surfel store: watermark (\d+) of capacity (\d+); "
                    r"keyframe store: capacity (\d+)", run["stdout"])
  if not done or not store:
    fail("BA path: no Done / Surfel store line in the CLI's output")
  keyframes, surfels = int(done.group(2)), int(done.group(3))
  watermark, capacity, kf_capacity = (int(g) for g in store.groups())
  expected_keyframes = (FRAMES - 1) // KEYFRAME_INTERVAL_BA + 1
  if keyframes != expected_keyframes or keyframes < 4:
    fail(f"BA path: {keyframes} keyframes, expected {expected_keyframes}")
  if surfels <= 0:
    fail("BA path: no live surfels")

  # The --save_timings stream: one line per BA iteration.
  per_call = {}
  with open(stream_path) as f:
    for line in f:
      m = re.match(r"BA_count (\d+) inner_iteration (\d+) keyframe_count "
                   r"(\d+) surfel_count (\d+)", line)
      if not m:
        fail(f"BA path: bad --save_timings line {line!r}")
      per_call[int(m.group(1))] = int(m.group(2)) + 1
  stats = run["stats"]
  calls = stats["Bundle adjustment"].count if "Bundle adjustment" in stats \
      else 0
  iterations = [per_call[c] for c in sorted(per_call)]
  if calls < keyframes - 1 or len(per_call) != calls or min(iterations) < 1:
    fail(f"BA path: {calls} BA calls, iterations per call {iterations}")

  pos, nrm, col = ply.load_point_cloud_ply(ply_path)
  if pos.shape != (surfels, 3) or not (np.isfinite(pos).all()
                                       and np.isfinite(nrm).all()):
    fail(f"BA path: PLY holds {pos.shape} points, {surfels} live surfels")
  err = synthetic.surfel_map_error(pos)
  print(f"BA path map error against the heightmap: {json.dumps(err)} "
        f"(gate: median_abs_m < {MAP_MEDIAN_GATE_M})")
  if not err["median_abs_m"] < MAP_MEDIAN_GATE_M:
    fail(f"BA path: map median |error| {err['median_abs_m']} m")

  frame_s = stats["[BadSlam::ProcessFrame]"].samples
  print(f"BA path warm frames/s (frames 2..{FRAMES - 1}, BA included): "
        f"{(len(frame_s) - 2) / sum(frame_s[2:])!r}")
  print_phases(stats, ("Preprocessing", "Odometry", "Keyframe creation")
               + BA_PHASES,
               {"Preprocessing": 2, "Odometry": 2, "Keyframe creation": 1})
  ba_s = sum(stats["Bundle adjustment"].samples)
  print(f"BA path: {calls} BA calls, iterations per call {iterations}, "
        f"{ba_s / sum(iterations) * 1e3!r} ms per BA iteration (end tasks "
        f"included)")
  print(f"BA path: {keyframes} keyframes (store capacity {kf_capacity}), "
        f"{surfels} live surfels, watermark {watermark}, capacity "
        f"{capacity}; host mirrors verified after each of {calls} BA calls")
  print(f"BA path peak device memory (max_memory_allocated): {run['peak']} "
        f"bytes")
  with open(timings_path) as f:
    print(f.read().rstrip())
  return {"launches": run["launches"]}


def check_ba_determinism(data: str, device) -> None:
  """Phase 8: bundle adjustment twice from one map state, held bitwise
  equal. The state is the map after 21 frames without BA (3 keyframes,
  the first one's surfels), the second and third keyframe moved by a
  seeded perturbation of up to 1 mm and 0.3 mrad so that BA has several
  iterations of work."""
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
  results = []
  for _ in range(2):
    twin = DirectBA.from_numpy(
        config, video.depth_camera, video.color_camera, surfels, kf,
        ba.calibration, host, device)
    iterations, converged = twin.bundle_adjustment(
        max_iterations=10, active_keyframe_window_start=0,
        active_keyframe_window_end=ba.keyframe_count - 1)
    torch.cuda.synchronize()
    results.append((iterations, converged) + twin.to_numpy()[:2])
  (it_a, conv_a, s_a, k_a), (it_b, conv_b, s_b, k_b) = results
  moved = float(np.abs(k_a["global_T_frame"] - kf["global_T_frame"]).max())
  if (it_a, conv_a) != (it_b, conv_b):
    fail(f"BA determinism: {it_a, conv_a} against {it_b, conv_b}")
  for name, a, b in ([(n, s_a[n], s_b[n]) for n in s_a]
                     + [(n, k_a[n], k_b[n]) for n in k_a]):
    if a.dtype != b.dtype or a.tobytes() != b.tobytes():
      fail(f"BA determinism: {name} differs between two runs from one state")
  print(f"BA determinism: two runs of {it_a} iterations from one state "
        f"({ba.keyframe_count} keyframes, {int(s_a['valid'].sum())} live "
        f"surfels after, poses moved by up to {moved!r}) are bitwise equal "
        f"in every field of both stores")


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
  print(f"device: {name}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
  print(card, flush=True)

  t0 = time.perf_counter()
  build.load("fused_preprocess")
  seconds, ptxas = build.build_info["fused_preprocess"]
  print(f"built fused_preprocess in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {seconds:.1f} s)")
  for line in ptxas.splitlines():
    if "registers" in line or "spill" in line or "smem" in line:
      print(f"  ptxas: {line.strip()}")

  kernel = check_kernel(device)
  with tempfile.TemporaryDirectory() as workdir:
    data = write_dataset(workdir)
    path = run_main_path(workdir, data)
    ba_path = run_ba_path(workdir, data, path["ate"])
    check_ba_determinism(data, device)
  launches = path["launches"] + ba_path["launches"]
  foreign = sorted(m for m in sys.modules
                   if m.split(".")[0] in ("jax", "jaxlib", "badslam_tpu"))
  if foreign:
    fail(f"modules of JAX or of the JAX package were imported: {foreign}")

  summary = {"kernels": [{
      "name": "fused_depth_preprocess", "route": "cuda",
      "source": "badslam_tpu_torch/csrc/fused_preprocess.cu",
      "replaces": "badslam_tpu/ops/pallas_preprocess.py:76",
      "launches": launches,
      "launches_per_frame": launches / (2 * FRAMES),
      "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
      "call_ms": kernel["call_ms"], "plain_ms": kernel["plain_ms"],
      "bound_ms": kernel["bound_ms"], "bound_by": kernel["bound_by"],
      "library_ms": None}]}
  print(json.dumps(summary))
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": name,
      "count": torch.cuda.device_count()}}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
