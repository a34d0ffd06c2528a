#!/usr/bin/env python3
"""Profile the PyTorch port: the odometry-only slice frame by frame, or
(``--ba``) the bundle adjustment iteration by iteration.

  python3 tools/profile_slice.py [--frames 14] [--width 640 --height 480]
                                 [--out profile.txt] [--device cpu]
  python3 tools/profile_slice.py --ba [--keyframes 5] [--use_pcg]
                                 [--optimize_intrinsics] [--out profile.txt]

Writes a TUM dataset of the heightmap world along the constant-twist
trajectory to a temporary directory and drives ``BadSlam`` on it with the
odometry-only configuration (keyframe every 5 frames, 5 scales, max depth
5 m), in three stretches:
  1. warm-up: the first 4 frames, not measured;
  2. timed: the next ``--timed`` frames (default 5) with device-accurate
     phase timing (``torch.cuda.synchronize()`` around each phase), no
     profiler;
  3. profiled: the remaining frames under ``torch.profiler`` (CPU and CUDA
     activities), with the odometry's H/b and cost evaluations counted.

Prints per frame: the timed stretch's Preprocessing and Odometry ms; the
profiled stretch's device busy ms (union of the traced device kernel,
memcpy and memset intervals), kernel launches (host ``cu*LaunchKernel*``
calls) and H/b and cost evaluations per pyramid scale; and two device idle
shares:
  - profiled: 1 - busy / wall of the profiled stretch (the profiler slows
    the host, so this overstates idleness);
  - mixed: 1 - busy per frame / timed frame wall (busy from the profiled
    stretch, wall from the timed one; the two stretches run different
    frames of the same configuration).
``--out`` receives the profiler's operator and kernel tables. It runs on the
CUDA device and fails without one; ``--device cpu`` runs the plain paths on
the CPU (small sizes) and reports no device numbers.

``--ba`` builds a map first: ``BadSlam`` runs without BA over
10 * (keyframes - 1) + 1 frames (a keyframe every 10 frames, the first one's
surfels), and the keyframes after the first are moved by a seeded
perturbation of up to ``--perturb`` x (1 mm, 0.3 mrad) so that BA has
several iterations of work. From copies of that one state (``to_numpy`` /
``from_numpy``) it runs the sequential system's BA call (all keyframes
active, up to 10 iterations) three times: to warm up; timed, with
``torch.cuda.synchronize()`` around each phase and no profiler; and under
``torch.profiler``, phases still bracketed, each phase a profiler span.
Prints, per BA iteration and per "BA ..." phase: wall ms, kernel launches,
device busy ms, device-to-host copies (each one a host read that waits for
the device), and the device idle share of the whole call. ``--use_pcg``
replaces the geometry and pose phases by the joint PCG step (span "BA PCG"
and its phases "BA PCG init", "BA PCG inner loop", "BA PCG normal
re-estimation"; the program's counters, such as "BA PCG inner
iterations", are printed with their samples) and
``--optimize_intrinsics`` turns both intrinsics flags on: the alternated
step (span "BA intrinsics optimization") or, with ``--use_pcg``, the
intrinsics unknowns of the joint vector.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import statistics
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

import torch  # noqa: E402

from badslam_tpu_torch.io import dataset as dataset_io  # noqa: E402
from badslam_tpu_torch.main import build_parser, config_from_args  # noqa: E402
from badslam_tpu_torch.geometry import se3  # noqa: E402
from badslam_tpu_torch.models import odometry  # noqa: E402
from badslam_tpu_torch.slam.direct_ba import DirectBA  # noqa: E402
from badslam_tpu_torch.slam.system import BadSlam  # noqa: E402
from badslam_tpu_torch.utils import synthetic  # noqa: E402
from badslam_tpu_torch.utils.timing import Timing  # noqa: E402

WARMUP = 4
ODOMETRY_ONLY = ["--keyframe_interval", "5", "--num_scales", "5",
                 "--max_depth", "5.0", "--max_num_ba_iterations_per_keyframe",
                 "0", "--no_loop_detection", "--sequential_ba",
                 "--restrict_fps_to", "0", "--quiet"]


def count_calls(module, name: str, counts: collections.Counter) -> None:
  """Wrap ``module.name`` to count its calls by the camera width it gets
  (the pyramid scale)."""
  fn = getattr(module, name)

  def counted(tracked_T_base, base, tracked, depth_cam, *args, **kwargs):
    counts[(name, depth_cam.width)] += 1
    return fn(tracked_T_base, base, tracked, depth_cam, *args, **kwargs)

  setattr(module, name, counted)


def busy_ms(events) -> float:
  """Length of the union of the device intervals, in ms."""
  spans = sorted((e.time_range.start, e.time_range.end) for e in events)
  total, end = 0.0, float("-inf")
  for s, e in spans:
    if e <= end:
      continue
    total += e - max(s, end)
    end = e
  return total / 1e3


def is_launch(event) -> bool:
  return "LaunchKernel" in event.name and event.name.startswith("cu")


def is_device(event) -> bool:
  return event.device_type == torch.autograd.DeviceType.CUDA


def profile_ba(args) -> int:
  """The ``--ba`` mode; see the module docstring."""
  cuda = args.device == "cuda"
  interval = 10
  frames = interval * (args.keyframes - 1) + 1
  no_ba = ["--keyframe_interval", str(interval), "--num_scales", "5",
           "--max_depth", "5.0", "--max_num_ba_iterations_per_keyframe", "0",
           "--no_loop_detection", "--sequential_ba", "--restrict_fps_to",
           "0", "--quiet"]
  with tempfile.TemporaryDirectory() as workdir:
    data = synthetic.write_tum_dataset(
        os.path.join(workdir, "tum"), synthetic.straight_trajectory(frames),
        width=args.width, height=args.height)
    config = config_from_args(build_parser().parse_args([data, *no_ba]))
    video = dataset_io.load_tum_dataset(
        data, raw_to_float_depth=config.raw_to_float_depth)
    slam = BadSlam(config, video, device=args.device)
    for i in range(frames):
      slam.process_frame(i)
      video.frames[i].clear_cache()
  ba = slam.direct_ba
  k = ba.keyframe_count
  surfels, kf, host = ba.to_numpy()
  generator = torch.Generator().manual_seed(0)
  scale = torch.tensor([1e-3] * 3 + [3e-4] * 3) * args.perturb
  for i in range(1, k):
    noise = (torch.rand(6, generator=generator) * 2 - 1) * scale
    kf["global_T_frame"][i] = (
        torch.from_numpy(kf["global_T_frame"][i]) @ se3.exp(noise)).numpy()
  print(f"device {slam.device}"
        + (f" ({torch.cuda.get_device_name(0)})" if cuda else "")
        + f"; {args.width}x{args.height}, {k} keyframes, "
        f"{ba.surfel_count} surfels of capacity {ba.surfels.capacity}, "
        f"poses perturbed by {args.perturb} x (1 mm, 0.3 mrad)")

  config = dataclasses.replace(config, use_pcg=args.use_pcg)
  print(f"scheme: {'joint PCG' if args.use_pcg else 'alternating'}, "
        f"intrinsics {'on' if args.optimize_intrinsics else 'off'}")

  def twin():
    # Self-calibration writes the calibration in place: each run its own.
    return DirectBA.from_numpy(
        config, video.depth_camera, video.color_camera, surfels, kf,
        ba.calibration.clone(), host, args.device)

  def run(target):
    result = target.bundle_adjustment(
        optimize_depth_intrinsics=args.optimize_intrinsics,
        optimize_color_intrinsics=args.optimize_intrinsics,
        do_surfel_updates=config.do_surfel_updates, max_iterations=10,
        active_keyframe_window_start=0, active_keyframe_window_end=k - 1)
    if cuda:
      torch.cuda.synchronize()
    return result

  run(twin())  # warm-up
  target = twin()
  Timing.reset()
  Timing.set_device_accurate(True)
  t0 = time.perf_counter()
  iterations, converged = run(target)
  timed_ms = (time.perf_counter() - t0) * 1e3
  stats = Timing.stats()
  print(f"timed BA call: {iterations} iterations, converged {converged}, "
        f"{target.surfel_count} surfels after; wall {timed_ms!r} ms, "
        f"{timed_ms / iterations!r} ms per iteration (end tasks included)")
  for phase, s in sorted(stats.items(), key=lambda kv: -kv[1].total):
    if s.counter:
      print(f"  counter {phase}: samples {s.samples}, mean {s.mean!r}")
    else:
      print(f"  timed {phase}: count {s.count}, total {s.total * 1e3!r} ms, "
            f"mean {s.mean * 1e3!r} ms")
  if cuda:
    print(f"  peak device memory so far (max_memory_allocated): "
          f"{torch.cuda.max_memory_allocated()} bytes")

  target = twin()
  activities = [torch.profiler.ProfilerActivity.CPU]
  if cuda:
    activities.append(torch.profiler.ProfilerActivity.CUDA)
    torch.cuda.synchronize()
  # Every Timing span is a profiler range while the profiler runs.
  with torch.profiler.profile(activities=activities) as prof:
    t0 = time.perf_counter()
    p_iterations, _ = run(target)
    wall_ms = (time.perf_counter() - t0) * 1e3
  Timing.set_device_accurate(False)
  events = prof.events()
  launches = [e for e in events if is_launch(e)]
  device = [e for e in events if is_device(e)] if cuda else []
  reads = [e for e in device if "Memcpy DtoH" in e.name]
  print(f"profiled BA call: {p_iterations} iterations, wall {wall_ms!r} ms")
  print(f"per BA iteration (end tasks included): "
        f"{len(launches) / p_iterations!r} kernel launches, "
        f"{len(reads) / p_iterations!r} device-to-host copies")
  if cuda and not device:
    print("device busy: not measured (the profiler traced no device events)")
  elif cuda:
    busy = busy_ms(device)
    print(f"device busy: {busy!r} ms in the call, {busy / p_iterations!r} ms "
          f"per BA iteration ({len(device)} device events)")
    print(f"device idle share, profiled: {1 - busy / wall_ms!r}")
    print(f"device idle share, mixed (profiled busy / timed wall): "
          f"{1 - busy / timed_ms!r}")
  # Per phase: the spans are bracketed by device barriers, so a device
  # event belongs to the span in which it starts.
  spans = collections.defaultdict(list)
  for e in events:
    if e.name in stats and not is_device(e):
      spans[e.name].append((e.time_range.start, e.time_range.end))
  for phase, ranges in sorted(spans.items()):
    def inside(e):
      return any(a <= e.time_range.start < b for a, b in ranges)
    n = len(ranges)
    line = (f"  phase {phase}: {n} spans, wall "
            f"{sum(b - a for a, b in ranges) / 1e3 / n!r} ms, "
            f"{sum(1 for e in launches if inside(e)) / n!r} launches, "
            f"{sum(1 for e in reads if inside(e)) / n!r} device-to-host "
            f"copies")
    if device:
      line += (f", device busy "
               f"{busy_ms([e for e in device if inside(e)]) / n!r} ms")
    print(line + " (per span)")
  write_tables(prof, args.out, cuda)
  return 0


def write_tables(prof, out, cuda: bool) -> None:
  if not out:
    return
  os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
  sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
  with open(out, "w") as f:
    f.write(prof.key_averages().table(sort_by=sort, row_limit=60) + "\n")
    f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                      row_limit=30) + "\n")
  print(f"tables written to {out}")


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--ba", action="store_true",
                 help="profile the bundle adjustment instead of odometry")
  p.add_argument("--keyframes", type=int, default=5,
                 help="--ba: keyframes in the map")
  p.add_argument("--perturb", type=float, default=1.0,
                 help="--ba: pose perturbation, x (1 mm, 0.3 mrad)")
  p.add_argument("--use_pcg", action="store_true",
                 help="--ba: the joint PCG step instead of the alternation")
  p.add_argument("--optimize_intrinsics", action="store_true",
                 help="--ba: both intrinsics flags on")
  p.add_argument("--frames", type=int, default=14)
  p.add_argument("--timed", type=int, default=5)
  p.add_argument("--width", type=int, default=640)
  p.add_argument("--height", type=int, default=480)
  p.add_argument("--out", default=None)
  p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
  args = p.parse_args(argv)
  if args.ba:
    return profile_ba(args)
  if args.frames < WARMUP + args.timed + 1:
    p.error(f"--frames must be at least {WARMUP + args.timed + 1}")
  cuda = args.device == "cuda"

  with tempfile.TemporaryDirectory() as workdir:
    data = synthetic.write_tum_dataset(
        os.path.join(workdir, "tum"),
        synthetic.straight_trajectory(args.frames),
        width=args.width, height=args.height)
    config = config_from_args(
        build_parser().parse_args([data, *ODOMETRY_ONLY]))
    video = dataset_io.load_tum_dataset(
        data, raw_to_float_depth=config.raw_to_float_depth)
    slam = BadSlam(config, video, device=args.device)
    print(f"device {slam.device}"
          + (f" ({torch.cuda.get_device_name(0)})" if cuda else "")
          + f"; {args.width}x{args.height}, {args.frames} frames")

    def run(frames):
      for i in frames:
        slam.process_frame(i)
        slam.end_frame()
        video.frames[i].clear_cache()

    run(range(WARMUP))
    timed = range(WARMUP, WARMUP + args.timed)
    Timing.reset()
    Timing.set_device_accurate(True)
    t0 = time.perf_counter()
    run(timed)
    frame_ms = (time.perf_counter() - t0) * 1e3 / len(timed)
    Timing.set_device_accurate(False)
    stats = Timing.stats()
    for phase in ("Preprocessing", "Odometry"):
      print(f"timed frames {timed.start}-{timed.stop - 1}: {phase} mean "
            f"{stats[phase].mean * 1e3!r} ms, median "
            f"{statistics.median(stats[phase].samples) * 1e3!r} ms")
    print(f"timed frames: wall {frame_ms!r} ms per frame")

    calls: collections.Counter = collections.Counter()
    count_calls(odometry, "frame_to_frame_h_b", calls)
    count_calls(odometry, "frame_to_frame_cost", calls)
    profiled = range(timed.stop, args.frames)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
      activities.append(torch.profiler.ProfilerActivity.CUDA)
      torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
      t0 = time.perf_counter()
      run(profiled)
      if cuda:
        torch.cuda.synchronize()
      wall_ms = (time.perf_counter() - t0) * 1e3
  n = len(profiled)
  print(f"profiled frames {profiled.start}-{profiled.stop - 1}: wall "
        f"{wall_ms / n!r} ms per frame")
  for (name, width), c in sorted(calls.items()):
    print(f"  {name} at width {width}: {c / n!r} per frame")
  events = prof.events()
  launches = sum(1 for e in events if is_launch(e))
  print(f"kernel launches: {launches / n!r} per frame")
  if cuda:
    device = [e for e in events if is_device(e)]
    if not device:
      print("device busy: not measured (the profiler traced no device "
            "events)")
    else:
      busy = busy_ms(device) / n
      print(f"device busy: {busy!r} ms per frame ({len(device) / n!r} "
            f"device events per frame)")
      print(f"device idle share, profiled: {1 - busy * n / wall_ms!r}")
      print(f"device idle share, mixed (profiled busy / timed wall): "
            f"{1 - busy / frame_ms!r}")
  write_tables(prof, args.out, cuda)
  return 0


if __name__ == "__main__":
  sys.exit(main())
