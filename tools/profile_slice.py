#!/usr/bin/env python3
"""Profile the PyTorch port's odometry-only slice frame by frame.

  python3 tools/profile_slice.py [--frames 14] [--width 640 --height 480]
                                 [--out profile.txt] [--device cpu]

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
"""

from __future__ import annotations

import argparse
import collections
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
from badslam_tpu_torch.models import odometry  # noqa: E402
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


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("--frames", type=int, default=14)
  p.add_argument("--timed", type=int, default=5)
  p.add_argument("--width", type=int, default=640)
  p.add_argument("--height", type=int, default=480)
  p.add_argument("--out", default=None)
  p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
  args = p.parse_args(argv)
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
  launches = sum(1 for e in events
                 if "LaunchKernel" in e.name and e.name.startswith("cu"))
  print(f"kernel launches: {launches / n!r} per frame")
  if cuda:
    device = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]
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
  if args.out:
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    sort = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    with open(args.out, "w") as f:
      f.write(prof.key_averages().table(sort_by=sort, row_limit=60) + "\n")
      f.write(prof.key_averages().table(sort_by="self_cpu_time_total",
                                        row_limit=30) + "\n")
    print(f"tables written to {args.out}")
  return 0


if __name__ == "__main__":
  sys.exit(main())
