"""CLI entry point: offline TUM-dataset runs of the odometry-only slice.

The flags are the reference CLI's (``badslam_tpu.main.build_parser``), so a
command line runs unchanged on either package. This slice runs the
odometry-only configuration:

  python -m badslam_tpu_torch.main <dataset_dir> \\
      --max_num_ba_iterations_per_keyframe 0 --no_loop_detection \\
      --sequential_ba [--export_poses out.txt] ...

Flags whose work is not ported yet are refused (SystemExit), each naming
the ROADMAP item that will port it; none is ignored silently.
"""

from __future__ import annotations

import sys
import time

from badslam_tpu.main import build_parser, config_from_args


def _refuse_unported_flags(args) -> None:
  """CLI-only flags outside the slice (the configuration's own fields are
  checked by BadSlam)."""
  from badslam_tpu_torch.slam.system import unported
  item4 = 'item 4 "DirectBA, alternating scheme"'
  item5 = 'item 5 "Sequential system and CLI"'
  refusals = [
      (args.mesh_devices > 1, "--mesh_devices", 'item 11 "Distribution"'),
      (args.final_ba_iterations > 0, "--final_ba_iterations", item4),
      (args.export_point_cloud, "--export_point_cloud", item4),
      (args.export_reconstruction, "--export_reconstruction", item5),
      (args.save_state or args.load_state, "--save_state/--load_state",
       item5),
      (args.export_calibration or args.import_calibration,
       "--export_calibration/--import_calibration", item5),
      (args.save_timings, "--save_timings (BA iteration statistics)", item4),
      (args.render_preview, "--render_preview",
       'item 9 "The rest of the library"'),
      (args.profile_dir, "--profile_dir",
       'item 9 "The rest of the library"'),
  ]
  for refused, what, item in refusals:
    if refused:
      raise SystemExit(unported(what, item))
  if args.prewarm or args.prewarm_keyframes > 0:
    raise SystemExit(
        "--prewarm: the port has no compile step to move out of the frame "
        "loop (ROADMAP \"Code the port leaves out\")")


def run(args) -> int:
  from badslam_tpu.utils import logging as log
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.slam.system import BadSlam
  from badslam_tpu_torch.utils.timing import Timing

  _refuse_unported_flags(args)
  if args.log_level:
    log.set_level(args.log_level)
  config = config_from_args(args)
  video = dataset_io.load_tum_dataset(
      args.dataset, args.trajectory,
      raw_to_float_depth=config.raw_to_float_depth)
  try:
    slam = BadSlam(config, video)
  except NotImplementedError as e:
    raise SystemExit(str(e)) from e
  if not args.quiet:
    log.info(f"Loaded {video.frame_count()} frames from {args.dataset} "
             f"({video.depth_camera.width}x{video.depth_camera.height}), "
             f"device {slam.device}")
  if args.device_accurate_timings:
    Timing.set_device_accurate(True)

  end = min(video.frame_count() - 1, config.end_frame)
  t_start = time.perf_counter()
  frames_done = 0
  for frame_index in range(config.start_frame, end + 1):
    with Timing.time("[BadSlam::ProcessFrame]"):
      slam.process_frame(frame_index)
    slam.end_frame()
    video.frames[frame_index].clear_cache()
    frames_done += 1
    if not args.quiet and frames_done % 50 == 0:
      elapsed = time.perf_counter() - t_start
      print(f"frame {frame_index}: {frames_done / elapsed:.1f} FPS, "
            f"{len(slam.keyframes)} keyframes")

  if not args.quiet:
    elapsed = time.perf_counter() - t_start
    print(f"Done: {frames_done} frames in {elapsed:.1f} s "
          f"({frames_done / max(elapsed, 1e-9):.1f} FPS), "
          f"{len(slam.keyframes)} keyframes")
  if args.export_poses:
    ts, poses = slam.trajectory()
    dataset_io.save_tum_trajectory(args.export_poses, ts, poses)
  if args.export_final_timings:
    Timing.export_file(args.export_final_timings)
  return 0


def main(argv=None) -> int:
  return run(build_parser().parse_args(argv))


if __name__ == "__main__":
  sys.exit(main())
