"""CLI entry point: offline TUM-dataset runs with BA on its own thread
(the default) or sequential (``--sequential_ba``; alternating or, with
``--use_pcg``, joint), self-calibration with ``--optimize_intrinsics``, loop
closure, calibration and state files, and the dense reconstruction export.

The flags are the reference CLI's (this module keeps its own copy of the
parser of ``badslam_tpu/main.py``; ``tests/test_torch_config.py`` holds the
two against each other), plus ``--device {cuda,cpu}``. A command line runs
unchanged on either package. The run computes on the CUDA device unless
``--device cpu`` asks otherwise, and fails where no CUDA device is visible.
With no flag, BA runs on its thread and loop detection on another:

  python -m badslam_tpu_torch.main <dataset_dir> \\
      [--sequential_ba] [--sequential_loop_detection | --no_loop_detection] \\
      [--optimize_intrinsics] [--use_pcg] [--no_pose_estimation] \\
      [--pyramid_level_for_depth L] [--pyramid_level_for_color L] \\
      [--median_filter_and_densify_iterations N] \\
      [--export_poses out.txt] [--export_point_cloud map.ply] \\
      [--export_reconstruction dense.ply] \\
      [--export_calibration base] [--import_calibration base] \\
      [--save_state state.npz] [--load_state state.npz] \\
      [--render_preview dir [--render_mode M] [--render_every N]] \\
      [--profile_dir dir] [--prewarm [--prewarm_keyframes N]] ...

Frames are decoded by a prefetching thread pool ahead of the frame loop
(into page-locked memory on the GPU). ``--no_active_kf_window`` is accepted
and changes nothing: the port's BA phases loop over the keyframes that take
part, so there is no window.

``--render_preview`` renders the final map from the keyframes' viewpoints
into PNGs after every export (``render.py``). ``--profile_dir`` writes a
``torch.profiler`` trace of the run, from the system's construction to the
last preview, as a gzipped Chrome trace that TensorBoard and Perfetto open:
the CPU ops of every thread and the device's kernels and copies on every
CUDA stream.

``--prewarm`` runs the live loop's device work on synthetic frames before
the first real frame (``BadSlam.prewarm``), so that its first-use costs fall
at startup; ``--prewarm_keyframes N`` also pre-sizes the keyframe store.

One configuration is refused (SystemExit): ``--no_pallas_preprocess`` on a
CUDA device, where the plain preprocess chain is only the kernel's test
reference. No flag is ignored silently.
"""

from __future__ import annotations

import argparse
import sys
import time

from badslam_tpu_torch.config import BadSlamConfig


def build_parser() -> argparse.ArgumentParser:
  p = argparse.ArgumentParser(
      description="BAD SLAM (PyTorch/CUDA port)")
  p.add_argument("dataset", help="TUM-format dataset directory "
                 "(calibration.txt + associated.txt)")
  p.add_argument("trajectory", nargs="?", default=None,
                 help="optional ground-truth trajectory filename "
                 "(for --follow_input_trajectory runs)")

  # Dataset playback (main.cc:96-134).
  p.add_argument("--depth_scaling", type=float, default=5000.0,
                 help="depth = depth_scaling * depth_in_meters")
  p.add_argument("--target_frame_rate", type=float, default=0.0,
                 help="real-time mode: bound sequential-BA work by the frame"
                      " budget at this rate (bad_slam_config.h:60-65; 0 ="
                      " offline, BA runs to its planned budget)")
  p.add_argument("--restrict_fps_to", type=int, default=30,
                 help="pace playback to at most this FPS (EndFrame,"
                      " bad_slam.cc:449-479); 0 disables pacing")
  p.add_argument("--start_frame", type=int, default=0)
  p.add_argument("--end_frame", type=int, default=2**31 - 1)
  p.add_argument("--pyramid_level_for_depth", type=int, default=0)
  p.add_argument("--pyramid_level_for_color", type=int, default=0)

  # Odometry (main.cc:163-177).
  p.add_argument("--num_scales", type=int, default=5)
  p.add_argument("--no_motion_model", action="store_true")
  p.add_argument("--no_pose_estimation", action="store_true",
                 help="use the dataset trajectory as-is (mapping only)")

  # Bundle adjustment (main.cc:186-245).
  p.add_argument("--keyframe_interval", type=int, default=10)
  p.add_argument("--max_num_ba_iterations_per_keyframe", type=int, default=10)
  p.add_argument("--use_deactivation", action="store_true")
  p.add_argument("--no_active_kf_window", action="store_true",
                 help="disable gathering active keyframes into a bucketed "
                      "window before the BA phases")
  p.add_argument("--no_geometric_residuals", action="store_true")
  p.add_argument("--no_photometric_residuals", action="store_true")
  p.add_argument("--optimize_intrinsics", action="store_true")
  p.add_argument("--intrinsics_optimization_interval", type=int, default=10)
  p.add_argument("--final_ba_iterations", type=int, default=0)
  p.add_argument("--no_surfel_updates", action="store_true")
  p.add_argument("--sequential_ba", action="store_true")
  p.add_argument("--use_pcg", action="store_true")
  p.add_argument("--pipelined_frontend", action="store_true",
                 help="transfer-free front-end: zero device->host transfers"
                      " during the run (implies --sequential_ba)")
  p.add_argument("--pipelined_concurrent_ba", action="store_true",
                 help="with --pipelined_frontend: dispatch the per-frame"
                      " transfer-free BA iterations from a dedicated host"
                      " thread instead of the frame critical path (the"
                      " BAThreadMain analog without readbacks)")
  p.add_argument("--no_pallas_preprocess", action="store_true",
                 help="force the plain stencil chain instead of the fused"
                      " preprocess kernel (ops/fused_preprocess.py; CPU only)")
  p.add_argument("--mesh_devices", type=int, default=0,
                 help="run the back-end distributed over an N-device mesh"
                      " (surfel store sharded along the mesh's 'surfels'"
                      " axis). Uses the first N visible devices")

  # Memory (main.cc:247-257).
  p.add_argument("--max_surfel_count", type=int, default=25_000_000)
  p.add_argument("--min_free_gpu_memory_mb", type=int, default=250,
                 help="keyframes are merged under device-memory pressure"
                      " once free device memory drops below this"
                      " (bad_slam.cc:958-968)")
  p.add_argument("--sparsification", type=int, default=4)
  p.add_argument("--reconstruction_sparsification", type=int, default=1,
                 help="sparse surfel cell size used for --export_reconstruction"
                      " (main.cc:224-229)")

  # Surfel reconstruction (main.cc:259-284).
  p.add_argument("--surfel_merge_dist_factor", type=float, default=0.8)
  p.add_argument("--min_observation_count_while_bootstrapping_1",
                 type=int, default=1)
  p.add_argument("--min_observation_count_while_bootstrapping_2",
                 type=int, default=2)
  p.add_argument("--min_observation_count", type=int, default=3)

  # Loop closure (main.cc:286-302).
  p.add_argument("--no_loop_detection", action="store_true")
  p.add_argument("--sequential_loop_detection", action="store_true")
  p.add_argument("--loop_detection_image_frequency", type=float, default=0.0)

  # Depth preprocessing (main.cc:314-356).
  p.add_argument("--max_depth", type=float, default=3.0)
  p.add_argument("--baseline_fx", type=float, default=40.0)
  p.add_argument("--median_filter_and_densify_iterations", type=int,
                 default=0)
  p.add_argument("--bilateral_filter_sigma_xy", type=float, default=1.5)
  p.add_argument("--bilateral_filter_radius_factor", type=float, default=2.0)
  p.add_argument("--bilateral_filter_sigma_inv_depth", type=float,
                 default=0.005)

  # Exports / state (main.cc:359-404 + io.h).
  p.add_argument("--export_point_cloud", default=None)
  p.add_argument("--export_reconstruction", default=None,
                 help="run dense geometry-only BA at"
                      " --reconstruction_sparsification and save the"
                      " high-resolution point cloud (main.cc:796-855)")
  p.add_argument("--export_calibration", default=None)
  p.add_argument("--export_final_timings", default=None)
  p.add_argument("--save_timings", default=None,
                 help="stream per-BA-iteration stats to this file")
  p.add_argument("--device_accurate_timings", action="store_true",
                 help="bracket every timed phase with device barriers"
                      " (cudaEvent-accurate per-phase numbers; profiling"
                      " mode, see PERF.md)")
  p.add_argument("--profile_dir", default=None,
                 help="capture a profiler trace of the whole run into"
                      " this directory (view with TensorBoard/Perfetto)")
  p.add_argument("--export_poses", default=None)
  p.add_argument("--import_calibration", default=None)
  p.add_argument("--save_state", default=None,
                 help="save a full SLAM state snapshot (.npz) at the end")
  p.add_argument("--load_state", default=None,
                 help="restore a state snapshot before processing")
  p.add_argument("--render_preview", default=None,
                 help="render the final surfel map from keyframe viewpoints"
                      " into this directory (headless stand-in for the"
                      " reference's render window, render_window.cc)")
  p.add_argument("--render_mode", default="color",
                 choices=["color", "normals", "descriptors", "activation"],
                 help="surfel display coloring"
                      " (kernel_update_visualization.cu modes)")
  p.add_argument("--splat_half_extent_in_pixels", type=float, default=3.0,
                 help="screen-space splat half-extent (main.cc:285-287)")
  p.add_argument("--render_every", type=int, default=1,
                 help="render every Nth keyframe viewpoint")
  p.add_argument("--prewarm", action="store_true",
                 help="run the live loop's device work on synthetic frames"
                      " of the dataset's shape before the first real frame,"
                      " so that first-use costs (the kernel's build and"
                      " load, library handles, lazy module loading,"
                      " allocator growth) fall at startup instead of"
                      " mid-run (the autotune-database-preload analog,"
                      " main.cc:437-447)")
  p.add_argument("--prewarm_keyframes", type=int, default=0,
                 help="with --prewarm: pre-size the keyframe store for this"
                      " many keyframes and also run a BA iteration at every"
                      " store capacity a map of this many keyframes passes"
                      " through")
  # The one flag the reference CLI lacks (it chose its backend through the
  # JAX_PLATFORMS environment variable).
  p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                 help="where the run computes; cuda fails when no CUDA"
                      " device is visible, it never falls back to the CPU")
  p.add_argument("--quiet", action="store_true")
  p.add_argument("--log_level", default=None,
                 choices=["debug", "info", "warning", "error", "fatal"],
                 help="log verbosity (also BADSLAM_LOG_LEVEL env)")
  return p


def config_from_args(args) -> BadSlamConfig:
  return BadSlamConfig(
      raw_to_float_depth=1.0 / args.depth_scaling,
      start_frame=args.start_frame,
      end_frame=args.end_frame,
      target_frame_rate=args.target_frame_rate,
      fps_restriction=args.restrict_fps_to,
      pyramid_level_for_depth=args.pyramid_level_for_depth,
      pyramid_level_for_color=args.pyramid_level_for_color,
      max_depth=args.max_depth,
      baseline_fx=args.baseline_fx,
      median_filter_and_densify_iterations=(
          args.median_filter_and_densify_iterations),
      bilateral_filter_sigma_xy=args.bilateral_filter_sigma_xy,
      bilateral_filter_radius_factor=args.bilateral_filter_radius_factor,
      bilateral_filter_sigma_inv_depth=args.bilateral_filter_sigma_inv_depth,
      max_surfel_count=args.max_surfel_count,
      min_free_gpu_memory_mb=args.min_free_gpu_memory_mb,
      sparse_surfel_cell_size=args.sparsification,
      surfel_merge_dist_factor=args.surfel_merge_dist_factor,
      min_observation_count_while_bootstrapping_1=(
          args.min_observation_count_while_bootstrapping_1),
      min_observation_count_while_bootstrapping_2=(
          args.min_observation_count_while_bootstrapping_2),
      min_observation_count=args.min_observation_count,
      num_scales=args.num_scales,
      use_motion_model=not args.no_motion_model,
      estimate_poses=not args.no_pose_estimation,
      keyframe_interval=args.keyframe_interval,
      max_num_ba_iterations_per_keyframe=(
          args.max_num_ba_iterations_per_keyframe),
      disable_deactivation=not args.use_deactivation,
      use_active_kf_window=not args.no_active_kf_window,
      use_geometric_residuals=not args.no_geometric_residuals,
      use_photometric_residuals=not args.no_photometric_residuals,
      optimize_intrinsics=args.optimize_intrinsics,
      intrinsics_optimization_interval=args.intrinsics_optimization_interval,
      do_surfel_updates=not args.no_surfel_updates,
      parallel_ba=not args.sequential_ba,
      use_pcg=args.use_pcg,
      pipelined_frontend=args.pipelined_frontend,
      pipelined_concurrent_ba=args.pipelined_concurrent_ba,
      use_pallas_preprocess=not args.no_pallas_preprocess,
      enable_loop_detection=not args.no_loop_detection,
      parallel_loop_detection=not args.sequential_loop_detection,
      loop_detection_image_frequency=args.loop_detection_image_frequency,
  )


def build_mesh(n_devices: int, device: str):
  """The mesh of ``--mesh_devices`` (JAX :221-249): none for ``n <= 1``;
  ``n`` virtual shards of the CPU with ``--device cpu`` (JAX forces the
  CPU's device count); the first ``n`` cards on CUDA, refused when fewer
  are visible. A virtual mesh over one card is a library call
  (``parallel.spmd.Mesh([cuda:0] * n, ...)``), not a CLI option."""
  if n_devices <= 1:
    return None
  import torch
  from badslam_tpu_torch.parallel import sharded_ba, spmd
  if device == "cpu":
    devices = [torch.device("cpu")] * n_devices
  else:
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if visible < n_devices:
      raise SystemExit(
          f"--mesh_devices {n_devices}: only {visible} CUDA device(s) "
          f"visible. For a virtual mesh run with --device cpu")
    devices = [torch.device("cuda", i) for i in range(n_devices)]
  return spmd.Mesh(devices, (sharded_ba.SURFEL_AXIS,))


def run(args) -> int:
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.slam.system import BadSlam, NoCudaDeviceError
  from badslam_tpu_torch.utils import logging as log

  if args.log_level:
    log.set_level(args.log_level)
  config = config_from_args(args)
  video = dataset_io.load_tum_dataset(
      args.dataset, args.trajectory,
      raw_to_float_depth=config.raw_to_float_depth)
  mesh = build_mesh(args.mesh_devices, args.device)
  if mesh is not None and not args.quiet:
    log.info(f"Distributed back-end over {args.mesh_devices} devices "
             f"({mesh.first_device.type})")
  try:
    slam = BadSlam(config, video, device=args.device, mesh=mesh)
  except (NotImplementedError, NoCudaDeviceError) as e:
    # Outside the slice, or --device cuda without a CUDA device.
    raise SystemExit(str(e)) from e
  if not args.quiet:
    log.info(f"Loaded {video.frame_count()} frames from {args.dataset} "
             f"({video.depth_camera.width}x{video.depth_camera.height}), "
             f"device {slam.device}")
  # The PreLoadThread of the reference (main.cc:569): PNG decoding ahead of
  # the frame loop.
  if video.enable_prefetch(pin_memory=slam.device.type == "cuda"):
    log.debug("decoding frames on a prefetching thread pool")
  try:
    return _run_slam(args, config, video, slam)
  finally:
    # A failing run must not hang on the BA or loop detector's thread.
    try:
      slam.stop_ba_thread_and_wait()
    finally:
      video.close_prefetch()


def _start_profiler(device):
  """A torch.profiler session over the CPU ops of every thread (the BA and
  loop-detection threads too) and, on a GPU, the kernels and copies of
  every CUDA stream; shapes and stacks are off, since a frame launches
  ~15,000 kernels."""
  from torch._C._profiler import _ExperimentalConfig
  from torch.profiler import ProfilerActivity, profile
  activities = [ProfilerActivity.CPU]
  if device.type == "cuda":
    activities.append(ProfilerActivity.CUDA)
  prof = profile(activities=activities,
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True))
  prof.start()
  return prof


def _stop_profiler(prof, device, out_dir: str, quiet: bool) -> None:
  """Stop the session once the device is done and write its trace into
  ``out_dir`` as badslam.<ns>.pt.trace.json.gz, the name TensorBoard's
  profile plugin looks for, at gzip level 1 (faster than the default 9;
  the trace of a whole run is large)."""
  import gzip
  import os
  import shutil
  import torch
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  t0 = time.perf_counter()
  prof.stop()
  os.makedirs(out_dir, exist_ok=True)
  path = os.path.join(out_dir, f"badslam.{time.time_ns()}.pt.trace.json.gz")
  raw = path[:-len(".gz")]
  prof.export_chrome_trace(raw)
  with open(raw, "rb") as f, gzip.open(path, "wb", compresslevel=1) as g:
    shutil.copyfileobj(f, g)
  os.remove(raw)
  if not quiet:
    print(f"Wrote profiler trace {path} ({os.path.getsize(path)} bytes in "
          f"{time.perf_counter() - t0:.2f} s)")


def _run_slam(args, config, video, slam) -> int:
  # jax.profiler's span in the reference: from the system's construction to
  # the last output. Stopped on the way out of a failing run too.
  prof = _start_profiler(slam.device) if args.profile_dir else None
  try:
    return _run_and_export(args, config, video, slam)
  finally:
    if prof is not None:
      _stop_profiler(prof, slam.device, args.profile_dir, args.quiet)


def _run_and_export(args, config, video, slam) -> int:
  from badslam_tpu_torch.io import dataset as dataset_io
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.io import state as state_io
  from badslam_tpu_torch.utils import logging as log
  from badslam_tpu_torch.utils.timing import Timing

  if args.device_accurate_timings:
    Timing.set_device_accurate(True)
  if args.save_timings:
    slam.direct_ba.timings_stream = open(args.save_timings, "w")
  if args.import_calibration:
    state_io.load_calibration(args.import_calibration, slam)
  if args.load_state:
    state_io.load_state(args.load_state, slam)
  if args.prewarm or args.prewarm_keyframes > 0:
    t_warm = time.perf_counter()
    slam.prewarm(max_ba_keyframes=(args.prewarm_keyframes or None))
    if not args.quiet:
      log.info(f"Prewarm finished in {time.perf_counter() - t_warm:.1f} s")

  end = min(video.frame_count() - 1, config.end_frame)
  t_start = time.perf_counter()
  frames_done = 0
  for frame_index in range(config.start_frame, end + 1):
    slam.process_frame(frame_index)
    slam.end_frame()
    video.frames[frame_index].clear_cache()
    frames_done += 1
    if not args.quiet and frames_done % 50 == 0:
      elapsed = time.perf_counter() - t_start
      # The surfel count is a device read of the map: under parallel BA it
      # belongs to the BA thread, so it waits for the end of the run, and
      # the pipelined front-end reads nothing in its loop.
      surfels = ("n/a" if slam._parallel or slam._pipelined
                 else slam.direct_ba.surfel_count)
      print(f"frame {frame_index}: {frames_done / elapsed:.1f} FPS, "
            f"{slam.direct_ba.keyframe_count} keyframes, "
            f"{surfels} surfels")

  # Stop the BA and the loop detector's threads before the final BA
  # (main.cc:723).
  slam.stop_ba_thread_and_wait()

  # Final BA (main.cc:724-770): windowed geometry-only passes, then global.
  if args.final_ba_iterations > 0:
    k = slam.direct_ba.keyframe_count
    window = 16
    for window_start in range(0, k, window // 2):
      slam.direct_ba.bundle_adjustment(
          do_surfel_updates=config.do_surfel_updates,
          optimize_poses=False, optimize_geometry=True,
          min_iterations=5, max_iterations=10,
          active_keyframe_window_start=window_start,
          active_keyframe_window_end=window_start + window - 1)
    for _ in range(args.final_ba_iterations):
      slam.direct_ba.bundle_adjustment(
          optimize_depth_intrinsics=config.optimize_intrinsics,
          optimize_color_intrinsics=config.optimize_intrinsics,
          do_surfel_updates=config.do_surfel_updates,
          optimize_poses=True, optimize_geometry=True,
          min_iterations=2, max_iterations=10,
          active_keyframe_window_start=0,
          active_keyframe_window_end=k - 1)
    slam.update_keyframe_poses_in_video()

  # A pipelined run's global poses, after the final BA, so that every frame
  # anchors to its base keyframe's final pose.
  slam.finalize_pipelined()

  if not args.quiet:
    elapsed = time.perf_counter() - t_start
    print(f"Done: {frames_done} frames in {elapsed:.1f} s "
          f"({frames_done / max(elapsed, 1e-9):.1f} FPS), "
          f"{slam.direct_ba.keyframe_count} keyframes, "
          f"{slam.direct_ba.surfel_count} surfels")
    print(f"Surfel store: watermark {slam.direct_ba.surfel_watermark} of "
          f"capacity {slam.direct_ba.surfel_capacity}; keyframe store: "
          f"capacity {slam.direct_ba.kf.capacity}")
    if slam.loop_detector is not None:
      print(f"Loops closed: {slam.loop_detector.num_loops_closed}, "
            f"ignored: {slam.loop_detector.num_loops_ignored}")
  if args.export_point_cloud:
    pos, nrm, col = slam.direct_ba.export_point_cloud()
    ply.save_point_cloud_ply(args.export_point_cloud, pos, nrm, col)
  if args.export_poses:
    ts, poses = slam.trajectory()
    dataset_io.save_tum_trajectory(args.export_poses, ts, poses)
  if args.export_calibration:
    state_io.save_calibration(args.export_calibration, slam)
  if args.export_final_timings:
    Timing.export_file(args.export_final_timings)
  if args.save_state:
    state_io.save_state(args.save_state, slam)
  if args.export_reconstruction:
    export_reconstruction(slam, args.export_reconstruction,
                          args.reconstruction_sparsification,
                          quiet=args.quiet)
  if args.render_preview:
    from badslam_tpu_torch import render
    n = render.render_keyframe_previews(
        slam, args.render_preview, mode=args.render_mode,
        splat_half_extent_in_pixels=args.splat_half_extent_in_pixels,
        every=args.render_every, quiet=args.quiet)
    if not args.quiet:
      print(f"Rendered {n} keyframe previews into {args.render_preview}")
  if slam.direct_ba.timings_stream is not None:
    slam.direct_ba.timings_stream.close()
    slam.direct_ba.timings_stream = None
  return 0


def export_reconstruction(slam, path: str, reconstruction_cell_size: int,
                          quiet: bool = False) -> None:
  """The high-resolution surfel reconstruction (main.cc:796-855): resample
  the cfactor grid to the reconstruction cell size, run windowed
  geometry-only BA without descriptor residuals, so that surfels densify at
  the finer cell size, and export the cloud as PLY; the densified map is
  kept, as in the reference.

  The new grid has another shape, so it cannot be written into the shared
  calibration in place: the back-end reads a new ``DepthCalibration`` (the
  resampled grid and the new cell size, copies of the intrinsics, a and
  baseline) during the export, and gets its original object back after it.
  The front-end never reads the new one: it runs before the export."""
  from badslam_tpu_torch.io import ply
  from badslam_tpu_torch.models.calibration import DepthCalibration
  from badslam_tpu_torch.ops import depth_model

  ba = slam.direct_ba
  original = ba.calibration
  old_desc = ba.use_descriptor_residuals
  w, h = original.depth_size
  shape = depth_model.cfactor_shape(h, w, reconstruction_cell_size)
  ba.calibration = DepthCalibration(
      original.depth_intr.clone(), original.a.clone(),
      depth_model.resize_cfactor(original.cfactor, shape),
      original.baseline_fx.clone(), reconstruction_cell_size, (w, h))
  ba.use_descriptor_residuals = False
  try:
    # Sliding-window geometry-only BA (main.cc:819-843): the active window
    # bounds the surfels created per step.
    window = 16
    for window_start in range(0, max(ba.keyframe_count, 1), window // 2):
      ba.bundle_adjustment(
          do_surfel_updates=True, optimize_poses=False,
          optimize_geometry=True, min_iterations=5, max_iterations=10,
          active_keyframe_window_start=window_start,
          active_keyframe_window_end=window_start + window - 1)
      if not quiet:
        print(f"reconstruction window {window_start}: "
              f"{ba.surfel_count} surfels")
    pos, nrm, col = ba.export_point_cloud()
    ply.save_point_cloud_ply(path, pos, nrm, col)
  finally:
    ba.calibration = original
    ba.use_descriptor_residuals = old_desc


def main(argv=None) -> int:
  return run(build_parser().parse_args(argv))


if __name__ == "__main__":
  sys.exit(main())
