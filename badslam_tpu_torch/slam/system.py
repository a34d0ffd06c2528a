"""BadSlam front-end: the per-frame SLAM pipeline with sequential BA.

Port of the sequential path of ``badslam_tpu/slam/system.py``
(bad_slam.cc of the original BAD SLAM):
  ProcessFrame         preprocess, odometry against the base keyframe,
                       keyframe creation every keyframe_interval frames,
                       then the planned bundle-adjustment iterations
  PreprocessFrame      u16 depth to metres and RGB to intensity on the
                       device, then the fused depth preprocess (hand-written
                       CUDA kernel on a GPU, its plain chain on the CPU)
  PredictFramePose     two constant-velocity hypotheses, orthonormalized
  RunOdometry          calibrate, build pyramids, coarse-to-fine pairwise
                       tracking, tracking-failure gate
  CreateKeyframe       register the keyframe in the map (the first one
                       creates surfels unfiltered), rebase the motion-model
                       history, plan BA iterations
  RunBundleAdjustment  alternating BA over the map, then the trajectory
                       deformation of the frames between keyframes

Configurations outside the port so far (loop detection, the parallel BA
thread, PCG, intrinsics optimization, the pipelined front-end) are refused
in ``BadSlam.__init__``, each naming the ROADMAP item that will port it.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.io.dataset import RGBDVideo
from badslam_tpu_torch.loop.trajectory_deformation import (
    extrapolate_and_interpolate_keyframe_pose_changes)
from badslam_tpu_torch.models import odometry as odometry_mod
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import depth_model, image_proc
from badslam_tpu_torch.ops.fused_preprocess import fused_depth_preprocess
from badslam_tpu_torch.ops.pyramid import build_pyramid
from badslam_tpu_torch.slam.direct_ba import DirectBA, unported
from badslam_tpu_torch.utils import logging as log
from badslam_tpu_torch.utils.timing import Timing


class ProcessedFrame(NamedTuple):
  """Output of PreprocessFrame: everything a keyframe needs (on the
  device)."""
  depth: torch.Tensor      # (H, W) filtered raw metric depth, 0 = invalid
  raw_depth: torch.Tensor  # (H, W) unfiltered raw metric depth (odometry)
  normals: torch.Tensor    # (H, W, 2)
  radius_sq: torch.Tensor  # (H, W)
  intensity: torch.Tensor  # (H, W) in [0, 1]
  rgb: torch.Tensor        # (H, W, 3) uint8


class NoCudaDeviceError(RuntimeError):
  """The run was to compute on the CUDA device and none is visible."""


def check_supported(config: BadSlamConfig, device: torch.device) -> None:
  """Raise NotImplementedError for a configuration outside the slice."""
  refusals = [
      (config.enable_loop_detection,
       "loop detection (pass --no_loop_detection)", 'item 7 "Loop closure"'),
      (config.parallel_ba,
       "parallel BA (pass --sequential_ba)", 'item 6 "Threads"'),
      (config.pipelined_frontend or config.pipelined_concurrent_ba,
       "--pipelined_frontend", 'item 10 "Pipelined front-end"'),
      (config.use_pcg, "--use_pcg", 'item 8 "Self-calibration and PCG"'),
      (config.optimize_intrinsics, "--optimize_intrinsics",
       'item 8 "Self-calibration and PCG"'),
      (config.median_filter_and_densify_iterations > 0,
       "--median_filter_and_densify_iterations > 0",
       'item 5 "Sequential system and CLI"'),
      (config.pyramid_level_for_depth > 0 or config.pyramid_level_for_color > 0,
       "--pyramid_level_for_depth/--pyramid_level_for_color > 0",
       'item 5 "Sequential system and CLI"'),
      (not config.estimate_poses, "--no_pose_estimation",
       'item 5 "Sequential system and CLI"'),
  ]
  for refused, what, item in refusals:
    if refused:
      raise NotImplementedError(unported(what, item))
  if device.type == "cuda" and not config.use_pallas_preprocess:
    raise NotImplementedError(
        "--no_pallas_preprocess on a CUDA device: there the plain "
        "preprocess chain is only the fused kernel's test reference")


class BadSlam:
  """The system orchestrator (class BadSlam, bad_slam.h), sequential path.
  It computes on ``device``: the CUDA device when none is named, the CPU
  only when the caller asks for it."""

  def __init__(self, config: BadSlamConfig, rgbd_video: RGBDVideo,
               device=None):
    self.device = torch.device("cuda" if device is None else device)
    if self.device.type == "cuda" and not torch.cuda.is_available():
      raise NoCudaDeviceError(
          "no CUDA device is visible (torch.cuda.is_available() is False); "
          "BadSlam runs on the GPU unless the caller passes device=\"cpu\" "
          "(--device cpu)")
    check_supported(config, self.device)
    self.config = config
    self.rgbd_video = rgbd_video
    # The one depth calibration: preprocessing, odometry and the back-end
    # all read this object.
    self.calibration = DepthCalibration.initial(
        rgbd_video.depth_camera, config.sparse_surfel_cell_size,
        config.depth_deformation_a, config.baseline_fx, self.device)
    self.direct_ba = DirectBA(
        config, rgbd_video.depth_camera, rgbd_video.color_camera,
        device=self.device, calibration=self.calibration)

    # Base keyframe: its slot in the keyframe store, pose, images, and the
    # motion-model history (<= 3 relative poses, base_kf_T_frame and its
    # inverse).
    self.base_kf_index: Optional[int] = None
    self.base_kf_images: Optional[ProcessedFrame] = None
    self.base_kf_global_T_frame = np.eye(4, dtype=np.float32)
    self.base_kf_tr_frame: List[np.ndarray] = []
    self.frame_tr_base_kf: List[np.ndarray] = []

    self.num_planned_ba_iterations = 0
    self.ba_counter = 0
    self.last_frame_index = -1
    # frame_index of each keyframe slot (for the trajectory deformation).
    self.keyframe_frame_indices: List[int] = []
    # Real-time pacing state (EndFrame, bad_slam.cc:449-479).
    self._actual_frame_start_time = 0.0
    self._target_frame_end_time = 0.0
    self._frame_timer_start: Optional[float] = None

  # --- per-frame pipeline ---

  def process_frame(self, frame_index: int, force_keyframe: bool = False):
    """ProcessFrame (bad_slam.cc:170-279)."""
    cfg = self.config
    self._frame_timer_start = time.perf_counter()
    if cfg.target_frame_rate > 0:
      self._target_frame_end_time += 1.0 / cfg.target_frame_rate

    with Timing.time("Preprocessing"):
      processed = self.preprocess_frame(frame_index)

    if self.base_kf_images is not None:
      with Timing.time("Odometry"):
        self.run_odometry(frame_index, processed)
    else:
      self.last_frame_index = max(self.last_frame_index, frame_index)

    create_keyframe = (
        force_keyframe
        or (frame_index - cfg.start_frame) % cfg.keyframe_interval == 0)
    if create_keyframe:
      with Timing.time("Keyframe creation"):
        self.create_keyframe(frame_index, processed)

    if self.num_planned_ba_iterations > 0:
      # Real-time budget: sequential BA only starts with frame time left
      # (bad_slam.cc:213-219).
      if cfg.target_frame_rate > 0:
        elapsed = time.perf_counter() - self._frame_timer_start
        if (self._actual_frame_start_time + elapsed
            >= self._target_frame_end_time):
          return
      self.ba_counter += 1
      deadline = None
      if cfg.target_frame_rate > 0:
        # The rest of the frame's time as an absolute deadline
        # (bad_slam.cc:269).
        deadline = (self._frame_timer_start
                    + (self._target_frame_end_time
                       - self._actual_frame_start_time))
      iterations_done, converged = self.run_bundle_adjustment(
          self.num_planned_ba_iterations, deadline=deadline,
          increase_ba_iteration_count=(cfg.target_frame_rate == 0))
      if converged:
        self.num_planned_ba_iterations = 0
      else:
        self.num_planned_ba_iterations = max(
            0, self.num_planned_ba_iterations - iterations_done)

  def end_frame(self):
    """EndFrame: pace playback to fps_restriction; in real-time mode
    (target_frame_rate > 0) allow catching up when behind."""
    if self._frame_timer_start is None:
      return
    actual_frame_time = time.perf_counter() - self._frame_timer_start
    cfg = self.config
    if cfg.fps_restriction > 0:
      min_frame_time = 1.0 / cfg.fps_restriction
      if cfg.target_frame_rate > 0:
        min_frame_time = min(
            min_frame_time,
            self._target_frame_end_time - self._actual_frame_start_time)
      if actual_frame_time < min_frame_time:
        time.sleep(min_frame_time - actual_frame_time)
        self._actual_frame_start_time += min_frame_time
      else:
        self._actual_frame_start_time += actual_frame_time
    else:
      self._actual_frame_start_time += actual_frame_time
      if self._actual_frame_start_time < self._target_frame_end_time:
        self._actual_frame_start_time = self._target_frame_end_time

  def preprocess_frame(self, frame_index: int) -> ProcessedFrame:
    """PreprocessFrame (bad_slam.cc:688-761). The u16 counts go to the
    device as float32 (exact) and are scaled to metres there, as the
    reference converts on the device."""
    cfg = self.config
    video = self.rgbd_video
    raw = video.frames[frame_index].depth_raw()
    raw_scale = 1.0
    if raw.dtype == np.uint16:
      raw_scale = float(video.raw_to_float_depth)
      raw = raw.astype(np.float32)
    else:
      raw = raw.astype(np.float32) * video.raw_to_float_depth
    raw_depth = torch.from_numpy(raw).to(self.device)
    if raw_scale != 1.0:
      raw_depth = raw_depth * raw_scale
    rgb = torch.from_numpy(video.frames[frame_index].rgb()).to(self.device)
    filtered, normals, radius_sq = fused_depth_preprocess(
        raw_depth, self.calibration,
        sigma_xy=cfg.bilateral_filter_sigma_xy,
        sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
        radius_factor=cfg.bilateral_filter_radius_factor,
        max_depth=cfg.max_depth)
    return ProcessedFrame(
        depth=filtered, raw_depth=raw_depth, normals=normals,
        radius_sq=radius_sq, intensity=image_proc.rgb_to_intensity(rgb),
        rgb=rgb)

  def predict_frame_pose(self) -> Tuple[np.ndarray, np.ndarray]:
    """Two constant-velocity hypotheses (bad_slam.cc:763-825), as
    base_kf_T_frame estimates."""
    hist = self.base_kf_tr_frame
    inv_hist = self.frame_tr_base_kf
    n = len(hist)
    if self.config.use_motion_model:
      est1 = (hist[n - 1] @ inv_hist[n - 2] @ hist[n - 1] if n >= 2
              else hist[n - 1])
      if n >= 3:
        prev_T_last = inv_hist[n - 3] @ hist[n - 2]
        est2 = hist[n - 2] @ prev_T_last @ prev_T_last
      else:
        est2 = est1
    else:
      est1 = est2 = hist[n - 1]

    def sane(e):
      # A non-finite or absurd prediction falls back to the last relative
      # pose; otherwise renormalize (the motion model squares relative
      # poses, doubling any rotation defect per frame).
      if not np.isfinite(e).all() or np.linalg.norm(e[:3, 3]) > 10.0:
        return (hist[n - 1] if np.isfinite(hist[n - 1]).all()
                else np.eye(4, dtype=np.float32))
      return se3_np.orthonormalize(e)
    return sane(est1), sane(est2)

  def run_odometry(self, frame_index: int, processed: ProcessedFrame):
    """RunOdometry (bad_slam.cc:827-951): the tracked side uses the
    unfiltered depth, the base side the keyframe's filtered depth, both
    calibrated."""
    cfg = self.config
    calib = self.calibration
    est1, est2 = self.predict_frame_pose()
    w, h = calib.depth_size

    base = self.base_kf_images
    base_intensity, tracked_intensity = base.intensity, processed.intensity
    residual_type = "gradient_xy"
    if cfg.use_gradmag_for_tracking:
      residual_type = "gradmag"
      base_intensity = image_proc.sobel_gradient_magnitude(base_intensity)
      tracked_intensity = image_proc.sobel_gradient_magnitude(
          tracked_intensity)
    base_pyr = build_pyramid(
        depth_model.calibrate_depth_image(calib.a, calib.cfactor, base.depth,
                                          calib.cell_size),
        base.normals, base_intensity, cfg.num_scales)
    tracked_pyr = build_pyramid(
        depth_model.calibrate_depth_image(calib.a, calib.cfactor,
                                          processed.raw_depth,
                                          calib.cell_size),
        processed.normals, tracked_intensity, cfg.num_scales)
    base_T_frame, n_resid = odometry_mod.track_frame_pairwise(
        base_pyr, tracked_pyr, calib.camera(), calib.baseline_fx,
        torch.as_tensor(est1, device=self.device),
        torch.as_tensor(est2, device=self.device),
        test_different_initial_estimates=True,
        use_depth_residuals=cfg.use_geometric_residuals,
        use_descriptor_residuals=cfg.use_photometric_residuals,
        use_pyramid_level_0=True,
        convergence_threshold=cfg.odometry_convergence_threshold,
        residual_type=residual_type)
    # Per-frame host reads, as in the reference: renormalize the result
    # (it feeds the motion model) and read the residual count.
    base_T_frame = se3_np.orthonormalize(base_T_frame.cpu().numpy())
    n_resid = int(n_resid)
    # Tracking-failure gate: almost no associated pixels in the last GN
    # iteration, a non-finite pose or an implausible jump means the
    # estimate never entered the association basin; hold the last accepted
    # relative pose instead of letting the motion model extrapolate it.
    min_resid = max(50, (w * h) // 100)
    prev_rel = (self.base_kf_tr_frame[-1] if self.base_kf_tr_frame
                else np.eye(4, dtype=np.float32))
    frame_speed = float(np.linalg.norm(base_T_frame[:3, 3] - prev_rel[:3, 3]))
    if (not np.isfinite(base_T_frame).all() or n_resid < min_resid
        or frame_speed > cfg.max_translation_per_frame):
      log.warning(f"tracking failed at frame {frame_index} "
                  f"({n_resid} residuals, {frame_speed:.2f} m moved); "
                  "holding last pose")
      base_T_frame = prev_rel

    self.rgbd_video.frames[frame_index].global_T_frame = (
        self.base_kf_global_T_frame @ base_T_frame)
    self.last_frame_index = frame_index
    if len(self.base_kf_tr_frame) >= 3:
      self.base_kf_tr_frame.pop(0)
      self.frame_tr_base_kf.pop(0)
    self.base_kf_tr_frame.append(base_T_frame)
    self.frame_tr_base_kf.append(se3_np.inverse(base_T_frame))

  def _add_keyframe_to_ba(self, processed: ProcessedFrame, frame_index: int,
                          global_T_frame: np.ndarray) -> int:
    """AddKeyframeToBA (bad_slam.cc:1120-1158): register the keyframe in the
    store; the first keyframe creates its surfels unfiltered."""
    ba = self.direct_ba
    idx = ba.add_keyframe(
        processed.depth, processed.normals, processed.radius_sq,
        processed.intensity, processed.rgb, global_T_frame, frame_index)
    self.keyframe_frame_indices.append(frame_index)
    if ba.keyframe_count == 1:
      # bad_slam.cc:1087-1094
      ba.create_surfels_for_keyframe(idx, filter_new_surfels=False)
    elif not self.config.do_surfel_updates:
      ba.create_surfels_for_keyframe(idx, filter_new_surfels=True)
    return idx

  def create_keyframe(self, frame_index: int, processed: ProcessedFrame):
    """CreateKeyframe (bad_slam.cc:953-1097)."""
    global_T_frame = np.asarray(
        self.rgbd_video.frames[frame_index].global_T_frame)
    self.base_kf_index = self._add_keyframe_to_ba(processed, frame_index,
                                                  global_T_frame)
    self.base_kf_global_T_frame = global_T_frame
    self.base_kf_images = processed

    # Rebase the motion-model history onto the new base keyframe
    # (bad_slam.cc:1062-1075).
    if self.base_kf_tr_frame:
      last = self.base_kf_tr_frame[-1]
      last_inv = self.frame_tr_base_kf[-1]
      for k in range(len(self.base_kf_tr_frame) - 1):
        self.frame_tr_base_kf[k] = se3_np.orthonormalize(
            self.frame_tr_base_kf[k] @ last)
        self.base_kf_tr_frame[k] = se3_np.orthonormalize(
            last_inv @ self.base_kf_tr_frame[k])
      self.base_kf_tr_frame[-1] = np.eye(4, dtype=np.float32)
      self.frame_tr_base_kf[-1] = np.eye(4, dtype=np.float32)
    else:
      self.base_kf_tr_frame.append(np.eye(4, dtype=np.float32))
      self.frame_tr_base_kf.append(np.eye(4, dtype=np.float32))

    if self.direct_ba.keyframe_count >= 2:
      self.num_planned_ba_iterations += (
          self.config.max_num_ba_iterations_per_keyframe)

  # --- bundle adjustment ---

  def run_bundle_adjustment(self, max_iterations: int,
                            deadline: Optional[float] = None,
                            increase_ba_iteration_count: bool = True,
                            ) -> Tuple[int, bool]:
    """RunBundleAdjustment, sequential path (bad_slam.cc:481-536). In
    real-time mode the caller passes the frame deadline (perf_counter time)
    and increase_ba_iteration_count=False (bad_slam.cc:264-270)."""
    cfg = self.config
    k = self.direct_ba.keyframe_count
    # A host copy: the poses as they were before BA moved them.
    original = self.direct_ba.kf.global_T_frame.cpu().numpy().copy()
    with Timing.time("Bundle adjustment"):
      result = self.direct_ba.bundle_adjustment(
          do_surfel_updates=cfg.do_surfel_updates,
          optimize_poses=True,
          optimize_geometry=True,
          min_iterations=0,
          max_iterations=max_iterations,
          active_keyframe_window_start=0 if cfg.disable_deactivation else -1,
          active_keyframe_window_end=(
              (k - 1) if cfg.disable_deactivation else -1),
          increase_ba_iteration_count=increase_ba_iteration_count,
          deadline=deadline)
    self._apply_trajectory_deformation(original)
    return result

  def _apply_trajectory_deformation(self, original_kf_poses: np.ndarray):
    """Propagate the keyframes' pose changes to the frames between them and
    refresh the cached base-keyframe pose (bad_slam.cc:524-530)."""
    new_poses = self.direct_ba.kf.global_T_frame.cpu().numpy()
    n_kf = len(self.keyframe_frame_indices)
    if n_kf and self.last_frame_index >= 0:
      frame_poses = [f.global_T_frame for f in self.rgbd_video.frames]
      orig_frame_T_global = se3_np.inverse(original_kf_poses[:n_kf])
      for slot in range(n_kf):
        frame_poses[self.keyframe_frame_indices[slot]] = new_poses[slot]
      extrapolate_and_interpolate_keyframe_pose_changes(
          self.keyframe_frame_indices, orig_frame_T_global,
          new_poses[:n_kf], frame_poses,
          start_frame=self.config.start_frame,
          end_frame=self.last_frame_index)
      for i, p in enumerate(frame_poses):
        self.rgbd_video.frames[i].global_T_frame = p
    if self.base_kf_index is not None:
      self.base_kf_global_T_frame = new_poses[self.base_kf_index]

  def update_keyframe_poses_in_video(self):
    """Write the optimized keyframe poses back to the video frames."""
    poses = self.direct_ba.kf.global_T_frame.cpu().numpy()
    for slot, frame_index in enumerate(self.keyframe_frame_indices):
      self.rgbd_video.frames[frame_index].global_T_frame = poses[slot]

  # --- trajectory access ---

  def trajectory(self) -> Tuple[List[float], List[np.ndarray]]:
    """(timestamps, global_T_frame) for all processed frames."""
    ts, poses = [], []
    for f in self.rgbd_video.frames[: self.last_frame_index + 1]:
      ts.append(f.depth_timestamp)
      poses.append(f.global_T_frame)
    return ts, poses
