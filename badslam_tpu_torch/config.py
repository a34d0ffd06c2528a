"""Configuration of the PyTorch port.

The port's own copy of ``badslam_tpu/config.py``: the same dataclasses with
every field, type and default (``tests/test_torch_config.py`` holds the two
against each other), so a configuration means the same in both packages.
The fields mirror the original BAD SLAM's ``BadSlamConfig``
(bad_slam_config.h:41-374); sensor and GUI fields are dropped. The capacity
fields at the end exist because the JAX package needs static shapes; the
port keeps them so that stores compare array for array.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class BadSlamConfig:
  # --- Dataset playback (bad_slam_config.h:48-72) ---
  raw_to_float_depth: float = 1.0 / 5000.0
  start_frame: int = 0
  end_frame: int = 2**31 - 1
  target_frame_rate: float = 0.0
  fps_restriction: int = 30

  # --- Depth preprocessing (bad_slam_config.h:78-122) ---
  pyramid_level_for_depth: int = 0
  pyramid_level_for_color: int = 0
  max_depth: float = 3.0
  baseline_fx: float = 40.0
  median_filter_and_densify_iterations: int = 0
  bilateral_filter_sigma_xy: float = 1.5
  bilateral_filter_radius_factor: float = 2.0
  bilateral_filter_sigma_inv_depth: float = 0.005

  # --- Surfel reconstruction (bad_slam_config.h:130-158) ---
  max_surfel_count: int = 25 * 1000 * 1000
  sparse_surfel_cell_size: int = 4
  surfel_merge_dist_factor: float = 0.8
  min_observation_count_while_bootstrapping_1: int = 1
  min_observation_count_while_bootstrapping_2: int = 2
  min_observation_count: int = 3

  # --- Odometry (bad_slam_config.h:167-179) ---
  num_scales: int = 5
  use_motion_model: bool = True
  keyframe_interval: int = 10
  # Convergence threshold of the multi-scale odometry GN
  # (convergence_analysis.h:56-63; the reference's 1e-8 was tuned for
  # 640x480 — tighten at lower resolutions to avoid plateau stalls).
  odometry_convergence_threshold: float = 1e-8
  # Pairwise-tracking photometric residual: False = x/y-gradient descriptor
  # pair (paper default), True = gradient-magnitude residual (the reference
  # keeps this as a compile-time constant, bad_slam.cc:831).
  use_gradmag_for_tracking: bool = False
  # Tracking-failure gate: an accepted frame-to-frame camera movement larger
  # than this (meters/frame; 0.5 m/frame = 15 m/s at 30 FPS) is treated as
  # tracking failure instead of being fed to the constant-velocity motion
  # model, whose extrapolation would otherwise double the error every frame
  # (the runaway the reference README calls "potentially unstable").
  max_translation_per_frame: float = 0.5

  # --- Bundle adjustment (bad_slam_config.h:185-245) ---
  max_num_ba_iterations_per_keyframe: int = 10
  disable_deactivation: bool = True
  use_geometric_residuals: bool = True
  use_photometric_residuals: bool = True
  optimize_intrinsics: bool = False
  intrinsics_optimization_interval: int = 10
  do_surfel_updates: bool = True
  parallel_ba: bool = True
  use_pcg: bool = False
  # Transfer-free front-end: the per-frame state machine (motion model,
  # failure gates, trajectory) stays on device and BA never reads its
  # convergence scalar, so the whole run performs zero device->host
  # transfers until finalize_pipelined(). Implies sequential BA and skips
  # the memory watchdog (not ported yet).
  pipelined_frontend: bool = False
  # Pipelined + concurrent BA: dispatch the per-frame transfer-free BA
  # iterations from a dedicated host thread instead of the frame critical
  # path (the BAThreadMain analog, bad_slam.cc:1192-1313, without the
  # keyframe-queue readbacks — keyframes are still registered inline by the
  # main thread). The frame loop then never waits on BA dispatch; device
  # execution still serializes on one chip, but under a target_frame_rate
  # budget BA fills the idle device time between frames.
  pipelined_concurrent_ba: bool = False
  # Fused preprocess kernel (ops/fused_preprocess.py; the name is the JAX
  # package's, whose kernel is written in Pallas): always used on a CUDA
  # device. False asks for the plain stencil chain, which the port runs
  # on the CPU only.
  use_pallas_preprocess: bool = True
  estimate_poses: bool = True
  min_free_gpu_memory_mb: int = 250

  # --- Loop closure (bad_slam_config.h:253-274) ---
  enable_loop_detection: bool = True
  parallel_loop_detection: bool = True
  loop_detection_image_frequency: float = 0.0

  # --- Memory / depth deformation ---
  # Global depth-deformation factor alpha_1 initial value (DepthParameters.a).
  depth_deformation_a: float = 0.0

  # --- Static capacities (the JAX package needs static shapes) ---
  # Keyframe store starting capacity; grows by doubling (bounded recompiles).
  initial_keyframe_capacity: int = 16
  # Surfel store starting capacity; grows by doubling up to max_surfel_count.
  # Kept tight on purpose: dense phases cost O(capacity), so an oversized
  # store taxes every BA iteration — growth doubling bounds capacity to <2x
  # the live watermark.
  initial_surfel_capacity: int = 1 << 16
  # PCG solver settings (bad_slam.h:132-133 defaults).
  pcg_max_inner_iterations: int = 30
  pcg_max_keyframe_count: int = 2500
  # Gather active+covisible keyframes into a power-of-two window before the
  # O(K x surfels) BA phases so device work scales with the active set (the
  # reference's activation windowing, direct_ba_alternating.cc:543-577).
  use_active_kf_window: bool = True

  def get_loop_detection_image_frequency(self, dataset_fps: float = 30.0) -> float:
    """bad_slam_config.h:367-370: falls back to the dataset frame rate."""
    if self.loop_detection_image_frequency != 0:
      return self.loop_detection_image_frequency
    return dataset_fps / max(1, self.keyframe_interval)


# Depth parameters pack (surfel_projection.cuh:129-149): the subset of state
# that the intrinsics optimization mutates. Kept separate from the config so it
# can live on the device.
@dataclasses.dataclass
class DepthParams:
  a: float = 0.0               # global deformation factor alpha_1
  baseline_fx: float = 40.0
  sparse_surfel_cell_size: int = 4
