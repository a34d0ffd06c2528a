"""DirectBA: the SLAM back-end, a surfel map and the direct bundle adjustment
that alternates over it.

Port of ``badslam_tpu/slam/direct_ba.py`` (class DirectBA, direct_ba.{h,cc},
and ``BundleAdjustmentAlternating``, direct_ba_alternating.cc:285-740 of the
original BAD SLAM). Covisibility: direct_ba.cc:231-249; the min-observation
bootstrapping schedule: direct_ba.h:219-226; end-of-scheme tasks:
direct_ba.cc:566-653.

  * All map state (SurfelStore, KeyframeStore, DepthCalibration) lives on
    one device, named at construction. Host code runs the alternation
    schedule and reads back small scalars: the activation states once per
    iteration, the surfel count and watermark after lifecycle ops, one
    convergence flag per pose GN iteration.
  * Each phase loops in Python over the keyframe slots that take part, so
    device work scales with the active set and there is no active-keyframe
    window to gather (``config.use_active_kf_window`` changes nothing).
  * Deletion and merging clear validity masks; compaction runs at the end
    of a scheme when a quarter of the store is dead slots.
  * Every reduction is a sum in a fixed order, an integer ``amin`` or a
    float32 matrix product: two runs from one state give the same bits.

Not ported, each refused where a caller could reach it: the PCG step
(ROADMAP queue 1 item 8), intrinsics optimization (item 8), the surfel
store sharded over a device mesh (item 11) and the transfer-free mode of
the pipelined front-end (item 10).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models import (geometry_opt, keyframes as kf_mod,
                                      pose_opt, surfel_ops,
                                      surfels as surfels_mod)
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import (ACTIVE, COVISIBLE_ACTIVE,
                                                INACTIVE, KeyframeStore)
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops.depth_proc import compute_min_max_depth
from badslam_tpu_torch.utils import logging as log
from badslam_tpu_torch.utils.timing import Timing

# kDebugVerifySurfelCount (direct_ba.cc:55): recount on the device and CHECK
# the host mirrors after every BA scheme.
DEBUG_VERIFY_COUNT = bool(os.environ.get("BADSLAM_DEBUG_VERIFY_COUNT"))


def unported(what: str, item: str) -> str:
  return (f"{what} is not ported to badslam_tpu_torch yet "
          f"(ROADMAP queue 1, {item}); use badslam_tpu for it")


def make_camera(intr: torch.Tensor, width: int, height: int) -> PinholeCamera:
  """A camera with intrinsics as 0-d views of a (4,) device tensor."""
  return PinholeCamera(width, height, intr[0], intr[1], intr[2], intr[3])


def camera_intrinsics(cam: PinholeCamera, device) -> torch.Tensor:
  return torch.tensor([float(cam.fx), float(cam.fy), float(cam.cx),
                       float(cam.cy)], dtype=torch.float32, device=device)


def determine_covisible_active(kf: KeyframeStore) -> KeyframeStore:
  """Inactive keyframes covisible with an active one become covisible-active
  (DirectBA::DetermineCovisibleActiveKeyframes, direct_ba.cc:549-564)."""
  active = kf.valid & (kf.activation == ACTIVE)
  touched = torch.any(kf.covis & active[None, :], dim=1)
  return kf._replace(activation=torch.where(
      kf.valid & (kf.activation == INACTIVE) & touched,
      COVISIBLE_ACTIVE, kf.activation))


class DirectBA:
  """Host-side orchestrator that owns the device map state (the public
  surface of the original's DirectBA, direct_ba.h:65-550: AddKeyframe,
  CreateSurfelsForKeyframe, BundleAdjustment, PerformBASchemeEndTasks,
  accessors)."""

  def __init__(
      self,
      config: BadSlamConfig,
      depth_cam: PinholeCamera,
      color_cam: PinholeCamera,
      keyframe_capacity: Optional[int] = None,
      surfel_capacity: Optional[int] = None,
      device=None,
      calibration: Optional[DepthCalibration] = None,
  ):
    """``device`` is where every store is allocated (``cuda`` when none is
    named). ``calibration`` is the depth calibration to read, shared with
    the front-end; without one a new map's initial state is made."""
    self.config = config
    self.device = torch.device("cuda" if device is None else device)
    self.depth_size = (depth_cam.width, depth_cam.height)
    self.color_size = (color_cam.width, color_cam.height)
    if calibration is None:
      calibration = DepthCalibration.initial(
          depth_cam, config.sparse_surfel_cell_size,
          config.depth_deformation_a, config.baseline_fx, self.device)
    self.calibration = calibration
    self.color_intr = camera_intrinsics(color_cam, self.device)

    kcap = keyframe_capacity or config.initial_keyframe_capacity
    scap = surfel_capacity or config.initial_surfel_capacity
    self.kf = kf_mod.create(kcap, depth_cam.height, depth_cam.width,
                            self.device)
    self.surfels = surfels_mod.create(scap, self.device)

    # Host mirrors. Reading a device scalar waits for the device, so counts
    # are tracked on the host, and the surfel count is cached per ``valid``
    # tensor: the stores replace a field that changes, so the identity of
    # the tensor says whether the cached number still holds.
    self._kf_count_host = 0
    self._kf_valid_host = np.zeros(kcap, bool)
    self._surfel_count_cache = (None, 0)
    self._surfel_watermark_cache = (None, 0)
    # Host-side upper bound on the surfel watermark (see
    # _ensure_surfel_capacity), re-synced whenever the watermark is read.
    self._watermark_bound = 0
    # --save_timings stream (direct_ba.h:382): one line per BA iteration.
    self.timings_stream = None

    self.ba_iteration_count = 0
    self.last_ba_iteration_count = -1
    # Surfels invalidated by the end-of-scheme delete pass.
    self.num_surfels_deleted = 0
    # Per slot, the BA scheme in which the keyframe was last active
    # (Keyframe::last_active_in_ba_iteration).
    self.last_active_in_ba_iteration = np.full(kcap, -1, np.int64)
    self.use_depth_residuals = config.use_geometric_residuals
    self.use_descriptor_residuals = config.use_photometric_residuals
    self.surfel_merge_dist_factor = config.surfel_merge_dist_factor

  # --- state carried across ---

  @classmethod
  def from_numpy(cls, config: BadSlamConfig, depth_cam: PinholeCamera,
                 color_cam: PinholeCamera, surfels: Dict[str, np.ndarray],
                 kf: Dict[str, np.ndarray], calibration: DepthCalibration,
                 host_state: Dict[str, object], device) -> "DirectBA":
    """A back-end that continues from another one's state: the two stores
    as host arrays named like their fields, the calibration, and the host
    mirrors (``_kf_count_host``, ``_kf_valid_host``,
    ``last_active_in_ba_iteration``, ``ba_iteration_count``,
    ``last_ba_iteration_count``)."""
    ba = cls(config, depth_cam, color_cam, keyframe_capacity=1,
             surfel_capacity=1, device=device, calibration=calibration)
    ba.surfels = surfels_mod.from_numpy(surfels, ba.device)
    ba.kf = kf_mod.from_numpy(kf, ba.device)
    ba._kf_count_host = int(host_state["_kf_count_host"])
    ba._kf_valid_host = np.array(host_state["_kf_valid_host"], bool)
    ba.last_active_in_ba_iteration = np.array(
        host_state["last_active_in_ba_iteration"], np.int64)
    ba.ba_iteration_count = int(host_state["ba_iteration_count"])
    ba.last_ba_iteration_count = int(host_state["last_ba_iteration_count"])
    ba._watermark_bound = ba.surfel_watermark
    return ba

  def to_numpy(self):
    """(surfels, kf, host_state): what ``from_numpy`` takes."""
    host_state = {
        "_kf_count_host": self._kf_count_host,
        "_kf_valid_host": self._kf_valid_host.copy(),
        "last_active_in_ba_iteration":
            self.last_active_in_ba_iteration.copy(),
        "ba_iteration_count": self.ba_iteration_count,
        "last_ba_iteration_count": self.last_ba_iteration_count,
    }
    return (surfels_mod.to_numpy(self.surfels), kf_mod.to_numpy(self.kf),
            host_state)

  # --- accessors ---

  @property
  def keyframe_count(self) -> int:
    return self._kf_count_host

  @property
  def surfel_count(self) -> int:
    """Number of live surfels (valid mask), not the allocation watermark."""
    cached_obj, cached_val = self._surfel_count_cache
    if cached_obj is self.surfels.valid:
      return cached_val
    val = int(torch.sum(self.surfels.valid))
    self._surfel_count_cache = (self.surfels.valid, val)
    return val

  @property
  def surfel_watermark(self) -> int:
    """Allocation watermark: the next append position (>= surfel_count)."""
    cached_obj, cached_val = self._surfel_watermark_cache
    if cached_obj is self.surfels.count:
      return cached_val
    val = int(self.surfels.count)
    self._surfel_watermark_cache = (self.surfels.count, val)
    self._watermark_bound = val
    return val

  @property
  def cell_size(self) -> int:
    return self.calibration.cell_size

  def depth_camera(self) -> PinholeCamera:
    """The depth camera with intrinsics on the device."""
    return self.calibration.camera()

  def color_camera(self) -> PinholeCamera:
    w, h = self.color_size
    return make_camera(self.color_intr, w, h)

  def depth_params(self) -> DepthCalibration:
    return self.calibration

  def _valid_slots(self) -> List[int]:
    return np.flatnonzero(self._kf_valid_host[:self.keyframe_count]).tolist()

  # --- capacity management ---

  def reserve_keyframe_capacity(self, n: int):
    """Grow the keyframe store (and the host mirrors) to hold >= n
    keyframes."""
    new_cap = self.kf.capacity
    while new_cap < n:
      new_cap *= 2
    if new_cap == self.kf.capacity:
      return
    self.kf = kf_mod.grow(self.kf, new_cap)
    grown = np.full(new_cap, -1, np.int64)
    grown[:len(self.last_active_in_ba_iteration)] = \
        self.last_active_in_ba_iteration
    self.last_active_in_ba_iteration = grown
    valid_grown = np.zeros(new_cap, bool)
    valid_grown[:len(self._kf_valid_host)] = self._kf_valid_host
    self._kf_valid_host = valid_grown

  def _ensure_keyframe_capacity(self):
    if self.keyframe_count >= self.kf.capacity:
      self.reserve_keyframe_capacity(self.kf.capacity * 2)

  def _ensure_surfel_capacity(self):
    """Keep one image's worth of candidate headroom above the watermark
    before a creation pass. The host bound only over-estimates; when it
    would trigger growth it is first re-synced to the device's watermark, so
    repeated creations cannot ratchet the store to its maximum."""
    w, h = self.depth_size
    cell = self.cell_size
    headroom = (h // cell + 1) * (w // cell + 1)
    if self._watermark_bound + headroom > self.surfels.capacity:
      _ = self.surfel_watermark  # re-syncs _watermark_bound
    while (self._watermark_bound + headroom > self.surfels.capacity and
           self.surfels.capacity < self.config.max_surfel_count):
      self.surfels = surfels_mod.grow(
          self.surfels,
          min(self.surfels.capacity * 2, self.config.max_surfel_count))
    self._watermark_bound = min(self._watermark_bound + headroom,
                                self.surfels.capacity)

  def get_min_observation_count(self) -> int:
    """Bootstrapping schedule (direct_ba.h:219-226)."""
    k = self.keyframe_count
    if k < 5:
      return self.config.min_observation_count_while_bootstrapping_1
    if k < 10:
      return self.config.min_observation_count_while_bootstrapping_2
    return self.config.min_observation_count

  # --- keyframe management ---

  def add_keyframe(self, depth, normals, radius_sq, intensity, rgb,
                   global_T_frame, frame_index: int) -> int:
    """Insert a keyframe and update covisibility (DirectBA::AddKeyframe +
    DetermineNewKeyframeCoVisibility, direct_ba.cc:188-249). Returns the new
    keyframe's index."""
    self._ensure_keyframe_capacity()
    idx = self.keyframe_count
    dev = self.device
    w, h = self.depth_size
    cam = self.depth_camera()
    depth = torch.as_tensor(depth, device=dev)
    min_d, max_d = compute_min_max_depth(depth)
    kf = kf_mod.add_keyframe(
        self.kf, depth, torch.as_tensor(normals, device=dev),
        torch.as_tensor(radius_sq, device=dev),
        torch.as_tensor(intensity, device=dev),
        torch.as_tensor(rgb, device=dev).to(torch.uint8),
        torch.as_tensor(global_T_frame, dtype=torch.float32, device=dev),
        frame_index, min_d, max_d, index=idx)

    # Frustum intersection of the new keyframe with every existing one.
    others = torch.arange(kf.capacity, device=dev)
    inter = kf_mod.frustums_intersect(
        kf, idx, others, cam.fx_inv, cam.fy_inv, cam.cx_inv, cam.cy_inv, w, h)
    inter = inter & kf.valid & (others != idx)
    covis = kf.covis.clone()
    covis[idx, :] = inter
    covis[:, idx] = inter
    # Covisible inactive keyframes become covisible-active
    # (direct_ba.cc:244-246).
    activation = torch.where(inter & (kf.activation == INACTIVE),
                             COVISIBLE_ACTIVE, kf.activation)
    self.kf = kf._replace(covis=covis, activation=activation)
    self._kf_count_host += 1
    self._kf_valid_host[idx] = True
    return idx

  def create_surfels_for_keyframe(self, kf_index: int,
                                  filter_new_surfels: bool = True):
    self._ensure_surfel_capacity()
    kf = self.kf
    covis_mask = kf.covis[kf_index] & kf.valid
    self.surfels = surfel_ops.create_surfels_for_keyframe(
        self.surfels, kf.depth[kf_index], kf.normals[kf_index],
        kf.radius_sq[kf_index], kf.intensity[kf_index], kf.rgb[kf_index],
        kf.global_T_frame[kf_index], self.depth_camera(),
        self.color_camera(), self.calibration,
        kf.depth, kf.normals, kf.global_T_frame, covis_mask,
        self.get_min_observation_count(),
        filter_new_surfels=filter_new_surfels)

  def set_activation(self, activation: np.ndarray):
    self.kf = self.kf._replace(activation=torch.as_tensor(
        np.asarray(activation, np.int32), device=self.device))

  def _merge_surfels(self, kf_index: int):
    kf = self.kf
    self.surfels = surfel_ops.merge_surfels_for_keyframe(
        self.surfels, se3.inverse(kf.global_T_frame[kf_index]),
        kf.depth[kf_index], kf.normals[kf_index], self.depth_camera(),
        self.calibration, self.surfel_merge_dist_factor)

  def _pose_optimization(self, slots: List[int],
                         max_iterations: int) -> int:
    """Pose GN of the valid keyframes that are not inactive (``slots``);
    sets their activation to active or inactive by whether they moved
    (direct_ba_alternating.cc:543-577). Returns the number of converged
    keyframes, deleted slots below the watermark included, as the original
    counts null keyframes as converged."""
    kf = self.kf
    optimize = kf.valid & (kf.activation != INACTIVE)
    T, moved = pose_opt.estimate_frame_poses_batched(
        kf.global_T_frame, optimize, self.surfels, kf.depth, kf.normals,
        kf.intensity, self.depth_camera(), self.color_camera(),
        self.calibration, self.use_depth_residuals,
        self.use_descriptor_residuals, max_iterations, slots=slots)
    activation = torch.where(
        optimize, torch.where(moved, ACTIVE, INACTIVE).to(torch.int32),
        kf.activation)
    self.kf = kf._replace(global_T_frame=T, activation=activation)
    in_watermark = torch.arange(kf.capacity, device=self.device) < kf.count
    num_converged = (torch.sum(kf.valid & (activation == INACTIVE))
                     + torch.sum(~kf.valid & in_watermark))
    return int(num_converged)

  # --- the alternating BA scheme ---

  def bundle_adjustment(
      self,
      optimize_depth_intrinsics: bool = False,
      optimize_color_intrinsics: bool = False,
      do_surfel_updates: bool = True,
      optimize_poses: bool = True,
      optimize_geometry: bool = True,
      min_iterations: int = 0,
      max_iterations: int = 10,
      active_keyframe_window_start: int = -1,
      active_keyframe_window_end: int = -1,
      increase_ba_iteration_count: bool = True,
      max_inner_pose_iterations: int = 30,
      transfer_free: bool = False,
      deadline: Optional[float] = None,
  ) -> Tuple[int, bool]:
    """BundleAdjustmentAlternating (direct_ba_alternating.cc:285-740).

    deadline: absolute time.perf_counter() deadline for real-time mode; the
    scheme stops before starting an iteration past it (the original's
    time_limit check, direct_ba_alternating.cc:703-709). It bounds when
    iterations start; device work already queued still completes.

    Returns (num_iterations_done, converged).
    """
    if optimize_depth_intrinsics or optimize_color_intrinsics:
      raise NotImplementedError(unported(
          "intrinsics optimization", 'item 8 "Self-calibration and PCG"'))
    if self.config.use_pcg and optimize_poses and optimize_geometry:
      raise NotImplementedError(unported(
          "the PCG step (use_pcg)", 'item 8 "Self-calibration and PCG"'))
    if transfer_free:
      raise NotImplementedError(unported(
          "transfer-free BA", 'item 10 "Pipelined front-end"'))
    fixed_ba_iteration_count = self.ba_iteration_count

    if (not increase_ba_iteration_count and
        fixed_ba_iteration_count != self.last_ba_iteration_count):
      self.last_ba_iteration_count = fixed_ba_iteration_count
      self.perform_ba_scheme_end_tasks(do_surfel_updates)

    fixed_active_set = (active_keyframe_window_start >= 0 or
                        active_keyframe_window_end >= 0)

    # Surfel active states start inactive.
    self.surfels = self.surfels._replace(
        active=torch.zeros_like(self.surfels.active))

    converged = False
    iterations_done = 0
    kcount = self.keyframe_count
    depth_cam = self.depth_camera()
    color_cam = self.color_camera()

    for iteration in range(max_iterations):
      # Real-time budget (direct_ba_alternating.cc:703-709): no further
      # iteration starts past the frame deadline. The first always runs;
      # the caller only starts BA with time in hand.
      if (deadline is not None and iteration > 0
          and iteration >= min_iterations
          and time.perf_counter() > deadline):
        break
      iterations_done += 1

      if fixed_active_set:
        act = np.full(self.kf.capacity, INACTIVE, np.int32)
        s = max(0, active_keyframe_window_start)
        e = (active_keyframe_window_end if active_keyframe_window_end >= 0
             else kcount - 1)
        act[s:e + 1] = ACTIVE
        act = np.where(self._kf_valid_host, act, INACTIVE)
        self.set_activation(act)
        self.kf = determine_covisible_active(self.kf)

      # One device->host read per iteration: activation, -1 for invalid
      # slots. It drives surfel creation for newly active keyframes and
      # says which slots each phase below visits.
      act_valid = torch.where(self.kf.valid, self.kf.activation,
                              -1).cpu().numpy()
      active_slots = np.flatnonzero(act_valid == ACTIVE).tolist()
      participating = np.flatnonzero(act_valid >= COVISIBLE_ACTIVE).tolist()

      # --- SURFEL CREATION for newly active keyframes ---
      old_valid = self.surfels.valid
      keyframes_with_new_surfels: List[int] = []
      if optimize_geometry and do_surfel_updates:
        with Timing.time("BA surfel creation"):
          for i in active_slots:
            if (i < kcount and self.last_active_in_ba_iteration[i]
                != fixed_ba_iteration_count):
              self.last_active_in_ba_iteration[i] = fixed_ba_iteration_count
              keyframes_with_new_surfels.append(i)
          for i in keyframes_with_new_surfels:
            self.create_surfels_for_keyframe(i, filter_new_surfels=True)

      # --- SURFEL ACTIVATION ---
      with Timing.time("BA surfel activation"):
        # New surfels (valid now but not before) start active. The creation
        # pass may have grown the store: pad the old mask.
        if self.surfels.capacity != old_valid.shape[0]:
          old_valid = torch.cat([old_valid, old_valid.new_zeros(
              self.surfels.capacity - old_valid.shape[0])])
        new_surfels = self.surfels.valid & ~old_valid
        if fixed_active_set:
          self.surfels = self.surfels._replace(active=self.surfels.valid)
        else:
          self.surfels = surfel_ops.update_surfel_activation(
              self.surfels, self.kf, depth_cam, self.calibration,
              new_surfels, slots=active_slots)

      # --- GEOMETRY OPTIMIZATION ---
      if optimize_geometry:
        with Timing.time("BA geometry optimization"):
          self.surfels = geometry_opt.optimize_geometry_iteration(
              self.surfels, self.kf, depth_cam, color_cam, self.calibration,
              self.use_depth_residuals, self.use_descriptor_residuals,
              slots=participating)

      # --- SURFEL MERGE (keyframes with new surfels) ---
      if do_surfel_updates and keyframes_with_new_surfels:
        with Timing.time("BA initial surfel merge"):
          for i in keyframes_with_new_surfels:
            self._merge_surfels(i)

      # --- POSE OPTIMIZATION ---
      num_converged = kcount
      if optimize_poses:
        with Timing.time("BA pose optimization"):
          num_converged = self._pose_optimization(
              participating, max_inner_pose_iterations)

      if self.timings_stream is not None:
        self.timings_stream.write(
            f"BA_count {fixed_ba_iteration_count} "
            f"inner_iteration {iteration} keyframe_count {kcount} "
            f"surfel_count {self.surfel_count}\n")
      log.debug(f"BA {fixed_ba_iteration_count} it {iteration}: "
                f"kf {kcount}, converged {num_converged}")

      # --- CONVERGENCE ---
      if (iteration >= min_iterations - 1 and
          (num_converged == kcount or not optimize_poses)):
        converged = True
        break

      self.kf = determine_covisible_active(self.kf)

    if increase_ba_iteration_count:
      self.perform_ba_scheme_end_tasks(do_surfel_updates)
      self.ba_iteration_count += 1

    if DEBUG_VERIFY_COUNT:
      self.debug_verify_counts()
    return iterations_done, converged

  def debug_verify_counts(self):
    """DebugVerifySurfelCount (kernel_verify_count.cc:39-60): recount live
    surfels on the device and CHECK the host mirrors' invariants."""
    device_valid = int(torch.sum(self.surfels.valid))
    log.check_eq(device_valid, self.surfel_count, "surfel count mirror")
    watermark = int(self.surfels.count)
    log.check_le(device_valid, watermark, "live surfels within watermark")
    log.check_le(watermark, self.surfels.capacity, "watermark within store")
    log.check_le(watermark, self._watermark_bound,
                 "host watermark bound is an upper bound")
    log.check_eq(int(self.kf.count), self._kf_count_host,
                 "keyframe count mirror")
    log.check(bool(np.array_equal(self.kf.valid.cpu().numpy(),
                                  self._kf_valid_host)),
              "keyframe valid mirror matches device mask")
    log.debug("DebugVerifySurfelCount: ok")

  def perform_ba_scheme_end_tasks(self, do_surfel_updates: bool = True):
    """Merge (keyframes active in this scheme), delete, update radii,
    compact (direct_ba.cc:566-653)."""
    if do_surfel_updates:
      with Timing.time("BA final surfel merge and compact"):
        for i in range(self.keyframe_count):
          if self.last_active_in_ba_iteration[i] == self.ba_iteration_count:
            self._merge_surfels(i)
    with Timing.time("BA final surfel del. and radius upd."):
      before = self.surfel_count
      self.surfels = surfel_ops.delete_surfels_and_update_radii(
          self.surfels, self.kf, self.depth_camera(), self.calibration,
          self.get_min_observation_count(), True, slots=self._valid_slots())
      self.num_surfels_deleted += max(0, before - self.surfel_count)
    # Compaction (CompactSurfelsCUDA, direct_ba.cc:645): reclaim dead slots
    # when fragmentation is high, so the watermark does not creep toward
    # the capacity.
    if (self.surfel_watermark - self.surfel_count
        > max(1024, self.surfels.capacity // 4)):
      with Timing.time("BA surfel compaction"):
        self.surfels = surfels_mod.compact(self.surfels)

  # --- keyframe deletion / merging (memory pressure) ---

  def delete_keyframe(self, keyframe_index: int):
    """DirectBA::DeleteKeyframe (direct_ba.cc:207-229): the slot is
    invalidated, so indices stay stable; its covisibility row and column are
    cleared."""
    kf = self.kf
    covis = kf.covis.clone()
    covis[keyframe_index, :] = False
    covis[:, keyframe_index] = False
    valid = kf.valid.clone()
    valid[keyframe_index] = False
    activation = kf.activation.clone()
    activation[keyframe_index] = INACTIVE
    self.kf = kf._replace(valid=valid, activation=activation, covis=covis)
    self._kf_valid_host[keyframe_index] = False

  def merge_keyframes(self, approx_merge_count: int = 1) -> int:
    """DirectBA::MergeKeyframes (direct_ba.cc:251-338): rank consecutive
    keyframe pairs by a combined angle/translation distance (90 degrees
    count like 0.5 m) and delete the middle keyframes of the closest chains.
    Keyframe 0 (the reconstruction's anchor) is never deleted."""
    max_angle = 0.5 * np.pi / 2.0      # kMaxAngleDifference
    max_dist = 0.3                     # kMaxEuclideanDistance
    poses = self.kf.global_T_frame.cpu().numpy()
    slots = self._valid_slots()
    if len(slots) <= 1:
      return 0

    distances = []  # (weight, prev_id, id, next_id)
    prev_half = 0.0
    prev_id = slots[0]
    for a, b in zip(slots[:-1], slots[1:]):
      za, zb = poses[a][:3, 2], poses[b][:3, 2]
      angle = float(np.arccos(np.clip(za @ zb, -1.0, 1.0)))
      if angle > max_angle:
        continue
      dist = float(np.linalg.norm(poses[a][:3, 3] - poses[b][:3, 3]))
      if dist > max_dist:
        continue
      next_half = dist + (0.5 / (np.pi / 2.0)) * angle
      if a > 0:
        distances.append((prev_half + next_half, prev_id, a, b))
      prev_half = next_half
      prev_id = a

    distances.sort()
    deleted = 0
    dead = set()
    for _, p, m, nx in distances[:approx_merge_count]:
      if p in dead or m in dead or nx in dead:
        continue
      self.delete_keyframe(m)
      dead.add(m)
      deleted += 1
    return deleted

  # --- exports ---

  def assign_colors(self):
    """Refresh surfel colors by averaging their observations across all
    keyframes (DirectBA::AssignColors, direct_ba.cc:456-459)."""
    self.surfels = surfel_ops.assign_colors(
        self.surfels, self.kf, self.depth_camera(), self.color_camera(),
        self.calibration, slots=self._valid_slots())

  def export_point_cloud(self, refresh_colors: bool = True
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(positions (M, 3), normals (M, 3), colors (M, 3) u8) of the valid
    surfels (DirectBA::ExportToPointCloud, direct_ba.cc:461-547)."""
    if refresh_colors and self.keyframe_count > 0:
      self.assign_colors()
    s = self.surfels
    valid = s.valid
    col = torch.clamp(s.color[valid] * 255.0, 0, 255).to(torch.uint8)
    return (s.pos[valid].cpu().numpy(), s.normal[valid].cpu().numpy(),
            col.cpu().numpy())
