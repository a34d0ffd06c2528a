"""DirectBA: the SLAM back-end, a surfel map and the direct bundle adjustment
that alternates over it.

Port of ``badslam_tpu/slam/direct_ba.py`` (class DirectBA, direct_ba.{h,cc},
``BundleAdjustmentAlternating``, direct_ba_alternating.cc:285-740, and the
joint step of ``BundleAdjustmentPCG``, direct_ba_pcg.cc:339-471, of the
original BAD SLAM). Covisibility: direct_ba.cc:231-249; the min-observation
bootstrapping schedule: direct_ba.h:219-226; end-of-scheme tasks:
direct_ba.cc:566-653.

  * All map state (SurfelStore, KeyframeStore, DepthCalibration) lives on
    one device, named at construction. Host code runs the alternation
    schedule and reads back small scalars: the activation states once per
    iteration, the surfel count and watermark after lifecycle ops, one
    convergence flag per pose GN iteration or per inner PCG iteration.
  * ``transfer_free`` (the pipelined front-end's mode, the reference's
    ``transfer_free``) reads nothing: the slots come from the host mirror of
    the valid mask and the fixed window, the GN and PCG loops end on lagged
    polls of their flags (``utils/transfer.py``), the convergence scalar is
    never read (exactly ``max_iterations`` run), and the end tasks skip the
    deleted-surfel count and compaction.
  * Each phase loops in Python over the keyframe slots that take part, so
    device work scales with the active set and there is no active-keyframe
    window to gather (``config.use_active_kf_window`` changes nothing).
    ``bundle_adjustment`` records their number under the ``Timing`` counter
    "BA participating keyframes", one sample per iteration, under either
    solver: the size of the system the iteration solves.
  * Deletion and merging clear validity masks; compaction runs at the end
    of a scheme when a quarter of the store is dead slots.
  * Every reduction is a sum in a fixed order, an integer ``amin`` or a
    float32 matrix product: two runs from one state give the same bits.
  * The calibration (``DepthCalibration`` and ``color_intr``) is shared
    with the front-end and is only ever written in place: self-calibration
    copies its result into the same tensors, so every camera made of views
    of them, the front-end and the preprocess kernel's pointers follow.

Mesh mode (``mesh=``, JAX :350-436): the surfel store is sharded over the
mesh's ``surfels`` axis (global slot ``s`` on shard ``s // (capacity /
N)``); the keyframes and the calibration are replicated, one replica per
distinct device (``parallel/spmd.replicate``; on a virtual mesh over one
device the replica is the tensor itself). An added keyframe's slot is
copied to the other devices' replicas of the image stacks
(``spmd.rows_written``); the small per-keyframe vectors are new tensors
after every write and are copied whole.

  * Activation, the geometry step, deletion and the radius update, colour
    assignment and the normal re-estimation run on each shard, in one thread
    per mesh position (``parallel/spmd.shard_map``).
  * The pose H/b of each GN iteration, the intrinsics sums, the PCG's pose
    and intrinsics rows and its dot products are summed over the shards in
    mesh order (``psum``); the surfel count sums the shards' counts.
  * The ops that move surfels between slots (creation's append at the
    watermark, merge, compaction, growth, ``export_point_cloud`` and
    ``to_numpy``) read ``surfels``, which gathers the store onto the mesh's
    first device, and write it back, which shards it again (GSPMD's
    partitioner does this implicitly in JAX). Each gather and each sharding
    is a ``Timing`` span, and ``mesh_gather_bytes`` counts the bytes the
    gathers moved, so a later partition of these ops can be measured.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models import (geometry_opt, intrinsics_opt,
                                      keyframes as kf_mod, pcg as pcg_mod,
                                      pose_opt, surfel_ops,
                                      surfels as surfels_mod)
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import (ACTIVE, COVISIBLE_ACTIVE,
                                                INACTIVE, KeyframeStore)
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops.depth_proc import compute_min_max_depth
from badslam_tpu_torch.parallel import sharded_ba, spmd
from badslam_tpu_torch.parallel.spmd import P
from badslam_tpu_torch.utils import logging as log
from badslam_tpu_torch.utils.timing import Timing
from badslam_tpu_torch.utils.transfer import to_device

# kDebugVerifySurfelCount (direct_ba.cc:55): recount on the device and CHECK
# the host mirrors after every BA scheme.
DEBUG_VERIFY_COUNT = bool(os.environ.get("BADSLAM_DEBUG_VERIFY_COUNT"))


def make_camera(intr: torch.Tensor, width: int, height: int) -> PinholeCamera:
  """A camera with intrinsics as 0-d views of a (4,) device tensor."""
  return PinholeCamera(width, height, intr[0], intr[1], intr[2], intr[3])


def as_device_tensor(value, dtype: torch.dtype, device) -> torch.Tensor:
  """``value`` (a tensor or a host array) on ``device``, copied from the
  host without the host waiting for the device."""
  if isinstance(value, torch.Tensor):
    return value.to(device=device, dtype=dtype)
  np_dtype = {torch.float32: np.float32, torch.uint8: np.uint8}[dtype]
  return to_device(np.asarray(value, np_dtype), device)


def camera_intrinsics(cam: PinholeCamera, device) -> torch.Tensor:
  return torch.tensor([float(cam.fx), float(cam.fy), float(cam.cx),
                       float(cam.cy)], dtype=torch.float32, device=device)


class MapView(NamedTuple):
  """The replicated state one shard reads, on its device."""
  kf: KeyframeStore
  calibration: DepthCalibration
  color_intr: torch.Tensor
  depth_cam: PinholeCamera
  color_cam: PinholeCamera


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
      mesh: Optional[spmd.Mesh] = None,
  ):
    """``device`` is where every store is allocated (``cuda`` when none is
    named; the mesh's first device under a ``mesh``). ``calibration`` is the
    depth calibration to read, shared with the front-end; without one a new
    map's initial state is made. ``mesh``: shard the surfel store over its
    ``surfels`` axis (see the module's docstring)."""
    self.config = config
    self.mesh = mesh
    if mesh is not None:
      if device is not None and torch.device(device) != mesh.first_device:
        raise ValueError(f"device {device} is not the mesh's first device "
                         f"{mesh.first_device}")
      device = mesh.first_device
    self.device = torch.device("cuda" if device is None else device)
    # The mesh axis of the surfel shards, for the cross-shard sums.
    self._axis = None if mesh is None else sharded_ba.SURFEL_AXIS
    # Gathers of the store onto the first device, and their bytes.
    self.mesh_gathers = 0
    self.mesh_gather_bytes = 0
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
    self._surfels: Optional[SurfelStore] = None
    self._sharded: Optional[SurfelStore] = None
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
                 host_state: Dict[str, object], device,
                 mesh: Optional[spmd.Mesh] = None) -> "DirectBA":
    """A back-end that continues from another one's state: the two stores
    as host arrays named like their fields, in the single-device slot order,
    the calibration, and the host mirrors (``_kf_count_host``,
    ``_kf_valid_host``, ``last_active_in_ba_iteration``,
    ``ba_iteration_count``, ``last_ba_iteration_count``); over ``mesh`` if
    one is given."""
    ba = cls(config, depth_cam, color_cam, keyframe_capacity=1,
             surfel_capacity=1, device=device, calibration=calibration,
             mesh=mesh)
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

  # --- the surfel store, whole or sharded ---

  @property
  def surfels(self) -> SurfelStore:
    """The surfel store. Under a mesh: gathered onto the mesh's first
    device, in the single-device slot order (a copy)."""
    if self.mesh is None:
      return self._surfels
    with Timing.time("Mesh surfel gather"):
      nbytes = sum(x.nbytes for x in self._sharded
                   if isinstance(x, spmd.Sharded))
      self.mesh_gathers += 1
      self.mesh_gather_bytes += nbytes
      log.debug(f"mesh: gathered {nbytes} bytes of surfels")
      return SurfelStore(*(spmd.gather(x) for x in self._sharded))

  @surfels.setter
  def surfels(self, store: SurfelStore):
    if self.mesh is None:
      self._surfels = store
      return
    with Timing.time("Mesh surfel sharding"):
      n = self.mesh.shape[sharded_ba.SURFEL_AXIS]
      if store.capacity % n:
        store = surfels_mod.grow(store, -(-store.capacity // n) * n)
      self._sharded = sharded_ba.shard_surfels(store, self.mesh)

  def _store(self) -> SurfelStore:
    """The store as it is held: whole, or of ``spmd.Sharded`` fields."""
    return self._surfels if self.mesh is None else self._sharded

  def _put(self, store: SurfelStore):
    """Keep a store as ``_on_shards`` returns it."""
    if self.mesh is None:
      self._surfels = store
    else:
      self._sharded = store

  def _view(self, device) -> MapView:
    """The replicated state on ``device``."""
    if device is None or device == self.device:
      return MapView(self.kf, self.calibration, self.color_intr,
                     self.depth_camera(), self.color_camera())
    kf = KeyframeStore(*(spmd.replicate(x, device) for x in self.kf))
    c = self.calibration
    calib = DepthCalibration(
        *(spmd.replicate(x, device)
          for x in (c.depth_intr, c.a, c.cfactor, c.baseline_fx)),
        c.cell_size, c.depth_size)
    color_intr = spmd.replicate(self.color_intr, device)
    w, h = self.color_size
    return MapView(kf, calib, color_intr, calib.camera(),
                   make_camera(color_intr, w, h))

  def _on_shards(self, fn, out_specs, *args, in_specs=()):
    """``fn(surfels, view, *args)`` on the store, or, under a mesh, on every
    shard of it in its own thread with its device's ``MapView``;
    ``out_specs`` and ``in_specs`` (of ``args``) as in
    ``spmd.shard_map``."""
    if self.mesh is None:
      return fn(self._surfels, self._view(self.device), *args)

    def body(surfels, *a):
      return fn(surfels, self._view(spmd.current_device()), *a)
    return spmd.shard_map(body, self.mesh,
                          (sharded_ba.surfel_specs(),) + tuple(in_specs),
                          out_specs)(self._sharded, *args)

  def _local_surfels(self, fn, *args, in_specs=()):
    """``_on_shards`` for an ``fn`` that returns the (local) store."""
    self._put(self._on_shards(fn, sharded_ba.surfel_specs(), *args,
                              in_specs=in_specs))

  # --- accessors ---

  @property
  def keyframe_count(self) -> int:
    return self._kf_count_host

  @property
  def surfel_capacity(self) -> int:
    return self._store().pos.shape[0]

  @property
  def surfel_count(self) -> int:
    """Number of live surfels (valid mask), not the allocation watermark."""
    valid = self._store().valid
    cached_obj, cached_val = self._surfel_count_cache
    if cached_obj is valid:
      return cached_val
    if self.mesh is None:
      val = int(torch.sum(valid))
    else:
      val = int(torch.stack([torch.sum(b).to(self.device)
                             for b in valid.blocks()]).sum())
    self._surfel_count_cache = (valid, val)
    return val

  @property
  def surfel_watermark(self) -> int:
    """Allocation watermark: the next append position (>= surfel_count)."""
    count = self._store().count
    cached_obj, cached_val = self._surfel_watermark_cache
    if cached_obj is count:
      return cached_val
    val = int(count)
    self._surfel_watermark_cache = (count, val)
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
    if (self._watermark_bound + headroom > self.surfel_capacity
        and not self.config.pipelined_frontend):
      # The pipelined front-end grows on the bound alone: it ratchets by one
      # pass's headroom whatever was appended, so the store over-grows, up
      # to max_surfel_count, rather than reading the watermark.
      _ = self.surfel_watermark  # re-syncs _watermark_bound
    # Under a mesh the setter rounds the new capacity up to a multiple of
    # the shard count, past max_surfel_count if need be.
    while (self._watermark_bound + headroom > self.surfel_capacity and
           self.surfel_capacity < self.config.max_surfel_count):
      self.surfels = surfels_mod.grow(
          self.surfels,
          min(self.surfel_capacity * 2, self.config.max_surfel_count))
    self._watermark_bound = min(self._watermark_bound + headroom,
                                self.surfel_capacity)

  def get_min_observation_count(self) -> int:
    """Bootstrapping schedule (direct_ba.h:219-226)."""
    k = self.keyframe_count
    if k < 5:
      return self.config.min_observation_count_while_bootstrapping_1
    if k < 10:
      return self.config.min_observation_count_while_bootstrapping_2
    return self.config.min_observation_count

  def clone_for_prewarm(self) -> "DirectBA":
    """A throwaway copy for ``BadSlam.prewarm``'s warm-up BA iterations: a
    ``bundle_adjustment`` run on it leaves this back-end bit for bit as it
    was. JAX's shallow copy may share the device state because JAX arrays
    are immutable; here the keyframe stacks, the surfel store and the
    calibration are written in place (``add_keyframe``, self-calibration),
    so the clone owns a copy of every tensor of the map and of the host
    mirrors. Clones never feed results back."""
    c = copy.copy(self)
    c.kf = KeyframeStore(*(x.clone() for x in self.kf))
    c.calibration = self.calibration.clone()
    c.color_intr = self.color_intr.clone()

    def cloned(x):
      if not isinstance(x, spmd.Sharded):
        return x.clone()
      pieces = np.empty(x.pieces.shape, dtype=object)
      for pos in np.ndindex(x.pieces.shape):
        pieces[pos] = x.pieces[pos].clone()
      return spmd.Sharded(x.mesh, x.axis, pieces)
    store = self._store()
    c._put(spmd.tree_map(cloned, store))
    # The cached counts hold for the copies: carried over, not read again.
    for name, field in (("_surfel_count_cache", "valid"),
                        ("_surfel_watermark_cache", "count")):
      cached_obj, cached_val = getattr(self, name)
      if cached_obj is getattr(store, field):
        setattr(c, name, (getattr(c._store(), field), cached_val))
    c.last_active_in_ba_iteration = self.last_active_in_ba_iteration.copy()
    c._kf_valid_host = self._kf_valid_host.copy()
    c.timings_stream = None
    return c

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
    f32 = torch.float32
    depth = as_device_tensor(depth, f32, dev)
    min_d, max_d = compute_min_max_depth(depth)
    kf = kf_mod.add_keyframe(
        self.kf, depth, as_device_tensor(normals, f32, dev),
        as_device_tensor(radius_sq, f32, dev),
        as_device_tensor(intensity, f32, dev),
        as_device_tensor(rgb, torch.uint8, dev),
        as_device_tensor(global_T_frame, f32, dev),
        frame_index, min_d, max_d, index=idx)
    if self.mesh is not None:
      # The other devices' replicas take the new slot, not the stacks.
      for stack in (kf.depth, kf.normals, kf.radius_sq, kf.intensity,
                    kf.rgb):
        spmd.rows_written(stack, idx)

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
                                  filter_new_surfels: bool = True,
                                  transfer_free: bool = False):
    """With ``transfer_free`` the covisible keyframes are not read back:
    the filter visits every valid slot and masks on the device."""
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
        filter_new_surfels=filter_new_surfels,
        covis_slots=self._valid_slots() if transfer_free else None)

  def set_activation(self, activation: np.ndarray):
    self.kf = self.kf._replace(activation=to_device(
        np.asarray(activation, np.int32), self.device))

  def _merge_surfels(self, kf_index: int):
    kf = self.kf
    self.surfels = surfel_ops.merge_surfels_for_keyframe(
        self.surfels, se3.inverse(kf.global_T_frame[kf_index]),
        kf.depth[kf_index], kf.normals[kf_index], self.depth_camera(),
        self.calibration, self.surfel_merge_dist_factor)

  def _pose_optimization(self, slots: List[int], max_iterations: int,
                         transfer_free: bool = False) -> int:
    """Pose GN of the valid keyframes that are not inactive (``slots``);
    sets their activation to active or inactive by whether they moved
    (direct_ba_alternating.cc:543-577). Returns the number of converged
    keyframes, deleted slots below the watermark included, as the original
    counts null keyframes as converged; 0 with ``transfer_free``, which
    reads nothing."""
    kf = self.kf

    def poses(surfels, v):
      optimize = v.kf.valid & (v.kf.activation != INACTIVE)
      T, moved = pose_opt.estimate_frame_poses_batched(
          v.kf.global_T_frame, optimize, surfels, v.kf.depth, v.kf.normals,
          v.kf.intensity, v.depth_cam, v.color_cam, v.calibration,
          self.use_depth_residuals, self.use_descriptor_residuals,
          max_iterations, slots=slots, transfer_free=transfer_free,
          axis=self._axis)
      return T, moved, optimize
    T, moved, optimize = self._on_shards(poses, (P(), P(), P()))
    activation = torch.where(
        optimize, torch.where(moved, ACTIVE, INACTIVE).to(torch.int32),
        kf.activation)
    self.kf = kf._replace(global_T_frame=T, activation=activation)
    if transfer_free:
      return 0
    in_watermark = torch.arange(kf.capacity, device=self.device) < kf.count
    num_converged = (torch.sum(kf.valid & (activation == INACTIVE))
                     + torch.sum(~kf.valid & in_watermark))
    return int(num_converged)

  def _write_calibration(self, depth_intr, color_intr, a, cfactor):
    """Take over a self-calibration result, in place (see the module's
    docstring). The values were computed from the old ones, so every
    argument is a new tensor or the very tensor it would be copied to."""
    calib = self.calibration
    for dst, src in ((calib.depth_intr, depth_intr),
                     (self.color_intr, color_intr), (calib.a, a),
                     (calib.cfactor, cfactor)):
      if src is not dst:
        dst.copy_(src)

  def _pcg_iteration(self, slots: List[int], gauge: int, opt_dintr: bool,
                     opt_cintr: bool, transfer_free: bool = False
                     ) -> torch.Tensor:
    """One joint GN step by matrix-free PCG over poses and surfels, and over
    the intrinsics when the flags are set (the inner work of
    BundleAdjustmentPCG, direct_ba_pcg.cc:339-471), followed by the PCG
    path's separate normal re-estimation (kernel_opt_geometry.cu:527+).
    Returns the largest pose-update entry of a valid keyframe (0-d)."""
    def step(surfels, v):
      calib = v.calibration
      delta = pcg_mod.pcg_solve(
          surfels, v.kf, v.depth_cam, v.color_cam, calib, gauge,
          self.config.pcg_max_inner_iterations, self.use_depth_residuals,
          self.use_descriptor_residuals, opt_dintr, opt_cintr, slots=slots,
          transfer_free=transfer_free, axis_name=self._axis)
      surfels, kf = pcg_mod.apply_pcg_delta(surfels, v.kf, delta)
      new_calibration = pcg_mod.apply_pcg_delta_intrinsics(
          calib.depth_intr, v.color_intr, calib.a, calib.cfactor, delta,
          opt_dintr, opt_cintr)
      # The normals are re-estimated under the calibration the step was
      # linearized at, as in the reference; only then is the new one
      # written.
      with pcg_mod.span("BA PCG normal re-estimation", self._axis):
        surfels = geometry_opt.reestimate_normals(
            surfels, kf, v.depth_cam, calib, slots=slots)
      pose_update = torch.where(kf.valid[:, None], delta.poses.abs(),
                                0.0).max()
      return surfels, kf.global_T_frame, new_calibration, pose_update
    surfels, T, new_calibration, pose_update = self._on_shards(
        step, (sharded_ba.surfel_specs(), P(), P(), P()))
    self._put(surfels)
    self.kf = self.kf._replace(global_T_frame=T)
    self._write_calibration(*new_calibration)
    return pose_update

  def _optimize_intrinsics(self, optimize_depth: bool, optimize_color: bool,
                           transfer_free: bool = False):
    """The alternated self-calibration step (models/intrinsics_opt.py)."""
    slots = self._valid_slots()

    def step(surfels, v):
      return intrinsics_opt.optimize_intrinsics(
          surfels, v.kf, v.calibration, v.color_intr, self.color_size,
          optimize_depth, optimize_color, self.use_depth_residuals,
          self.use_descriptor_residuals, slots=slots,
          transfer_free=transfer_free, axis=self._axis)
    self._write_calibration(*self._on_shards(step, P()))

  # --- the BA scheme: alternating, or joint by PCG ---

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
    """BundleAdjustmentAlternating (direct_ba_alternating.cc:285-740); with
    ``config.use_pcg`` (and poses and geometry both optimized) the geometry
    and pose phases are one joint PCG step (direct_ba_pcg.cc).

    transfer_free: run without a device-to-host read (see the module's
    docstring); exactly ``max_iterations`` run and ``converged`` is False.
    Needs a fixed active window (the parallel-BA thread's, bad_slam.cc:
    1268-1289): the activation evolves by reads otherwise.

    deadline: absolute time.perf_counter() deadline for real-time mode; the
    scheme stops before starting an iteration past it (the original's
    time_limit check, direct_ba_alternating.cc:703-709). It bounds when
    iterations start; device work already queued still completes.

    Returns (num_iterations_done, converged).
    """
    fixed_ba_iteration_count = self.ba_iteration_count

    if (not increase_ba_iteration_count and
        fixed_ba_iteration_count != self.last_ba_iteration_count):
      self.last_ba_iteration_count = fixed_ba_iteration_count
      self.perform_ba_scheme_end_tasks(do_surfel_updates,
                                       transfer_free=transfer_free)

    fixed_active_set = (active_keyframe_window_start >= 0 or
                        active_keyframe_window_end >= 0)
    if transfer_free and not fixed_active_set:
      raise ValueError("transfer_free BA needs a fixed active window (the "
                       "activation evolves by reads otherwise)")

    # Surfel active states start inactive.
    self._local_surfels(
        lambda surfels, v: surfels._replace(
            active=torch.zeros_like(surfels.active)))

    converged = False
    iterations_done = 0
    kcount = self.keyframe_count
    use_pcg = self.config.use_pcg and optimize_poses and optimize_geometry
    # Under PCG the intrinsics unknowns fold into the joint vector
    # (direct_ba_pcg.cc:240-307) instead of the alternated Schur step.
    pcg_dintr = (use_pcg and optimize_depth_intrinsics
                 and self.use_depth_residuals)
    pcg_cintr = (use_pcg and optimize_color_intrinsics
                 and self.use_descriptor_residuals)
    alt_dintr = optimize_depth_intrinsics and not pcg_dintr
    alt_cintr = optimize_color_intrinsics and not pcg_cintr

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

      if transfer_free:
        # The fixed window's activation is known on the host: active for the
        # valid slots in the window, -1 elsewhere (a full window leaves no
        # slot to become covisible-active).
        act_valid = np.where(self._kf_valid_host[:self.kf.capacity], act,
                             -1)
      else:
        # One device->host read per iteration: activation, -1 for invalid
        # slots. It drives surfel creation for newly active keyframes and
        # says which slots each phase below visits.
        act_valid = torch.where(self.kf.valid, self.kf.activation,
                                -1).cpu().numpy()
      active_slots = np.flatnonzero(act_valid == ACTIVE).tolist()
      participating = np.flatnonzero(act_valid >= COVISIBLE_ACTIVE).tolist()
      Timing.count("BA participating keyframes", len(participating))

      # --- SURFEL CREATION for newly active keyframes ---
      old_valid = self._store().valid
      keyframes_with_new_surfels: List[int] = []
      if optimize_geometry and do_surfel_updates:
        with Timing.time("BA surfel creation"):
          for i in active_slots:
            if (i < kcount and self.last_active_in_ba_iteration[i]
                != fixed_ba_iteration_count):
              self.last_active_in_ba_iteration[i] = fixed_ba_iteration_count
              keyframes_with_new_surfels.append(i)
          for i in keyframes_with_new_surfels:
            self.create_surfels_for_keyframe(i, filter_new_surfels=True,
                                             transfer_free=transfer_free)

      # --- SURFEL ACTIVATION ---
      with Timing.time("BA surfel activation"):
        # New surfels (valid now but not before) start active. The creation
        # pass may have grown the store: pad the old mask (under a mesh the
        # shards' boundaries moved too, so it is padded whole).
        if self.surfel_capacity != old_valid.shape[0]:
          old_valid = spmd.gather(old_valid)
          old_valid = torch.cat([old_valid, old_valid.new_zeros(
              self.surfel_capacity - old_valid.shape[0])])
        if fixed_active_set:
          self._local_surfels(
              lambda surfels, v: surfels._replace(active=surfels.valid))
        else:
          def activate(surfels, v, old):
            return surfel_ops.update_surfel_activation(
                surfels, v.kf, v.depth_cam, v.calibration,
                surfels.valid & ~old, slots=active_slots)
          self._local_surfels(activate, old_valid,
                              in_specs=(P(sharded_ba.SURFEL_AXIS),))

      # --- GEOMETRY OPTIMIZATION (alternating) or JOINT PCG STEP ---
      pose_update = None
      if use_pcg:
        with Timing.time("BA PCG"):
          # Gauge: the fixed keyframe rotates over the valid slots (the
          # original draws a random live keyframe, direct_ba_pcg.cc:318-337);
          # a deleted slot would leave the system gauge-free.
          valid_slots = self._valid_slots() or [0]
          gauge = valid_slots[iteration % len(valid_slots)]
          pose_update = self._pcg_iteration(participating, gauge, pcg_dintr,
                                            pcg_cintr, transfer_free)
      elif optimize_geometry:
        with Timing.time("BA geometry optimization"):
          self._local_surfels(
              lambda surfels, v: geometry_opt.optimize_geometry_iteration(
                  surfels, v.kf, v.depth_cam, v.color_cam, v.calibration,
                  self.use_depth_residuals, self.use_descriptor_residuals,
                  slots=participating))

      # --- SURFEL MERGE (keyframes with new surfels) ---
      if do_surfel_updates and keyframes_with_new_surfels:
        with Timing.time("BA initial surfel merge"):
          for i in keyframes_with_new_surfels:
            self._merge_surfels(i)

      # --- POSE OPTIMIZATION ---
      num_converged = kcount
      if use_pcg:
        # The PCG step already moved the poses; convergence is read from
        # the update's norm (one device->host read), never without reads.
        if transfer_free or not float(pose_update) ** 2 * 100.0 < 1e-6:
          num_converged = 0
      elif optimize_poses:
        with Timing.time("BA pose optimization"):
          num_converged = self._pose_optimization(
              participating, max_inner_pose_iterations, transfer_free)

      # --- INTRINSICS OPTIMIZATION (alternated; not for the unknowns that
      # the joint PCG step above already solved) ---
      if alt_dintr or alt_cintr:
        with Timing.time("BA intrinsics optimization"):
          self._optimize_intrinsics(alt_dintr, alt_cintr, transfer_free)

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
      self.perform_ba_scheme_end_tasks(do_surfel_updates,
                                       transfer_free=transfer_free)
      self.ba_iteration_count += 1

    if DEBUG_VERIFY_COUNT:
      self.debug_verify_counts()
    return iterations_done, converged

  def debug_verify_counts(self):
    """DebugVerifySurfelCount (kernel_verify_count.cc:39-60): recount live
    surfels on the device and CHECK the host mirrors' invariants."""
    surfels = self.surfels
    device_valid = int(torch.sum(surfels.valid))
    log.check_eq(device_valid, self.surfel_count, "surfel count mirror")
    watermark = int(surfels.count)
    log.check_le(device_valid, watermark, "live surfels within watermark")
    log.check_le(watermark, surfels.capacity, "watermark within store")
    log.check_le(watermark, self._watermark_bound,
                 "host watermark bound is an upper bound")
    log.check_eq(int(self.kf.count), self._kf_count_host,
                 "keyframe count mirror")
    log.check(bool(np.array_equal(self.kf.valid.cpu().numpy(),
                                  self._kf_valid_host)),
              "keyframe valid mirror matches device mask")
    log.debug("DebugVerifySurfelCount: ok")

  def perform_ba_scheme_end_tasks(self, do_surfel_updates: bool = True,
                                  transfer_free: bool = False):
    """Merge (keyframes active in this scheme), delete, update radii,
    compact (direct_ba.cc:566-653). ``transfer_free`` skips the two reads:
    the deleted-surfel count and the fragmentation test of compaction
    (purely an optimization of the masked store; the watermark's creep is
    bounded by the store's growth)."""
    if do_surfel_updates:
      with Timing.time("BA final surfel merge and compact"):
        for i in range(self.keyframe_count):
          if self.last_active_in_ba_iteration[i] == self.ba_iteration_count:
            self._merge_surfels(i)
    with Timing.time("BA final surfel del. and radius upd."):
      before = None if transfer_free else self.surfel_count
      min_obs = self.get_min_observation_count()
      slots = self._valid_slots()
      self._local_surfels(
          lambda surfels, v: surfel_ops.delete_surfels_and_update_radii(
              surfels, v.kf, v.depth_cam, v.calibration, min_obs, True,
              slots=slots))
      if before is not None:
        self.num_surfels_deleted += max(0, before - self.surfel_count)
    if transfer_free:
      return
    # Compaction (CompactSurfelsCUDA, direct_ba.cc:645): reclaim dead slots
    # when fragmentation is high, so the watermark does not creep toward
    # the capacity.
    if (self.surfel_watermark - self.surfel_count
        > max(1024, self.surfel_capacity // 4)):
      with Timing.time("BA surfel compaction"):
        self.surfels = surfels_mod.compact(self.surfels)

  # --- keyframe deletion / merging (memory pressure) ---

  def delete_keyframe(self, keyframe_index: int, loop_detector=None):
    """DirectBA::DeleteKeyframe (direct_ba.cc:207-229): the slot is
    invalidated, so indices stay stable; its covisibility row and column are
    cleared, and the keyframe leaves ``loop_detector``'s database."""
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
    if loop_detector is not None:
      loop_detector.remove_keyframe(keyframe_index)

  def merge_keyframes(self, loop_detector=None,
                      approx_merge_count: int = 1) -> int:
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
      self.delete_keyframe(m, loop_detector)
      dead.add(m)
      deleted += 1
    return deleted

  # --- exports ---

  def assign_colors(self):
    """Refresh surfel colors by averaging their observations across all
    keyframes (DirectBA::AssignColors, direct_ba.cc:456-459)."""
    slots = self._valid_slots()
    self._local_surfels(
        lambda surfels, v: surfel_ops.assign_colors(
            surfels, v.kf, v.depth_cam, v.color_cam, v.calibration,
            slots=slots))

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
