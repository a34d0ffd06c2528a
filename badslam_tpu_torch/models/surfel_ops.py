"""Surfel lifecycle ops: creation, supporting-surfel merge, deletion,
activation, color assignment.

Port of ``badslam_tpu/models/surfel_ops.py`` (kernel_create_surfels.cu,
kernel_supporting_surfels.cu, kernel_delete_surfels.cu,
kernel_surfel_activation.cu and kernel_assign_colors.cu of the original BAD
SLAM). Everything is dense over the surfel capacity with validity masks, so
"deletion" clears mask bits.

  * The representative pixel of a sparsification cell is its first valid
    pixel in row-major order (the original's atomicCAS race picks any).
  * The merge kernel's 3-deep CAS buffer chain becomes 3 rounds of
    cluster-head selection by the lowest surfel index per cell, an integer
    ``amin`` scatter, which is order-independent and so deterministic.
  * The reference scans the full keyframe stack; here a Python loop visits
    the slots that can contribute, in slot order, so that sums add in the
    scan's order. Each function takes those slots as host ints (``slots``)
    from a caller that has them, and otherwise reads the mask back once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost, surfels as surfels_mod
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import ACTIVE, KeyframeStore
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops import depth_model, interp
from badslam_tpu_torch.ops.depth_proc import normals_3d

# cos(pi / 4), the merge kernel's normal threshold (kernels.cc).
COS_SURFEL_MERGE_NORMAL_THRESHOLD = 0.7071067811865476
MERGE_ROUNDS = 3  # kMergeBufferCount (kernels.cuh:52)


def _cell_grid_shape(height: int, width: int, cell: int) -> Tuple[int, int]:
  return (-(-height // cell), -(-width // cell))


def _slots_of(mask: torch.Tensor, slots: Optional[Sequence[int]]):
  if slots is not None:
    return slots
  return torch.nonzero(mask).flatten().tolist()


def _pixel_association_with_keyframe(
    pos: torch.Tensor, normal: torch.Tensor, valid: torch.Tensor,
    frame_T_global: torch.Tensor, kf_depth: torch.Tensor,
    kf_normals: torch.Tensor, depth_cam: PinholeCamera,
    dp: DepthCalibration):
  """associate_surfels plus the hit-cell ids: (assoc, cell_id, num_cells)."""
  assoc = association.associate_surfels(
      pos, normal, valid, frame_T_global, kf_depth, kf_normals, depth_cam, dp)
  hc, wc = _cell_grid_shape(depth_cam.height, depth_cam.width, dp.cell_size)
  cell_id = (assoc.py // dp.cell_size) * wc + (assoc.px // dp.cell_size)
  return assoc, cell_id, hc * wc


# --- Supporting-surfel detection (creation gate) ---


def supported_cell_mask(
    surfels: SurfelStore, frame_T_global: torch.Tensor,
    kf_depth: torch.Tensor, kf_normals: torch.Tensor,
    depth_cam: PinholeCamera, dp: DepthCalibration) -> torch.Tensor:
  """(Hc * Wc,) bool: cells of this keyframe that already have an associated
  surfel (DetermineSupportingSurfelsCUDAKernel without merging)."""
  assoc, cell_id, num_cells = _pixel_association_with_keyframe(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global,
      kf_depth, kf_normals, depth_cam, dp)
  # Lanes that are not associated go to an extra cell that is cut off.
  support = torch.zeros((num_cells + 1,), dtype=torch.bool,
                        device=cell_id.device)
  # (A Python value assigned through an index is first copied to the
  # device, which waits for the stream; index_fill_ takes it as an
  # argument.)
  support.index_fill_(0, torch.where(assoc.mask, cell_id, num_cells), True)
  return support[:num_cells]


# --- Surfel creation ---


class NewSurfelCandidates(NamedTuple):
  mask: torch.Tensor       # (P,) bool, the pixel spawns a surfel
  pos: torch.Tensor        # (P, 3) global position
  normal: torch.Tensor     # (P, 3) global normal
  radius_sq: torch.Tensor  # (P,)
  color: torch.Tensor      # (P, 3) float [0, 1]
  desc: torch.Tensor       # (P, 2)


def _first_valid_pixel_per_cell(candidate: torch.Tensor,
                                cell: int) -> torch.Tensor:
  """(H, W) bool -> (H, W) bool keeping only the first candidate pixel, in
  row-major order, inside each cell x cell sparsification block."""
  h, w = candidate.shape
  hc, wc = _cell_grid_shape(h, w, cell)
  p = torch.zeros((hc * cell, wc * cell), dtype=torch.bool,
                  device=candidate.device)
  p[:h, :w] = candidate
  # (Hc, cell, Wc, cell) -> (Hc, Wc, cell * cell), row-major inside a cell.
  blocks = p.reshape(hc, cell, wc, cell).permute(0, 2, 1, 3).reshape(
      hc, wc, cell * cell)
  in_cell = torch.arange(cell * cell, device=candidate.device)
  # The lowest in-cell index among the candidates; cell * cell if none.
  first = torch.where(blocks, in_cell, cell * cell).amin(dim=-1)
  onehot = in_cell == first[..., None]
  out = onehot.reshape(hc, wc, cell, cell).permute(0, 2, 1, 3).reshape(
      hc * cell, wc * cell)
  return out[:h, :w]


def compute_new_surfel_candidates(
    surfels: SurfelStore,
    kf_depth: torch.Tensor,      # (H, W) filtered metric depth, 0 invalid
    kf_normals: torch.Tensor,    # (H, W, 2)
    kf_radius_sq: torch.Tensor,  # (H, W)
    kf_intensity: torch.Tensor,  # (H, W) in [0, 1]
    kf_rgb: torch.Tensor,        # (H, W, 3) uint8
    global_T_frame: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
) -> NewSurfelCandidates:
  """Candidate surfels for every pixel of a keyframe whose sparsification
  cell has no supporting surfel (serializing kernel + CreateNewSurfel,
  kernel_create_surfels.cu:41-162), as dense (P = H * W) masked attributes."""
  h, w = kf_depth.shape
  dev = kf_depth.device
  frame_T_global = se3.inverse(global_T_frame)

  support = supported_cell_mask(
      surfels, frame_T_global, kf_depth, kf_normals, depth_cam, dp)
  hc, wc = _cell_grid_shape(h, w, dp.cell_size)
  support_img = support.reshape(hc, wc)

  ys, xs = torch.meshgrid(torch.arange(h, device=dev),
                          torch.arange(w, device=dev), indexing="ij")
  valid = kf_depth > 0.0
  border = (xs >= 1) & (ys >= 1) & (xs < w - 1) & (ys < h - 1)  # kBorder = 1
  unsupported = ~support_img[ys // dp.cell_size, xs // dp.cell_size]
  candidate = _first_valid_pixel_per_cell(valid & border & unsupported,
                                          dp.cell_size)

  # Attributes (CreateNewSurfel, kernel_create_surfels.cu:97-162).
  xs_f, ys_f = xs.to(torch.float32), ys.to(torch.float32)
  calibrated = depth_model.calibrate_depth_image(
      dp.a, dp.cfactor, kf_depth, dp.cell_size)
  local_pos = depth_cam.unproject_center(xs_f, ys_f, calibrated)
  gpos = se3.transform_points(global_T_frame, local_pos.reshape(-1, 3))
  gnormal = se3.rotate(global_T_frame, normals_3d(kf_normals).reshape(-1, 3))
  radius_sq = kf_radius_sq.reshape(-1)

  # Color sample at the color-camera pixel (corner convention: +0.5).
  d2c = DepthToColorTransform.between(depth_cam, color_cam)
  depth_pxy = torch.stack([xs_f + 0.5, ys_f + 0.5], dim=-1).reshape(-1, 2)
  color_pxy, _ = d2c.apply(depth_pxy)
  rgb_f = kf_rgb.to(torch.float32) * (1.0 / 255.0)
  color = torch.stack(
      [interp.sample_bilinear(rgb_f[..., c], color_pxy[:, 0], color_pxy[:, 1])
       for c in range(3)], dim=-1)

  # The initial descriptor is the raw residual against a zero descriptor,
  # 180 * (I(t_i) - I(c)) (kernel_create_surfels.cu:141-151).
  t1_pxy, t2_pxy = cost.tangent_projections(
      gpos, gnormal, radius_sq,
      frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
  d1, d2 = cost.raw_descriptor_residual(
      kf_intensity, color_pxy, t1_pxy, t2_pxy,
      torch.zeros((h * w, 2), dtype=torch.float32, device=dev))

  return NewSurfelCandidates(
      mask=candidate.reshape(-1), pos=gpos, normal=gnormal,
      radius_sq=radius_sq, color=color, desc=torch.stack([d1, d2], dim=-1))


def filter_candidates_by_observations(
    cand: NewSurfelCandidates,
    covis_depth: torch.Tensor,     # (K, H, W) full keyframe depth stack
    covis_normals: torch.Tensor,   # (K, H, W, 2)
    covis_T_global: torch.Tensor,  # (K, 4, 4) global_T_frame per keyframe
    covis_mask: torch.Tensor,      # (K,) bool, covisible with the keyframe
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
    min_observation_count: int,
    slots: Optional[Sequence[int]] = None,
) -> torch.Tensor:
  """The filtered candidate mask: each candidate starts with one observation
  (its own keyframe), gathers observations and free-space violations over
  the covisible keyframes, and survives iff ``obs >= min_observation_count
  and violations <= obs`` (CountObservationsForNewSurfelsCUDAKernel +
  FilterNewSurfelsCUDAKernel, kernel_create_surfels.cu:214-337).

  ``slots``, where given, are host ints that hold the covisible slots (the
  valid ones, say): each is masked with ``covis_mask`` on the device, so
  the mask is never read back."""
  obs = torch.ones_like(cand.mask, dtype=torch.int32)
  fsv = torch.zeros_like(obs)
  for k in _slots_of(covis_mask, slots):
    assoc = association.associate_surfels(
        cand.pos, cand.normal, cand.mask, se3.inverse(covis_T_global[k]),
        covis_depth[k], covis_normals[k], depth_cam, dp)
    seen, violated = assoc.mask, assoc.free_space_violation
    if slots is not None:
      seen, violated = seen & covis_mask[k], violated & covis_mask[k]
    obs = obs + seen.to(torch.int32)
    fsv = fsv + violated.to(torch.int32)
  return cand.mask & (obs >= min_observation_count) & (fsv <= obs)


def create_surfels_for_keyframe(
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_radius_sq: torch.Tensor,
    kf_intensity: torch.Tensor,
    kf_rgb: torch.Tensor,
    global_T_frame: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    covis_depth: torch.Tensor,
    covis_normals: torch.Tensor,
    covis_T_global: torch.Tensor,
    covis_mask: torch.Tensor,
    min_observation_count: int,
    filter_new_surfels: bool = True,
    covis_slots: Optional[Sequence[int]] = None,
) -> SurfelStore:
  """The creation pipeline (CreateSurfelsForKeyframeCUDA and its host caller,
  direct_ba.cc:340-405). New surfels are appended and marked active."""
  cand = compute_new_surfel_candidates(
      surfels, kf_depth, kf_normals, kf_radius_sq, kf_intensity, kf_rgb,
      global_T_frame, depth_cam, color_cam, dp)
  mask = cand.mask
  if filter_new_surfels:
    mask = filter_candidates_by_observations(
        cand, covis_depth, covis_normals, covis_T_global, covis_mask,
        depth_cam, dp, min_observation_count, covis_slots)
  return surfels_mod.append(
      surfels, cand.pos, cand.normal, cand.radius_sq, cand.color, cand.desc,
      mask)


# --- Supporting-surfel merge ---


def merge_surfels_for_keyframe(
    surfels: SurfelStore,
    frame_T_global: torch.Tensor,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
    surfel_merge_dist_factor: float = 0.8,
) -> SurfelStore:
  """Merge redundant surfels that associate with the same sparsification
  cell of this keyframe (DetermineSupportingSurfelsAndMergeSurfelsCUDA,
  kernel_supporting_surfels.cu:45-97).

  Each round selects the lowest-index unresolved surfel per cell as cluster
  head; surfels mergeable with their head (normal dot > cos(45 deg), squared
  distance < merge_factor^2 * min radius^2) are invalidated; the others go
  to the next round (the original holds up to kMergeBufferCount = 3 heads
  per cell)."""
  assoc, cell_id, num_cells = _pixel_association_with_keyframe(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global,
      kf_depth, kf_normals, depth_cam, dp)
  n = surfels.capacity
  idx = torch.arange(n, device=surfels.device)
  merge_dist_sq = surfel_merge_dist_factor * surfel_merge_dist_factor

  alive = surfels.valid
  unresolved = assoc.mask  # still competing for a cell slot
  for _ in range(MERGE_ROUNDS):
    contender = unresolved & alive
    seg = torch.where(contender, cell_id, num_cells)
    head_per_cell = torch.full((num_cells + 1,), n, dtype=torch.int64,
                               device=surfels.device)
    head_per_cell.scatter_reduce_(0, seg, torch.where(contender, idx, n),
                                  "amin", include_self=True)
    my_head = head_per_cell[seg]
    is_head = contender & (my_head == idx)
    has_head = contender & (my_head < idx) & (my_head < n)
    head_safe = my_head.clamp(0, n - 1)

    normal_ok = (torch.sum(surfels.normal[head_safe] * surfels.normal, dim=-1)
                 > COS_SURFEL_MERGE_NORMAL_THRESHOLD)
    min_radius_sq = torch.minimum(surfels.radius_sq[head_safe],
                                  surfels.radius_sq)
    dist_ok = (torch.sum((surfels.pos[head_safe] - surfels.pos) ** 2, dim=-1)
               < min_radius_sq * merge_dist_sq)
    merged = has_head & normal_ok & dist_ok
    alive = alive & ~merged
    # Heads and merged surfels leave the competition; the rest try again.
    unresolved = unresolved & ~is_head & ~merged

  # count (the allocation watermark) stays: lowering it would let the next
  # append() overwrite live surfels.
  return surfels._replace(valid=alive, active=surfels.active & alive)


# --- Deletion + radius update ---


def delete_surfels_and_update_radii(
    surfels: SurfelStore,
    kf: KeyframeStore,
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
    min_observation_count: int,
    update_radii: bool = True,
    slots: Optional[Sequence[int]] = None,
) -> SurfelStore:
  """Count observations and free-space violations over all valid keyframes;
  delete surfels with obs < min_observation_count or violations > obs; set
  the radius to the minimum observed pixel radius
  (DeleteSurfelsAndUpdateRadiiCUDA, kernel_delete_surfels.cu:42-160)."""
  n, dev = surfels.capacity, surfels.device
  obs = torch.zeros((n,), dtype=torch.int32, device=dev)
  fsv = torch.zeros((n,), dtype=torch.int32, device=dev)
  min_r = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
  for k in _slots_of(kf.valid, slots):
    assoc = association.associate_surfels(
        surfels.pos, surfels.normal, surfels.valid,
        se3.inverse(kf.global_T_frame[k]), kf.depth[k], kf.normals[k],
        depth_cam, dp)
    obs = obs + assoc.mask.to(torch.int32)
    fsv = fsv + assoc.free_space_violation.to(torch.int32)
    if update_radii:
      r_obs = interp.gather_image(kf.radius_sq[k], assoc.py, assoc.px)
      min_r = torch.where(assoc.mask, torch.minimum(min_r, r_obs), min_r)

  delete = surfels.valid & ((obs < min_observation_count) | (fsv > obs))
  alive = surfels.valid & ~delete
  new_radius = surfels.radius_sq
  if update_radii:
    new_radius = torch.where(alive & torch.isfinite(min_r), min_r, new_radius)
  return surfels._replace(valid=alive, active=surfels.active & alive,
                          radius_sq=new_radius)


# --- Activation ---


def update_surfel_activation(
    surfels: SurfelStore,
    kf: KeyframeStore,
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
    keep_active: torch.Tensor,  # (N,) bool, surfels forced active (new ones)
    slots: Optional[Sequence[int]] = None,
) -> SurfelStore:
  """A surfel is active iff an ACTIVE keyframe observes it, or it is forced
  (UpdateSurfelActivationCUDA, kernel_surfel_activation.cu:38-80)."""
  active = keep_active & surfels.valid
  for k in _slots_of(kf.valid & (kf.activation == ACTIVE), slots):
    assoc = association.associate_surfels(
        surfels.pos, surfels.normal, surfels.valid,
        se3.inverse(kf.global_T_frame[k]), kf.depth[k], kf.normals[k],
        depth_cam, dp)
    active = active | assoc.mask
  return surfels._replace(active=active & surfels.valid)


# --- Color assignment (export) ---


def assign_colors(
    surfels: SurfelStore,
    kf: KeyframeStore,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    slots: Optional[Sequence[int]] = None,
) -> SurfelStore:
  """Set each surfel's color to the average of its observed keyframe colors
  (AssignColorsCUDA, kernel_assign_colors.cu:42-140), to refresh the colors
  before an export."""
  n, dev = surfels.capacity, surfels.device
  d2c = DepthToColorTransform.between(depth_cam, color_cam)
  count = torch.zeros((n,), dtype=torch.float32, device=dev)
  rgb_sum = torch.zeros((n, 3), dtype=torch.float32, device=dev)
  for k in _slots_of(kf.valid, slots):
    assoc = association.associate_surfels(
        surfels.pos, surfels.normal, surfels.valid,
        se3.inverse(kf.global_T_frame[k]), kf.depth[k], kf.normals[k],
        depth_cam, dp)
    color_pxy, in_color = d2c.apply(assoc.pxy)
    m = assoc.mask & in_color
    rgb_f = kf.rgb[k].to(torch.float32) * (1.0 / 255.0)
    sample = torch.stack(
        [interp.sample_bilinear(rgb_f[..., c], color_pxy[:, 0],
                                color_pxy[:, 1]) for c in range(3)], dim=-1)
    count = count + m.to(torch.float32)
    rgb_sum = rgb_sum + torch.where(m[:, None], sample, 0.0)
  new_color = torch.where(
      (count > 0)[:, None], rgb_sum / torch.clamp(count, min=1.0)[:, None],
      surfels.color)
  return surfels._replace(color=new_color)
