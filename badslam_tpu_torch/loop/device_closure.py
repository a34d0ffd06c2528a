"""Loop-closure verification and application as one device program.

Port of ``badslam_tpu/loop/device_closure.py``. The host chain of
``loop/detector.py`` (loop_detector.cc:284-705) reads keyframe poses back
for the refinement inits, the consistency gates, the is-BA-enough test and
the pose graph. The pipelined front-end reads nothing in its loop, so
everything after RANSAC runs here, on the device, and applies or not by
``torch.where``:

  refinement x3 (the matched, next and previous keyframes, direct
  multi-scale tracking on the stored keyframes, loop_detector.cc:436-548)
  -> mutual-consistency gates (<= 10 degrees, <= 2 cm, :575-604)
  -> pose averaging (:606-609)
  -> is-BA-enough reprojection test (<= 1 px mean keypoint motion, :624-666)
  -> depth-sanity gate (below)
  -> pose-graph LM over the whole keyframe store with the loop edge and the
     earlier applied ones (:670-705, ``loop/pose_graph.optimize_poses``)
  -> poses' = where(applied, optimized, poses)

What comes from the host is known there already: the RANSAC estimate (from
the detector's host keypoints) and the odometry-edge list (from the store's
host valid mirror). The outcome stays on the device; the detector keeps it
as a pending event that ``BadSlam.finalize_pipelined`` resolves.

``alignment_depth_sanity`` is also the host chain's gate. It goes beyond the
original: it takes the mean |depth mismatch| of
the refined alignment, normalized by the propagated-stddev model sigma(z) =
z^2 / (baseline fx) (cost_function.cuh:81-88). A true closure refines to
mm-cm alignment (ratio <= ~0.2); a perceptual-aliasing match (identical
texture, different geometry) converges onto depth fields whose mismatch is
the scene's structure scale (~1.3-1.5 measured by the reference on its
aliasing world, where 10 of 388 aliased candidates otherwise passed RANSAC
and the three-way refinement gates).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.loop.pose_graph import optimize_poses

# Keypoint clouds are padded to this many points.
KEYPOINT_BUCKET = 512

MAX_ANGLE_DIFFERENCE = 3.14159265 / 180.0 * 10.0  # loop_detector.cc:577
MAX_EUCLIDEAN_DISTANCE = 0.02                     # loop_detector.cc:578
AVERAGE_PIXEL_DISTANCE_THRESHOLD = 1.0            # loop_detector.cc:655

DEPTH_SANITY_RATIO = 0.5
DEPTH_SANITY_MIN_OVERLAP = 200
MAX_DEPTH = 100.0   # depths at or beyond this are invalid on both sides

# Capacity of the ring of applied loop edges on the device (the host chain
# keeps an unbounded list, detector.applied_loop_edges).
LOOP_EDGE_BUCKET = 32


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
  """a * b + c of float32 tensors, rounded to float32 once."""
  return (a.double() * b.double() + c.double()).float()


def alignment_depth_sanity(cur_depth: torch.Tensor, old_depth: torch.Tensor,
                           old_T_cur: torch.Tensor, depth_intr: torch.Tensor,
                           baseline_fx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(mean |dz| / sigma(z), overlap count), both 0-d tensors, of warping
  cur's depth into the old keyframe under the refined relative pose, with
  nearest-neighbour sampling (a sanity gate, not a residual)."""
  h, w = cur_depth.shape
  dev = cur_depth.device
  fx, fy, cx, cy = depth_intr[0], depth_intr[1], depth_intr[2], depth_intr[3]
  ys, xs = torch.meshgrid(
      torch.arange(h, dtype=torch.float32, device=dev),
      torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
  z = cur_depth
  valid = (z > 0) & (z < MAX_DEPTH)
  px = (xs + 0.5 - cx) / fx * z
  py = (ys + 0.5 - cy) / fy * z
  p = torch.stack([px, py, z], dim=-1)
  q = p @ old_T_cur[:3, :3].T + old_T_cur[:3, 3]
  qz = q[..., 2]
  front = qz > 1e-3
  qzs = torch.where(front, qz, 1.0)
  # x / z * f + c is rounded once after the product and the sum, as the
  # reference's compiled program does with a fused multiply-add (float64
  # holds the product and the sum exactly): a one-ulp difference here moves
  # a pixel that lies on a rounding tie to its other neighbour.
  u = _fma32(q[..., 0] / qzs, fx, cx) - 0.5
  v = _fma32(q[..., 1] / qzs, fy, cy) - 0.5
  # torch.round rounds half to even, as jnp.round does.
  ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
  vi = torch.clamp(torch.round(v).to(torch.int64), 0, h - 1)
  inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
  sampled = old_depth[vi, ui]
  ok = valid & front & inb & (sampled > 0) & (sampled < MAX_DEPTH)
  sigma = torch.clamp(sampled * sampled / baseline_fx, min=1e-4)
  ratio = torch.abs(qz - sampled) / sigma
  n = torch.sum(ok)
  mean_ratio = torch.sum(torch.where(ok, ratio, 0.0)) / torch.clamp(n, min=1)
  return mean_ratio, n


class DeviceClosureResult(NamedTuple):
  global_T_frame: torch.Tensor  # (K, 4, 4) new keyframe poses
  applied: torch.Tensor         # () bool
  ba_enough: torch.Tensor       # () bool: rejected as absorbable by BA
  consistent: torch.Tensor      # () bool: the refinements agree
  avg_px: torch.Tensor          # () mean keypoint reprojection motion
  depth_sane: torch.Tensor      # () bool: the aligned depth fields agree
  t_norm: torch.Tensor          # () |t| of the averaged constraint
  loop_ei: torch.Tensor         # (L,) ring of applied loop edges
  loop_ej: torch.Tensor         # (L,)
  loop_Z: torch.Tensor          # (L, 4, 4)
  loop_w: torch.Tensor          # (L,) 0 = unused slot
  loop_count: torch.Tensor      # () int64 applied edges so far


def empty_loop_edges(device) -> Tuple[torch.Tensor, ...]:
  """An empty ring of applied loop edges: (ei, ej, Z, w, count)."""
  n = LOOP_EDGE_BUCKET
  return (torch.zeros(n, dtype=torch.int64, device=device),
          torch.zeros(n, dtype=torch.int64, device=device),
          torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1),
          torch.zeros(n, dtype=torch.float32, device=device),
          torch.zeros((), dtype=torch.int64, device=device))


Tracker = Callable[[int, int, torch.Tensor], torch.Tensor]


def verify_and_close(
    poses: torch.Tensor,            # (K, 4, 4) keyframe global_T_frame
    kf_depth: torch.Tensor,         # (K, H, W)
    track: Tracker,
    depth_intr: torch.Tensor, baseline_fx: torch.Tensor,
    cur_slot: int, old_slot: int, nxt_slot: int, prv_slot: int,
    old_T_cur_init: torch.Tensor,   # (4, 4) RANSAC estimate
    cur_pts: torch.Tensor,          # (P, 3) keypoint unprojections
    cur_pts_mask: torch.Tensor,     # (P,) bool
    proj_intr,                      # detector camera (fx, fy, cx, cy)
    edges_i: torch.Tensor, edges_j: torch.Tensor,  # (E,) odometry edges
    edge_weight: torch.Tensor,      # (E,) 0 for padding
    kf_edge_weight: torch.Tensor,   # (capacity,) odometry-edge confidence
    loop_edges: Tuple[torch.Tensor, ...],
) -> DeviceClosureResult:
  """Refine, gate and conditionally apply one loop candidate on the device.
  ``track(base_slot, tracked_slot, init)`` is the transfer-free direct
  tracking of two stored keyframes (base_T_tracked); the slots are host
  ints, known from the store's valid mirror."""
  loop_ei, loop_ej, loop_Z, loop_w, loop_count = loop_edges
  dev = poses.device
  eye = torch.eye(4, dtype=torch.float32, device=dev)
  matched_frame_T_global = se3.inverse(poses[old_slot])

  def refine(slot):
    """cur_T_old from tracking keyframe ``slot`` against the current one
    (loop_detector.cc:498-548)."""
    matched_T_this = (eye if slot == old_slot
                      else matched_frame_T_global @ poses[slot])
    init = se3.inverse(old_T_cur_init) @ matched_T_this
    cur_T_tracked = track(cur_slot, slot, init)
    return se3.inverse(matched_T_this @ se3.inverse(cur_T_tracked))

  refined = torch.stack([refine(old_slot), refine(nxt_slot),
                         refine(prv_slot)])

  # Mutual-consistency gates over the three estimates.
  consistent = torch.isfinite(refined).all()
  for i in range(2):
    for j in range(i + 1, 3):
      zi, zj = refined[i, :3, 2], refined[j, :3, 2]
      ang = torch.arccos(torch.clamp(zi @ zj, -1.0, 1.0))
      dt = torch.linalg.norm(refined[i, :3, 3] - refined[j, :3, 3])
      consistent = (consistent & (ang <= MAX_ANGLE_DIFFERENCE)
                    & (dt <= MAX_EUCLIDEAN_DISTANCE))

  cur_T_old_avg = se3.average_poses(refined)

  # Is-BA-enough reprojection test on the host-made keypoint cloud.
  delta = cur_T_old_avg @ matched_frame_T_global @ poses[cur_slot]
  moved = cur_pts @ delta[:3, :3].T + delta[:3, 3]
  fx, fy, cx, cy = proj_intr

  def project(p):
    z = p[:, 2]
    okz = z > 0
    zsafe = torch.where(okz, z, 1.0)
    return torch.stack([fx * p[:, 0] / zsafe + cx,
                        fy * p[:, 1] / zsafe + cy], dim=-1), okz

  pe, oke = project(moved)
  pc, okc = project(cur_pts)
  both = oke & okc & cur_pts_mask
  n_both = torch.sum(both)
  dist = torch.linalg.norm(pe - pc, dim=1)
  avg_px = (torch.sum(torch.where(both, dist, 0.0))
            / torch.clamp(n_both, min=1))
  ba_enough = (n_both >= 5) & (avg_px <= AVERAGE_PIXEL_DISTANCE_THRESHOLD)

  sanity_ratio, overlap = alignment_depth_sanity(
      kf_depth[cur_slot], kf_depth[old_slot], se3.inverse(cur_T_old_avg),
      depth_intr, baseline_fx)
  depth_sane = ((overlap >= DEPTH_SANITY_MIN_OVERLAP)
                & (sanity_ratio <= DEPTH_SANITY_RATIO))

  applied = consistent & depth_sane & ~ba_enough

  # Pose graph: the odometry edges at their current relative poses (zero
  # residual) weighted by the front-end's confidence, every applied loop
  # edge so far, and the new one, cur -> old.
  cur_t = torch.full((1,), cur_slot, dtype=torch.int64, device=dev)
  old_t = torch.full((1,), old_slot, dtype=torch.int64, device=dev)
  ei = torch.cat([edges_i, loop_ei, cur_t])
  ej = torch.cat([edges_j, loop_ej, old_t])
  odo_Z = se3.inverse(poses[edges_i]) @ poses[edges_j]
  Z = torch.cat([odo_Z, loop_Z, cur_T_old_avg[None]], dim=0)
  w = torch.cat([edge_weight * kf_edge_weight[edges_j], loop_w,
                 torch.ones(1, dtype=torch.float32, device=dev)])
  optimized = optimize_poses(poses, ei, ej, Z, w)
  new_poses = torch.where(applied, optimized, poses)

  # Remember an applied edge in a ring: past the bucket the oldest slot is
  # overwritten, so the newest closures are always kept.
  record = applied & (torch.arange(LOOP_EDGE_BUCKET, device=dev)
                      == loop_count % LOOP_EDGE_BUCKET)
  loop_ei = torch.where(record, cur_slot, loop_ei)
  loop_ej = torch.where(record, old_slot, loop_ej)
  loop_Z = torch.where(record[:, None, None], cur_T_old_avg, loop_Z)
  loop_w = torch.where(record, 1.0, loop_w)
  loop_count = loop_count + applied.to(torch.int64)

  return DeviceClosureResult(
      global_T_frame=new_poses, applied=applied, ba_enough=ba_enough,
      consistent=consistent, avg_px=avg_px, depth_sane=depth_sane,
      t_norm=torch.linalg.norm(cur_T_old_avg[:3, 3]),
      loop_ei=loop_ei, loop_ej=loop_ej, loop_Z=loop_Z, loop_w=loop_w,
      loop_count=loop_count)
