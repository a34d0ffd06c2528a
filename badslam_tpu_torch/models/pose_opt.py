"""Frame-to-model pose estimation: Gauss-Newton on the direct cost.

Port of ``badslam_tpu/models/pose_opt.py`` (``EstimateFramePose``,
direct_ba_alternating.cc:42-283 of the original BAD SLAM): up to 30 GN
iterations; each accumulates a 6x6 H and a 6-vector b over all surfels
(depth point-to-plane + two descriptor residuals), solves H x = b, applies
``T <- T * exp(-x)`` and stops on IsScale1PoseEstimationConverged.

The H/b reduction and the 6x6 solve run on the device; each GN iteration
reads one convergence flag back to the host to end the loop.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.surfels import SurfelStore

_TRANSLATION_CONVERGENCE_THRESHOLD = 1e-6
_ROTATION_SCALE = 10.0  # translation_threshold / rotation_threshold


def is_scale1_converged(x: torch.Tensor) -> torch.Tensor:
  """IsScale1PoseEstimationConverged (convergence_analysis.h:45-52)."""
  scale = torch.tensor([1.0, 1.0, 1.0, _ROTATION_SCALE, _ROTATION_SCALE,
                        _ROTATION_SCALE], dtype=x.dtype, device=x.device)
  scaled = x * scale
  return (torch.sum(scaled * scaled, dim=-1)
          < _TRANSLATION_CONVERGENCE_THRESHOLD)


def solve_6x6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """6x6 GN solve in float32 with Jacobi equilibration and 2 steps of
  iterative refinement. A plain f32 solve loses the weak direction of an
  ill-conditioned H (translation and rotation columns differ by the scene
  scale); the reference solves in double.

  ``solve_ex`` does not check the factorization, so a singular H gives a
  non-finite x (which the caller zeroes) instead of raising, and the solve
  never waits for the device."""
  d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
  s = 1.0 / d
  Hs = H * s[:, None] * s[None, :]
  bs = b * s
  y = torch.linalg.solve_ex(Hs, bs)[0]
  for _ in range(2):
    r = bs - Hs @ y
    y = y + torch.linalg.solve_ex(Hs, r)[0]
  return y * s


def accumulate_pose_h_b(
    global_T_frame: torch.Tensor,
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    compute_cost: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """One evaluation of (H, b[, cost, residual_count]) at the given pose
  (AccumulatePoseEstimationCoeffsCUDAKernel, kernel_opt_pose.cu:252-383)."""
  dev = global_T_frame.device
  frame_T_global = se3.inverse(global_T_frame)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global,
      kf_depth, kf_normals, depth_cam, dp)

  H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
  b = torch.zeros((6,), dtype=torch.float32, device=dev)
  total_cost = torch.zeros((), dtype=torch.float32, device=dev)
  res_count = torch.zeros((), dtype=torch.int32, device=dev)

  if use_depth_residuals:
    unproj = depth_cam.unproject_center(
        assoc.px.to(torch.float32), assoc.py.to(torch.float32),
        assoc.calibrated_depth)
    r = cost.raw_depth_residual(unproj, assoc.local_pos, assoc.local_normal,
                                assoc.inv_stddev)
    J = cost.depth_residual_pose_jacobian(unproj, assoc.local_normal,
                                          assoc.inv_stddev)
    w = cost.depth_weight(r)
    Hd, bd = cost.accumulate_h_b(J, r, w, assoc.mask)
    H = H + Hd
    b = b + bd
    if compute_cost:
      total_cost = total_cost + torch.sum(
          torch.where(assoc.mask, cost.weighted_depth_cost(r), 0.0))
      res_count = res_count + torch.sum(assoc.mask.to(torch.int32))

  if use_descriptor_residuals:
    d2c = DepthToColorTransform.between(depth_cam, color_cam)
    color_pxy, in_color = d2c.apply(assoc.pxy)
    dmask = assoc.mask & in_color
    t1_pxy, t2_pxy = cost.tangent_projections(
        surfels.pos, surfels.normal, surfels.radius_sq,
        frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
    r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
        kf_intensity, color_pxy, t1_pxy, t2_pxy, surfels.desc)
    # The gradients scale by the center-convention focal lengths
    # (kernel_opt_pose.cu:117-120; fx is the same in both conventions).
    J1 = cost.projected_position_pose_jacobian(
        gx1 * color_cam.fx, gy1 * color_cam.fy, assoc.local_pos)
    J2 = cost.projected_position_pose_jacobian(
        gx2 * color_cam.fx, gy2 * color_cam.fy, assoc.local_pos)
    H1, b1 = cost.accumulate_h_b(J1, r1, cost.descriptor_weight(r1), dmask)
    H2, b2 = cost.accumulate_h_b(J2, r2, cost.descriptor_weight(r2), dmask)
    H = H + H1 + H2
    b = b + b1 + b2
    if compute_cost:
      total_cost = total_cost + torch.sum(
          torch.where(dmask, cost.weighted_descriptor_cost(r1), 0.0))
      res_count = res_count + torch.sum(dmask.to(torch.int32))

  return H, b, total_cost, res_count


def estimate_frame_pose(
    global_T_frame_init: torch.Tensor,
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_iterations: int = 30,
) -> Tuple[torch.Tensor, bool]:
  """Returns (global_T_frame_estimate, converged). The loop ends on the
  host, so each iteration reads the convergence flag from the device."""
  T = global_T_frame_init
  converged = False
  for _ in range(max_iterations):
    H, b, _, _ = accumulate_pose_h_b(
        T, surfels, kf_depth, kf_normals, kf_intensity, depth_cam,
        color_cam, dp, use_depth_residuals, use_descriptor_residuals)
    x = solve_6x6(H, b)
    # A singular H (no associations) must not poison the pose.
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    T = T @ se3.exp(-x)
    converged = bool(is_scale1_converged(x))
    if converged:
      break
  return T, converged


def estimate_frame_poses_batched(
    global_T_frame_init: torch.Tensor,  # (K, 4, 4)
    optimize_mask: torch.Tensor,        # (K,) bool, keyframes to optimize
    surfels: SurfelStore,
    kf_depth: torch.Tensor,             # (K, H, W)
    kf_normals: torch.Tensor,           # (K, H, W, 2)
    kf_intensity: torch.Tensor,         # (K, H, W)
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_iterations: int = 30,
    slots: Optional[Sequence[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frame-to-model pose GN of every keyframe in ``optimize_mask``.

  Within one alternation step the surfel map is fixed, so the keyframes'
  pose problems are independent. The reference runs them as lanes of one
  shared loop in which a lane's converging step is applied before the lane
  freezes; one GN loop per keyframe with the same cap gives the same poses
  and bounds the temporaries to one keyframe times the surfel capacity.

  ``slots`` are the indices of ``optimize_mask`` as host ints, for a caller
  that has them; otherwise the mask is read back once.

  Returns (global_T_frame (K, 4, 4), moved (K,) bool). ``moved`` is the
  reference's frame_moved = !IsScale1PoseEstimationConverged(diff.log()) on
  the total pose change (direct_ba_alternating.cc:564-566)."""
  if slots is None:
    slots = torch.nonzero(optimize_mask).flatten().tolist()
  T = global_T_frame_init.clone()
  for k in slots:
    T[k], _ = estimate_frame_pose(
        global_T_frame_init[k], surfels, kf_depth[k], kf_normals[k],
        kf_intensity[k], depth_cam, color_cam, dp, use_depth_residuals,
        use_descriptor_residuals, max_iterations)
  diff = se3.inverse(global_T_frame_init) @ T
  moved = optimize_mask & ~is_scale1_converged(se3.log(diff))
  return T, moved
