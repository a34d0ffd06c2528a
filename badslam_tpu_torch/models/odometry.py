"""Pairwise (frame-to-frame) direct tracking: multi-scale Gauss-Newton.

Port of ``badslam_tpu/models/odometry.py`` (pairwise_frame_tracking.cc and
kernel_opt_pose.cu:422-711 of the original BAD SLAM):

  * coarse-to-fine over the pyramid levels, scaling_factor = 2^scale;
  * per scale <= 30 GN iterations of ``T <- T * exp(-damping * x)``, damping
    0.25 / 0.5 on the two coarsest scales;
  * a two-hypothesis pick by residual count (2x margin), then cost;
  * residuals per *base*-frame pixel projected into the tracked frame: the
    point-to-plane depth residual and two x/y-gradient descriptor residuals.

The reference's ``lax.while_loop`` is a Python loop here: its convergence
test reads one device scalar per GN iteration (up to 30 per scale). The
two-hypothesis pick stays on the device (``torch.where``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models import cost
from badslam_tpu_torch.models.association import (
    COS_NORMAL_COMPATIBILITY_THRESHOLD,
    DEPTH_TUKEY_PARAMETER,
    depth_residual_inv_stddev,
)
from badslam_tpu_torch.models.pose_opt import solve_6x6
from badslam_tpu_torch.ops import interp
from badslam_tpu_torch.ops.depth_proc import normals_3d
from badslam_tpu_torch.ops.pyramid import FramePyramidLevel
from badslam_tpu_torch.utils.transfer import DonePoll

# convergence_analysis.h:56-63, tuned by the reference for 640x480.
_SCALE_N_THRESHOLD = 1e-8


def is_scale_n_converged(x: torch.Tensor, scaling_factor: float,
                         threshold: float = _SCALE_N_THRESHOLD
                         ) -> torch.Tensor:
  return torch.sum(x * x) < (scaling_factor * scaling_factor) * threshold


class FrameToFrameResiduals(NamedTuple):
  mask: torch.Tensor      # (P,) fully-visible pixels
  depth_r: torch.Tensor   # (P,)
  depth_J: torch.Tensor   # (P, 6)
  desc_r1: torch.Tensor   # (P,)
  desc_r2: torch.Tensor   # (P,)
  desc_J1: torch.Tensor   # (P, 6)
  desc_J2: torch.Tensor   # (P, 6)


def _project_guarded(cam: PinholeCamera, p: torch.Tensor):
  """Corner projection of points, with points behind the camera replaced by
  (0, 0, 1) first; returns (pxy, z_ok)."""
  z_ok = p[:, 2] > 0.0
  fallback = torch.eye(3, dtype=p.dtype, device=p.device)[2]
  return cam.project_corner(torch.where(z_ok[:, None], p, fallback)), z_ok


def _frame_to_frame_terms(
    tracked_T_base: torch.Tensor,
    base: FramePyramidLevel,
    tracked: FramePyramidLevel,
    depth_cam: PinholeCamera,
    baseline_fx,
    threshold_factor: float,
    use_descriptor_residuals: bool,
    residual_type: str = "gradient_xy",
) -> FrameToFrameResiduals:
  """All residuals and Jacobians of one pyramid level at the given relative
  pose. ``residual_type`` is "gradient_xy" (two x/y-gradient descriptor
  residuals) or "gradmag" (one photometric residual on gradient-magnitude
  images held in the levels' ``intensity``)."""
  h, w = base.depth.shape
  dev = base.depth.device
  ys, xs = torch.meshgrid(
      torch.arange(h, dtype=torch.float32, device=dev),
      torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
  xs = xs.reshape(-1)
  ys = ys.reshape(-1)
  base_depth = base.depth.reshape(-1)
  d_ok = base_depth > 0.0

  R = tracked_T_base[0:3, 0:3]
  t = tracked_T_base[0:3, 3]

  base_pts = depth_cam.unproject_center(xs, ys,
                                        torch.where(d_ok, base_depth, 1.0))
  local = base_pts @ R.T + t
  pxy, z_ok = _project_guarded(depth_cam, local)
  in_img = depth_cam.in_image(pxy) & z_ok
  px = torch.clamp(pxy[:, 0].to(torch.int64), 0, w - 1)
  py = torch.clamp(pxy[:, 1].to(torch.int64), 0, h - 1)

  tracked_combo = torch.cat([tracked.depth[..., None], tracked.normals],
                            dim=-1)
  g_combo = interp.gather_image(tracked_combo, py, px)
  frame_depth = g_combo[..., 0]
  fd_ok = frame_depth > 0.0

  # Association with the base pixel as the implicit surfel
  # (IsAssociatedWithPixel, surfel_projection_nvcc_only.cuh:177-236).
  base_n = normals_3d(base.normals.reshape(-1, 2))
  local_n = base_n @ R.T
  pxf = px.to(torch.float32)
  pyf = py.to(torch.float32)
  inv_stddev = depth_residual_inv_stddev(depth_cam.nx(pxf), depth_cam.ny(pyf),
                                         frame_depth, local_n, baseline_fx)
  thresh = (threshold_factor * DEPTH_TUKEY_PARAMETER) / inv_stddev
  band_ok = torch.abs(local[:, 2] - frame_depth) <= thresh
  facing = torch.sum(local * local_n, dim=-1) <= 0.0
  tracked_n = normals_3d(g_combo[..., 1:3])
  compat = (torch.sum(local_n * tracked_n, dim=-1)
            >= COS_NORMAL_COMPATIBILITY_THRESHOLD)
  mask = d_ok & in_img & fd_ok & band_ok & facing & compat

  unproj = depth_cam.unproject_center(pxf, pyf, frame_depth)
  depth_r = cost.raw_depth_residual(unproj, local, local_n, inv_stddev)
  depth_J = cost.depth_residual_pose_jacobian(unproj, local_n, inv_stddev)

  if not use_descriptor_residuals:
    z = torch.zeros_like(depth_r)
    z6 = torch.zeros_like(depth_J)
    return FrameToFrameResiduals(mask, depth_r, depth_J, z, z, z6, z6)

  if residual_type == "gradmag":
    ref_val = 255.0 * base.intensity.reshape(-1)
    r1 = cost.raw_color_residual(tracked.intensity, pxy, ref_val)
    gx, gy = cost.color_grads(tracked.intensity, pxy)
    desc_J1 = cost.projected_position_pose_jacobian(
        gx * depth_cam.fx, gy * depth_cam.fy, local)
    z = torch.zeros_like(r1)
    z6 = torch.zeros_like(desc_J1)
    return FrameToFrameResiduals(mask, depth_r, depth_J, r1, z, desc_J1, z6)

  # Base-side descriptor from the right/bottom neighbours
  # (kernel_opt_pose.cu:507-512); roll wraps, and has_nbr masks the wrap.
  inten = base.intensity
  i_c = inten.reshape(-1)
  i_r = torch.roll(inten, -1, dims=1).reshape(-1)
  i_b = torch.roll(inten, -1, dims=0).reshape(-1)
  desc1 = 180.0 * (i_r - i_c)
  desc2 = 180.0 * (i_b - i_c)
  has_nbr = (xs < w - 1) & (ys < h - 1)

  # Neighbour depths induced by the center pixel's plane (:517-534).
  n_b = base_n
  plane_d = (depth_cam.nx(xs) * base_depth * n_b[:, 0]
             + depth_cam.ny(ys) * base_depth * n_b[:, 1]
             + base_depth * n_b[:, 2])
  denom_x = (depth_cam.nx(xs + 1.0) * n_b[:, 0]
             + depth_cam.ny(ys) * n_b[:, 1] + n_b[:, 2])
  denom_y = (depth_cam.nx(xs) * n_b[:, 0]
             + depth_cam.ny(ys + 1.0) * n_b[:, 1] + n_b[:, 2])
  dx_depth = plane_d / torch.where(torch.abs(denom_x) > 1e-12, denom_x, 1e-12)
  dy_depth = plane_d / torch.where(torch.abs(denom_y) > 1e-12, denom_y, 1e-12)

  p_t1 = depth_cam.unproject_center(xs + 1.0, ys, dx_depth) @ R.T + t
  p_t2 = depth_cam.unproject_center(xs, ys + 1.0, dy_depth) @ R.T + t
  t1_pxy, t1_ok = _project_guarded(depth_cam, p_t1)
  t2_pxy, t2_ok = _project_guarded(depth_cam, p_t2)
  t_in = (depth_cam.in_image(t1_pxy) & depth_cam.in_image(t2_pxy)
          & t1_ok & t2_ok)

  dmask = mask & has_nbr & t_in

  r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
      tracked.intensity, pxy, t1_pxy, t2_pxy,
      torch.stack([desc1, desc2], dim=-1))
  desc_J1 = cost.projected_position_pose_jacobian(
      gx1 * depth_cam.fx, gy1 * depth_cam.fy, local)
  desc_J2 = cost.projected_position_pose_jacobian(
      gx2 * depth_cam.fx, gy2 * depth_cam.fy, local)

  # Descriptor visibility also gates the depth residual in the reference
  # kernel (`visible = false` is shared state).
  return FrameToFrameResiduals(dmask, depth_r, depth_J, r1, r2, desc_J1,
                               desc_J2)


def frame_to_frame_h_b(
    tracked_T_base, base, tracked, depth_cam, baseline_fx, threshold_factor,
    use_depth_residuals=True, use_descriptor_residuals=True,
    residual_type="gradient_xy",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Returns (H, b, residual_count), all on the device."""
  terms = _frame_to_frame_terms(
      tracked_T_base, base, tracked, depth_cam, baseline_fx, threshold_factor,
      use_descriptor_residuals, residual_type)
  dev = terms.mask.device
  H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
  b = torch.zeros((6,), dtype=torch.float32, device=dev)
  if use_depth_residuals:
    w = cost.depth_weight(terms.depth_r, threshold_factor)
    Hd, bd = cost.accumulate_h_b(terms.depth_J, terms.depth_r, w, terms.mask)
    H, b = H + Hd, b + bd
  if use_descriptor_residuals:
    w1 = cost.descriptor_weight(terms.desc_r1, threshold_factor)
    H1, b1 = cost.accumulate_h_b(terms.desc_J1, terms.desc_r1, w1,
                                 terms.mask)
    H, b = H + H1, b + b1
    if residual_type == "gradient_xy":
      w2 = cost.descriptor_weight(terms.desc_r2, threshold_factor)
      H2, b2 = cost.accumulate_h_b(terms.desc_J2, terms.desc_r2, w2,
                                   terms.mask)
      H, b = H + H2, b + b2
  return H, b, terms.mask.to(torch.int32).sum()


def frame_to_frame_cost(
    tracked_T_base, base, tracked, depth_cam, baseline_fx, threshold_factor,
    use_depth_residuals=True, use_descriptor_residuals=True,
    residual_type="gradient_xy",
) -> Tuple[torch.Tensor, torch.Tensor]:
  """(cost, residual_count) for the hypothesis pick
  (ComputeCostAndResidualCountFromImagesCUDA, kernel_opt_pose.cu:940+)."""
  terms = _frame_to_frame_terms(
      tracked_T_base, base, tracked, depth_cam, baseline_fx, threshold_factor,
      use_descriptor_residuals, residual_type)
  m = terms.mask
  n = m.to(torch.int32).sum()
  total = torch.zeros((), dtype=torch.float32, device=m.device)
  count = torch.zeros((), dtype=torch.int32, device=m.device)
  if use_depth_residuals:
    total = total + torch.where(
        m, cost.weighted_depth_cost(terms.depth_r, threshold_factor), 0.0
    ).sum()
    count = count + n
  if use_descriptor_residuals:
    total = total + torch.where(
        m, cost.weighted_descriptor_cost(terms.desc_r1, threshold_factor), 0.0
    ).sum()
    count = count + n
    if residual_type == "gradient_xy":
      total = total + torch.where(
          m, cost.weighted_descriptor_cost(terms.desc_r2, threshold_factor),
          0.0).sum()
      count = count + n
  return total, count


def _pick(c1, n1, c2, n2) -> torch.Tensor:
  """Hypothesis 1 wins with twice the residuals of 2, loses with half, else
  the lower cost wins. A device bool: no host read."""
  return torch.where(n1 > 2 * n2, True, torch.where(n2 > 2 * n1, False,
                                                    c1 < c2))


def track_frame_pairwise(
    base_pyramid: Sequence[FramePyramidLevel],
    tracked_pyramid: Sequence[FramePyramidLevel],
    depth_cam: PinholeCamera,
    baseline_fx,
    base_T_frame_initial_1: torch.Tensor,
    base_T_frame_initial_2: torch.Tensor,
    test_different_initial_estimates: bool = True,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    use_pyramid_level_0: bool = False,
    max_iterations_per_scale: int = 30,
    convergence_threshold: float = _SCALE_N_THRESHOLD,
    disable_reselection: bool = False,
    residual_type: str = "gradient_xy",
    transfer_free: bool = False,
    gn_iterations: Optional[List[int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Coarse-to-fine tracking; returns (base_T_frame, residual_count), both
  on the device. With ``transfer_free`` the GN loops end without the host
  waiting for the device (the pipelined front-end), with the same result.
  The pyramids hold *calibrated* depth, level 0 = full resolution.
  ``residual_count`` is the number of associated pixels in the finest
  scale's last GN iteration; the caller treats near-zero as a tracking
  failure. Where ``gn_iterations`` is given, each scale appends the number
  of H/b evaluations its GN loop launched (the host counts them; the
  initial-estimate cost evaluations are not among them)."""
  num_scales = len(base_pyramid)
  finest = 0 if use_pyramid_level_0 else 1
  estimate = base_T_frame_initial_1
  chosen_initial = base_T_frame_initial_1
  residual_count = torch.zeros((), dtype=torch.int32,
                               device=estimate.device)

  for scale in range(num_scales - 1, finest - 1, -1):
    scaling_factor = float(2 ** scale)
    threshold_factor = scaling_factor
    cam_s = depth_cam.scaled(1.0 / scaling_factor)
    base_l = base_pyramid[scale]
    tracked_l = tracked_pyramid[scale]

    def eval_cost(T):
      return frame_to_frame_cost(
          se3.inverse(T), base_l, tracked_l, cam_s, baseline_fx,
          threshold_factor, use_depth_residuals, use_descriptor_residuals,
          residual_type)

    if scale == num_scales - 1:
      if test_different_initial_estimates:
        c1, n1 = eval_cost(base_T_frame_initial_1)
        c2, n2 = eval_cost(base_T_frame_initial_2)
        estimate = torch.where(_pick(c1, n1, c2, n2), base_T_frame_initial_1,
                               base_T_frame_initial_2)
        chosen_initial = estimate
    elif not disable_reselection:
      c1, n1 = eval_cost(estimate)
      c2, n2 = eval_cost(chosen_initial)
      estimate = torch.where(_pick(c1, n1, c2, n2), estimate, chosen_initial)

    if scale == num_scales - 1:
      damping = 0.25
    elif scale == num_scales - 2:
      damping = 0.5
    else:
      damping = 1.0

    residual_count = torch.zeros((), dtype=torch.int32,
                                 device=estimate.device)
    if transfer_free:
      # The reference's while loop with the flag on the device: once a step
      # converged, the pose and the residual count hold, and the loop ends
      # at the first poll that sees the flag (utils/transfer.py).
      poll = DonePoll(estimate.device)
      done = torch.zeros((), dtype=torch.bool, device=estimate.device)
    launched = 0
    for _ in range(max_iterations_per_scale):
      launched += 1
      H, b, n = frame_to_frame_h_b(
          se3.inverse(estimate), base_l, tracked_l, cam_s, baseline_fx,
          threshold_factor, use_depth_residuals, use_descriptor_residuals,
          residual_type)
      x = solve_6x6(H, b)
      x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
      converged = is_scale_n_converged(x, scaling_factor,
                                       convergence_threshold)
      if not transfer_free:
        estimate = estimate @ se3.exp(-damping * x)
        residual_count = n
        # The one host read of the GN loop.
        if bool(converged):
          break
        continue
      estimate = torch.where(done, estimate,
                             estimate @ se3.exp(-damping * x))
      residual_count = torch.where(done, residual_count, n)
      done = done | converged
      if poll.done(done):
        break
    if gn_iterations is not None:
      gn_iterations.append(launched)

  return estimate, residual_count
