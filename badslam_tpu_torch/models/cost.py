"""Residuals and analytic Jacobians of the direct cost: the part odometry
reaches.

Port of ``badslam_tpu/models/cost.py:37-254`` (cost_function.cuh and
kernel_opt_pose.cu:45-222 of the original BAD SLAM). All functions are dense
over (N,) surfels or pixels; the caller masks invalid lanes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.ops import interp, robust

DEPTH_RESIDUAL_WEIGHT = 1.0
DEPTH_TUKEY_PARAMETER = 10.0
DESCRIPTOR_RESIDUAL_WEIGHT = 1e-2
DESCRIPTOR_HUBER_PARAMETER = 10.0
TANGENT_SCALING = 2.0  # cost_function.cuh:126


def raw_depth_residual(unproj: torch.Tensor, local_pos: torch.Tensor,
                       local_normal: torch.Tensor,
                       inv_stddev: torch.Tensor) -> torch.Tensor:
  """r = sigma^-1 * n . (unproj - p)."""
  return inv_stddev * torch.sum(local_normal * (unproj - local_pos), dim=-1)


def depth_residual_pose_jacobian(unproj: torch.Tensor,
                                 local_normal: torch.Tensor,
                                 inv_stddev: torch.Tensor) -> torch.Tensor:
  """(N, 6) Jacobian wrt the se3 tangent [upsilon, omega] of the update
  T * exp(hat(x)) (kernel_opt_pose.cu:88-93)."""
  n = local_normal
  u = unproj
  jt = inv_stddev[..., None] * n
  jr = inv_stddev[..., None] * torch.stack(
      [
          -n[..., 1] * u[..., 2] + n[..., 2] * u[..., 1],
          n[..., 0] * u[..., 2] - n[..., 2] * u[..., 0],
          -n[..., 0] * u[..., 1] + n[..., 1] * u[..., 0],
      ],
      dim=-1,
  )
  return torch.cat([jt, jr], dim=-1)


def depth_weight(raw_residual: torch.Tensor,
                 scaling: float = 1.0) -> torch.Tensor:
  return DEPTH_RESIDUAL_WEIGHT * robust.tukey_weight(
      raw_residual, scaling * DEPTH_TUKEY_PARAMETER)


def weighted_depth_cost(raw_residual: torch.Tensor,
                        scaling: float = 1.0) -> torch.Tensor:
  return DEPTH_RESIDUAL_WEIGHT * robust.tukey_residual(
      raw_residual, scaling * DEPTH_TUKEY_PARAMETER)


def tangent_projections(
    global_pos: torch.Tensor,        # (N, 3)
    global_normal: torch.Tensor,     # (N, 3)
    radius_sq: torch.Tensor,         # (N,)
    frame_T_global_R: torch.Tensor,  # (3, 3)
    frame_T_global_t: torch.Tensor,  # (3,)
    color_cam: PinholeCamera,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Projections of two surfel-border tangent points
  (cost_function.cuh:115-136): t1 = normal x (|nx| > 0.9 ? ey : ex), scaled
  to 2 * radius; t2 = normal x t1."""
  n = global_normal
  ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
  ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
  axis = torch.where((torch.abs(n[..., 0]) > 0.9)[..., None], ey, ex)
  t1 = torch.linalg.cross(n, axis)
  t1 = t1 * (TANGENT_SCALING * torch.sqrt(
      radius_sq / torch.clamp(torch.sum(t1 * t1, dim=-1), min=1e-12))
             )[..., None]
  t2 = torch.linalg.cross(n, t1)
  t2 = t2 * (TANGENT_SCALING * torch.sqrt(
      radius_sq / torch.clamp(torch.sum(t2 * t2, dim=-1), min=1e-12))
             )[..., None]

  def proj(p_global):
    return color_cam.project_corner(
        p_global @ frame_T_global_R.T + frame_T_global_t)

  return proj(global_pos + t1), proj(global_pos + t2)


def raw_descriptor_residual(
    intensity: torch.Tensor,  # (H, W) in [0, 1]
    pxy: torch.Tensor,        # (N, 2) center projection (corner convention)
    t1_pxy: torch.Tensor,     # (N, 2)
    t2_pxy: torch.Tensor,     # (N, 2)
    desc: torch.Tensor,       # (N, 2) stored surfel descriptor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """r_i = 180 * (I(t_i) - I(c)) - d_i (cost_function.cuh:140-156)."""
  c = interp.sample_bilinear(intensity, pxy[..., 0], pxy[..., 1])
  i1 = interp.sample_bilinear(intensity, t1_pxy[..., 0], t1_pxy[..., 1])
  i2 = interp.sample_bilinear(intensity, t2_pxy[..., 0], t2_pxy[..., 1])
  return (180.0 * (i1 - c) - desc[..., 0], 180.0 * (i2 - c) - desc[..., 1])


def descriptor_grads(
    intensity: torch.Tensor, pxy: torch.Tensor, t1_pxy: torch.Tensor,
    t2_pxy: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """d(180 * (I(t_i) - I(c))) / d(projected position), with all three sample
  points moving together (cost_function.cuh:191-254): (grad_x_1, grad_y_1,
  grad_x_2, grad_y_2), each (N,)."""
  c_dx, c_dy = interp.sample_bilinear_grad(intensity, pxy[..., 0],
                                           pxy[..., 1])
  t1_dx, t1_dy = interp.sample_bilinear_grad(intensity, t1_pxy[..., 0],
                                             t1_pxy[..., 1])
  t2_dx, t2_dy = interp.sample_bilinear_grad(intensity, t2_pxy[..., 0],
                                             t2_pxy[..., 1])
  return (180.0 * (t1_dx - c_dx), 180.0 * (t1_dy - c_dy),
          180.0 * (t2_dx - c_dx), 180.0 * (t2_dy - c_dy))


def projected_position_pose_jacobian(grad_x_fx: torch.Tensor,
                                     grad_y_fy: torch.Tensor,
                                     local_pos: torch.Tensor) -> torch.Tensor:
  """(N, 6) chain rule of an intensity-like residual through the projection,
  wrt [upsilon, omega] (kernel_opt_pose.cu:122-141)."""
  ls = local_pos
  inv_z = 1.0 / ls[..., 2]
  z_sq = ls[..., 2] * ls[..., 2]
  inv_z_sq = inv_z * inv_z
  xy = ls[..., 0] * ls[..., 1]
  j0 = -grad_x_fx * inv_z
  j1 = -grad_y_fy * inv_z
  j2 = (ls[..., 0] * grad_x_fx + ls[..., 1] * grad_y_fy) * inv_z_sq
  j3 = ((ls[..., 1] * ls[..., 1] + z_sq) * grad_y_fy
        + xy * grad_x_fx) * inv_z_sq
  j4 = -((ls[..., 0] * ls[..., 0] + z_sq) * grad_x_fx
         + xy * grad_y_fy) * inv_z_sq
  j5 = -(ls[..., 0] * grad_y_fy - ls[..., 1] * grad_x_fx) * inv_z
  return torch.stack([j0, j1, j2, j3, j4, j5], dim=-1)


def descriptor_terms_fused(
    intensity: torch.Tensor,
    pxy: torch.Tensor,
    t1_pxy: torch.Tensor,
    t2_pxy: torch.Tensor,
    desc: torch.Tensor,
) -> Tuple[torch.Tensor, ...]:
  """(r1, r2, grad_x_1, grad_y_1, grad_x_2, grad_y_2): the two descriptor
  residuals r_i = 180*(I(t_i) - I(c)) - d_i and their gradients wrt the
  projected position (all three sample points moving together). Value and
  gradient share each point's 4 taps."""
  c, c_dx, c_dy = interp.sample_bilinear_with_grad(
      intensity, pxy[..., 0], pxy[..., 1])
  i1, t1_dx, t1_dy = interp.sample_bilinear_with_grad(
      intensity, t1_pxy[..., 0], t1_pxy[..., 1])
  i2, t2_dx, t2_dy = interp.sample_bilinear_with_grad(
      intensity, t2_pxy[..., 0], t2_pxy[..., 1])
  r1 = 180.0 * (i1 - c) - desc[..., 0]
  r2 = 180.0 * (i2 - c) - desc[..., 1]
  return (r1, r2,
          180.0 * (t1_dx - c_dx), 180.0 * (t1_dy - c_dy),
          180.0 * (t2_dx - c_dx), 180.0 * (t2_dy - c_dy))


def descriptor_weight(raw_residual: torch.Tensor,
                      scaling: float = 1.0) -> torch.Tensor:
  return scaling * DESCRIPTOR_RESIDUAL_WEIGHT * robust.huber_weight(
      raw_residual, DESCRIPTOR_HUBER_PARAMETER)


def weighted_descriptor_cost(raw_residual: torch.Tensor,
                             scaling: float = 1.0) -> torch.Tensor:
  return scaling * DESCRIPTOR_RESIDUAL_WEIGHT * robust.huber_residual(
      raw_residual, DESCRIPTOR_HUBER_PARAMETER)


def raw_color_residual(image: torch.Tensor, pxy: torch.Tensor,
                       reference_value: torch.Tensor) -> torch.Tensor:
  """Frame-to-frame color residual (gradient-magnitude tracking mode)."""
  return 255.0 * interp.sample_bilinear(image, pxy[..., 0],
                                        pxy[..., 1]) - reference_value


def color_grads(image: torch.Tensor, pxy: torch.Tensor):
  dx, dy = interp.sample_bilinear_grad(image, pxy[..., 0], pxy[..., 1])
  return 255.0 * dx, 255.0 * dy


def accumulate_h_b(
    J: torch.Tensor,     # (N, D) Jacobians
    r: torch.Tensor,     # (N,) raw residuals
    w: torch.Tensor,     # (N,) robust weights
    mask: torch.Tensor,  # (N,) bool
) -> Tuple[torch.Tensor, torch.Tensor]:
  """H = J^T W J, b = J^T W r over masked lanes, one product each, in full
  float32 (the package pins TF32 off). Masked lanes may carry inf/NaN, and
  0 * inf = NaN, so J and r are hard-zeroed, not just weight-zeroed."""
  wm = torch.where(mask, w, 0.0)
  Jm = torch.where(mask[:, None], J, 0.0)
  rm = torch.where(mask, r, 0.0)
  Jw = Jm * wm[:, None]
  return Jw.T @ Jm, Jw.T @ rm
