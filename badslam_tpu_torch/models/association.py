"""Surfel -> keyframe-pixel data association as dense masked math.

Port of ``badslam_tpu/models/association.py`` (``IsAssociatedWithPixel``
and ``SurfelProjectsToAssociatedPixel`` of surfel_projection_nvcc_only.cuh
in the original BAD SLAM). One vectorized predicate over all N surfel
slots; a surfel is associated with the pixel it projects to when all hold:

  1. it projects in front of the camera (z > 0) into the image;
  2. the hit pixel has valid depth;
  3. |calibrated_pixel_depth - surfel_local_z| <= tukey_param * sigma, with
     sigma the propagated depth stddev; the free-space-violation flag marks
     measurements far *behind* the surfel;
  4. the surfel normal faces the camera;
  5. surfel normal and measured pixel normal are within 40 degrees.

The depth calibration comes as a ``DepthCalibration`` (``a``, ``cfactor``,
``baseline_fx`` on the device, ``cell_size`` a host int), the state that
the reference passes as ``DepthParamsArrays``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import depth_model
from badslam_tpu_torch.ops.depth_proc import normals_3d
from badslam_tpu_torch.ops.interp import gather_image

# cos(40 deg): surfel vs measured normal compatibility (kernels.cuh:56-58).
COS_NORMAL_COMPATIBILITY_THRESHOLD = 0.76604
# Tukey parameter on the depth residual (cost_function.cuh:48).
DEPTH_TUKEY_PARAMETER = 10.0
# Empirical stereo-matching uncertainty factor (cost_function.cuh:52).
DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR = 0.1


class AssociationResult(NamedTuple):
  mask: torch.Tensor                  # (N,) bool, fully associated
  free_space_violation: torch.Tensor  # (N,) bool
  observed: torch.Tensor              # (N,) bool, passed the depth band
  local_pos: torch.Tensor             # (N, 3) surfel position in the frame
  local_normal: torch.Tensor          # (N, 3) surfel normal in the frame
  px: torch.Tensor                    # (N,) int64 hit pixel x
  py: torch.Tensor                    # (N,) int64 hit pixel y
  pxy: torch.Tensor                   # (N, 2) float corner-convention pixel
  calibrated_depth: torch.Tensor      # (N,) pixel calibrated depth
  inv_stddev: torch.Tensor            # (N,) propagated inverse depth stddev


def depth_residual_inv_stddev(nx: torch.Tensor, ny: torch.Tensor,
                              depth: torch.Tensor,
                              local_normal: torch.Tensor,
                              baseline_fx) -> torch.Tensor:
  """Propagated inverse depth stddev (cost_function.cuh:86-88)."""
  denom = (DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
           * torch.abs(local_normal[..., 0] * nx + local_normal[..., 1] * ny
                       + local_normal[..., 2])
           * depth * depth)
  return baseline_fx / torch.clamp(denom, min=1e-12)


def associate_surfels(
    pos: torch.Tensor,             # (N, 3) global surfel positions
    normal: torch.Tensor,          # (N, 3) global surfel normals
    surfel_valid: torch.Tensor,    # (N,) bool
    frame_T_global: torch.Tensor,  # (4, 4)
    kf_depth: torch.Tensor,        # (H, W) raw metric depth, 0 = invalid
    kf_normals: torch.Tensor,      # (H, W, 2)
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
    tukey_scaling: float = 1.0,
) -> AssociationResult:
  """Vectorized SurfelProjectsToAssociatedPixel over all surfel slots."""
  local_pos = se3.transform_points(frame_T_global, pos)
  z_ok = local_pos[..., 2] > 0.0

  unit_z = torch.eye(3, dtype=pos.dtype, device=pos.device)[2]
  pxy = depth_cam.project_corner(
      torch.where(z_ok[..., None], local_pos, unit_z))
  in_img = depth_cam.in_image(pxy) & z_ok
  # Lanes outside the image may hold inf (a tiny z); a float-to-int cast of
  # inf or NaN is undefined, so they read pixel (0, 0) and stay masked.
  pxy_int = torch.where(in_img[..., None], pxy, 0.0).to(torch.int64)
  px = pxy_int[..., 0].clamp(0, depth_cam.width - 1)
  py = pxy_int[..., 1].clamp(0, depth_cam.height - 1)

  measured = gather_image(kf_depth, py, px)
  depth_ok = measured > 0.0

  cfac = gather_image(dp.cfactor, py // dp.cell_size, px // dp.cell_size)
  calibrated = depth_model.calibrate_depth(dp.a, cfac, measured)

  local_normal = se3.rotate(frame_T_global, normal)

  nx = depth_cam.nx(px.to(pos.dtype))
  ny = depth_cam.ny(py.to(pos.dtype))
  inv_stddev = depth_residual_inv_stddev(nx, ny, calibrated, local_normal,
                                         dp.baseline_fx)
  threshold = (tukey_scaling * DEPTH_TUKEY_PARAMETER) / inv_stddev

  depth_diff = calibrated - local_pos[..., 2]
  base_ok = surfel_valid & in_img & depth_ok
  free_space_violation = base_ok & (depth_diff > threshold)
  within_band = base_ok & (torch.abs(depth_diff) <= threshold)

  # The normal faces the camera.
  facing = torch.sum(local_pos * local_normal, dim=-1) <= 0.0

  # Normal compatibility with the measurement.
  pixel_normal = normals_3d(gather_image(kf_normals, py, px))
  compat = (torch.sum(local_normal * pixel_normal, dim=-1)
            >= COS_NORMAL_COMPATIBILITY_THRESHOLD)

  return AssociationResult(
      mask=within_band & facing & compat,
      free_space_violation=free_space_violation,
      observed=within_band,
      local_pos=local_pos,
      local_normal=local_normal,
      px=px,
      py=py,
      pxy=pxy,
      calibrated_depth=calibrated,
      inv_stddev=inv_stddev,
  )
