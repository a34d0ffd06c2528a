"""Per-surfel geometry optimization: one Gauss-Newton step on (position along
the normal, descriptor 1, descriptor 2) for every active surfel at once.

Port of ``badslam_tpu/models/geometry_opt.py:35-198``
(kernel_opt_geometry.cu of the original BAD SLAM: coefficient accumulation
:119-231, a 3x3 upper-triangular H and 3-vector b per surfel summed over all
active keyframes, and the Cholesky solve + update with the descriptor clamp
to [-180, 180], :273-361).

The reference accumulates with a scan over the full keyframe stack. Here a
Python loop visits, in slot order, the slots that can contribute (valid and
at least covisible-active), so each surfel's sums add in the scan's order; a
skipped slot's mask is all-false there and changes no bit.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import COVISIBLE_ACTIVE, KeyframeStore
from badslam_tpu_torch.models.surfels import SurfelStore


class GeometryAccum(NamedTuple):
  """Per-surfel upper-triangular 3x3 H and 3-vector b (the kSurfelAccum0..8
  rows, kernel_opt_geometry.cu:200-208), each (N,)."""

  h00: torch.Tensor
  h01: torch.Tensor
  h02: torch.Tensor
  h11: torch.Tensor
  h12: torch.Tensor
  h22: torch.Tensor
  b0: torch.Tensor
  b1: torch.Tensor
  b2: torch.Tensor


def _zero_accum(n: int, device) -> GeometryAccum:
  z = torch.zeros((n,), dtype=torch.float32, device=device)
  return GeometryAccum(z, z, z, z, z, z, z, z, z)


def accumulate_one_keyframe(
    acc: GeometryAccum,
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor,
    global_T_frame: torch.Tensor,
    kf_active,  # bool, or a 0-d bool tensor
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
) -> GeometryAccum:
  """Adds one keyframe's contribution to every surfel's 3x3 system
  (AccumulateSurfelPositionAndDescriptorOptimizationCoeffsCUDAKernel)."""
  frame_T_global = se3.inverse(global_T_frame)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid & surfels.active,
      frame_T_global, kf_depth, kf_normals, depth_cam, dp)
  mask = assoc.mask & kf_active

  h00 = acc.h00
  b0 = acc.b0
  if use_depth_residuals:
    unproj = depth_cam.unproject_center(
        assoc.px.to(torch.float32), assoc.py.to(torch.float32),
        assoc.calibrated_depth)
    r = cost.raw_depth_residual(unproj, assoc.local_pos, assoc.local_normal,
                                assoc.inv_stddev)
    j = -assoc.inv_stddev  # d r / d (position offset along the normal)
    wm = torch.where(mask, cost.depth_weight(r), 0.0)
    h00 = h00 + wm * j * j
    b0 = b0 + wm * r * j

  if use_descriptor_residuals:
    d2c = DepthToColorTransform.between(depth_cam, color_cam)
    color_pxy, in_color = d2c.apply(assoc.pxy)
    dmask = mask & in_color
    t1_pxy, t2_pxy = cost.tangent_projections(
        surfels.pos, surfels.normal, surfels.radius_sq,
        frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
    r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
        kf_intensity, color_pxy, t1_pxy, t2_pxy, surfels.desc)

    # d r_i / d (position offset along the normal): the chain rule through
    # the projected position (kernel_opt_geometry.cu:188-192).
    rn = assoc.local_normal
    ls = assoc.local_pos
    term1 = -color_cam.fx * (rn[..., 0] * ls[..., 2] - rn[..., 2] * ls[..., 0])
    term2 = -color_cam.fy * (rn[..., 1] * ls[..., 2] - rn[..., 2] * ls[..., 1])
    term3 = 1.0 / torch.clamp(ls[..., 2] * ls[..., 2], min=1e-12)
    jp1 = -(gx1 * term1 + gy1 * term2) * term3
    jp2 = -(gx2 * term1 + gy2 * term2) * term3
    jd = -1.0  # d r_i / d descriptor_i

    w1 = torch.where(dmask, cost.descriptor_weight(r1), 0.0)
    w2 = torch.where(dmask, cost.descriptor_weight(r2), 0.0)

    h00 = h00 + w1 * jp1 * jp1 + w2 * jp2 * jp2
    b0 = b0 + w1 * r1 * jp1 + w2 * r2 * jp2
    acc = acc._replace(
        h01=acc.h01 + w1 * jp1 * jd,
        h02=acc.h02 + w2 * jp2 * jd,
        h11=acc.h11 + w1 * jd * jd,
        h22=acc.h22 + w2 * jd * jd,
        b1=acc.b1 + w1 * r1 * jd,
        b2=acc.b2 + w2 * r2 * jd,
    )

  return acc._replace(h00=h00, b0=b0)


def solve_and_update(surfels: SurfelStore, acc: GeometryAccum) -> SurfelStore:
  """Batched 3x3 Cholesky solve + surfel update
  (UpdateSurfelPositionAndDescriptorCUDAKernel,
  kernel_opt_geometry.cu:273-361)."""
  eps = 1e-6
  h00 = acc.h00 + eps
  h11 = acc.h11 + eps
  h22 = acc.h22 + eps

  # Cholesky of the 3x3 (guarded square roots; zero rows yield x = 0).
  l00 = torch.sqrt(torch.clamp(h00, min=1e-30))
  l01 = acc.h01 / l00
  l11 = torch.sqrt(torch.clamp(h11 - l01 * l01, min=1e-30))
  l02 = acc.h02 / l00
  l12 = (acc.h12 - l02 * l01) / l11
  l22 = torch.sqrt(torch.clamp(h22 - l02 * l02 - l12 * l12, min=1e-30))

  y0 = acc.b0 / l00
  y1 = (acc.b1 - l01 * y0) / l11
  y2 = (acc.b2 - l02 * y0 - l12 * y1) / l22

  x2 = y2 / l22
  x1 = (y1 - l12 * x2) / l11
  x0 = (y0 - l02 * x2 - l01 * x1) / l00

  upd = (surfels.valid & surfels.active
         & torch.isfinite(x0) & torch.isfinite(x1) & torch.isfinite(x2))

  new_pos = surfels.pos - torch.where(upd, x0, 0.0)[:, None] * surfels.normal
  d1 = torch.clamp(surfels.desc[:, 0] - torch.where(upd, x1, 0.0),
                   -180.0, 180.0)
  d2 = torch.clamp(surfels.desc[:, 1] - torch.where(upd, x2, 0.0),
                   -180.0, 180.0)
  return surfels._replace(pos=new_pos, desc=torch.stack([d1, d2], dim=-1))


def optimize_geometry_iteration(
    surfels: SurfelStore,
    kf: KeyframeStore,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    slots: Optional[Sequence[int]] = None,
) -> SurfelStore:
  """One geometry GN step over all active surfels, accumulating over the
  valid keyframes that are active or covisible-active, in slot order
  (OptimizeGeometryIterationCUDA host loop, kernel_opt_geometry.cc).

  ``slots`` are those keyframes' indices as host ints, for a caller that
  has them; otherwise the masks are read back once."""
  if slots is None:
    slots = torch.nonzero(
        kf.valid & (kf.activation >= COVISIBLE_ACTIVE)).flatten().tolist()
  acc = _zero_accum(surfels.capacity, surfels.device)
  for k in slots:
    acc = accumulate_one_keyframe(
        acc, surfels, kf.depth[k], kf.normals[k], kf.intensity[k],
        kf.global_T_frame[k], True, depth_cam, color_cam, dp,
        use_depth_residuals, use_descriptor_residuals)
  return solve_and_update(surfels, acc)
