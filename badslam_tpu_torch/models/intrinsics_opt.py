"""Intrinsics self-calibration: one Gauss-Newton step on the depth intrinsics
(fx, fy, cx, cy through their inverse parameters), the global
depth-deformation factor a, the per-cell cfactor field, and the color
intrinsics (fx, fy, cx, cy).

Port of ``badslam_tpu/models/intrinsics_opt.py``
(kernel_opt_intrinsics.{cc,cu} of the original BAD SLAM):
  * residual structure and Jacobians, kernel_opt_intrinsics.cu:47-200: the
    depth residual wrt [fx_inv, fy_inv, cx_inv, cy_inv, a] and its cell's
    cfactor; the descriptor residuals wrt [fx, fy, cx, cy] through the
    approximation J = [gx*nx, gy*ny, gx, gy];
  * the Schur complement over the cfactor block,
    (A - B D^-1 B^T) x1 = b1 - B D^-1 b2, kernel_opt_intrinsics.cu:270-345;
  * a weak prior of weight 10 on a, kernel_opt_intrinsics.cc:146-155;
  * the camera update through the inverse parameters with the +0.5 shift of
    the pixel-corner convention, kernel_opt_intrinsics.cc:183-196;
  * the cfactor back-substitution, which resets unobserved cells to 0,
    kernel_opt_intrinsics.cu:375-425.

The accumulation loops in Python over the valid keyframe slots, in slot
order; the per-cell blocks B, D, b2 and the observation counts are sums by
cell in a fixed order (``ops/segment.py``), not atomic scatters. The 5x5 and
4x4 solves run in float32 with Jacobi equilibration and two refinement
steps, where the original solves in double: the fx_inv rows and the a row
differ in scale by many orders of magnitude.

The step returns new tensors and changes none of its inputs; the caller
(``DirectBA``) writes them into the shared calibration.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import KeyframeStore
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops.interp import gather_image
from badslam_tpu_torch.ops.segment import plan_segments

A_PRIOR_WEIGHT = 10.0  # kAPriorWeight (kernel_opt_intrinsics.cc:146)
A_ROWS = 5             # fx_inv, fy_inv, cx_inv, cy_inv, a


def _equilibrated_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """Solve A x = b in float32 with Jacobi equilibration and two steps of
  iterative refinement. ``solve_ex`` does not check the factorization, so a
  singular A gives a non-finite x, which the caller turns into a zero step,
  instead of raising."""
  d = torch.sqrt(torch.clamp(torch.diagonal(A), min=1e-12))
  s = 1.0 / d
  As = A * s[:, None] * s[None, :]
  bs = b * s
  y = torch.linalg.solve_ex(As, bs)[0]
  for _ in range(2):
    r = bs - As @ y
    y = y + torch.linalg.solve_ex(As, r)[0]
  return y * s


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
  return torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))


def depth_intrinsics_jacobian(
    assoc: association.AssociationResult,
    surfel_normal: torch.Tensor,
    frame_T_global: torch.Tensor,
    kf_depth: torch.Tensor,
    depth_cam: PinholeCamera,
    dp: DepthCalibration,
):
  """The depth residual's Jacobian wrt [fx_inv, fy_inv, cx_inv, cy_inv, a]
  (N, 5) and wrt the hit pixel's cfactor cell (N,), the lanes where the
  calibrated inverse depth is usable (N,) bool, and each lane's flattened
  cell id (N,) (kernel_opt_intrinsics.cu:47-200). The alternated step and
  the joint PCG step share these rows."""
  px_f = assoc.px.to(torch.float32)
  py_f = assoc.py.to(torch.float32)
  nx = depth_cam.nx(px_f)
  ny = depth_cam.ny(py_f)
  wc = dp.cfactor.shape[1]
  cell_x = assoc.px // dp.cell_size
  cell_y = assoc.py // dp.cell_size
  cell_id = cell_y * wc + cell_x

  raw_depth = gather_image(kf_depth, assoc.py, assoc.px)
  raw_inv = 1.0 / torch.clamp(raw_depth, min=1e-12)
  cfac = gather_image(dp.cfactor, cell_y, cell_x)
  exp_inv = torch.exp(-dp.a * raw_inv)
  corrected_inv = cfac * exp_inv + raw_inv
  usable = torch.abs(corrected_inv) > 1e-4

  ln = assoc.local_normal
  dot = ln[:, 0] * nx + ln[:, 1] * ny + ln[:, 2]
  jac_base = assoc.inv_stddev * dot * exp_inv / torch.clamp(
      corrected_inv * corrected_inv, min=1e-20)

  R = frame_T_global[0:3, 0:3]
  j_cx = assoc.inv_stddev * assoc.calibrated_depth * (surfel_normal @ R[0, :])
  j_cy = assoc.inv_stddev * assoc.calibrated_depth * (surfel_normal @ R[1, :])
  j_fx = px_f * j_cx
  j_fy = py_f * j_cy
  j_a = cfac * raw_inv * jac_base
  J = torch.stack([j_fx, j_fy, j_cx, j_cy, j_a], dim=-1)
  return J, -jac_base, usable, cell_id


def _accumulate(
    surfels: SurfelStore,
    kf: KeyframeStore,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    optimize_depth: bool,
    optimize_color: bool,
    slots: Optional[Sequence[int]] = None,
    transfer_free: bool = False,
):
  """The depth Schur blocks (A, b1, B, D, b2, obs) and the color H and b,
  summed over the valid keyframes in slot order. ``slots`` are their indices
  as host ints, for a caller that has them; otherwise the mask is read back
  once."""
  if slots is None:
    slots = torch.nonzero(kf.valid).flatten().tolist()
  dev = surfels.device
  hc, wc = dp.cfactor.shape
  num_cells = hc * wc
  f32 = dict(dtype=torch.float32, device=dev)
  A = torch.zeros((A_ROWS, A_ROWS), **f32)
  b1 = torch.zeros((A_ROWS,), **f32)
  B = torch.zeros((num_cells, A_ROWS), **f32)
  D = torch.zeros((num_cells,), **f32)
  b2 = torch.zeros((num_cells,), **f32)
  obs = torch.zeros((num_cells,), dtype=torch.int32, device=dev)
  cH = torch.zeros((4, 4), **f32)
  cb = torch.zeros((4,), **f32)

  for k in slots:
    depth_img = kf.depth[k]
    frame_T_global = se3.inverse(kf.global_T_frame[k])
    assoc = association.associate_surfels(
        surfels.pos, surfels.normal, surfels.valid, frame_T_global,
        depth_img, kf.normals[k], depth_cam, dp)
    m = assoc.mask
    px_f = assoc.px.to(torch.float32)
    py_f = assoc.py.to(torch.float32)

    if optimize_depth:
      Jg, j_c, usable, cell_id = depth_intrinsics_jacobian(
          assoc, surfels.normal, frame_T_global, depth_img, depth_cam, dp)
      dm = m & usable
      unproj = depth_cam.unproject_center(px_f, py_f, assoc.calibrated_depth)
      r = cost.raw_depth_residual(unproj, assoc.local_pos,
                                  assoc.local_normal, assoc.inv_stddev)
      w = cost.depth_weight(r)

      Jg = torch.where(dm[:, None], Jg, 0.0)
      rr = torch.where(dm, r, 0.0)
      ww = torch.where(dm, w, 0.0)
      jc = torch.where(dm, j_c, 0.0)

      Jw = Jg * ww[:, None]
      A = A + Jw.T @ Jg
      b1 = b1 + Jw.T @ rr
      # Lanes outside the mask go to one extra segment that is cut off.
      plan = plan_segments(torch.where(dm, cell_id, num_cells), num_cells,
                           transfer_free)
      B = B + plan.sum(Jw * jc[:, None])
      D = D + plan.sum(ww * jc * jc)
      b2 = b2 + plan.sum(ww * jc * rr)
      obs = obs + plan.counts.to(torch.int32)

    if optimize_color:
      nx = depth_cam.nx(px_f)
      ny = depth_cam.ny(py_f)
      d2c = DepthToColorTransform.between(depth_cam, color_cam)
      color_pxy, in_color = d2c.apply(assoc.pxy)
      cm = m & in_color
      t1_pxy, t2_pxy = cost.tangent_projections(
          surfels.pos, surfels.normal, surfels.radius_sq,
          frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
      r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
          kf.intensity[k], color_pxy, t1_pxy, t2_pxy, surfels.desc)
      for gx, gy, rr_ in ((gx1, gy1, r1), (gx2, gy2, r2)):
        J = torch.stack([gx * nx, gy * ny, gx, gy], dim=-1)
        Hd, bd = cost.accumulate_h_b(J, rr_, cost.descriptor_weight(rr_), cm)
        cH = cH + Hd
        cb = cb + bd

  return A, b1, B, D, b2, obs, cH, cb


def inverse_parameter_update(depth_intr: torch.Tensor, x: torch.Tensor,
                             sign: float) -> torch.Tensor:
  """The depth intrinsics after moving their inverse parameters (fx_inv,
  fy_inv, cx_inv, cy_inv; center convention, hence the 0.5 shift) by
  ``sign * x[:4]`` (kernel_opt_intrinsics.cc:183-196)."""
  fx_inv = 1.0 / depth_intr[0]
  fy_inv = 1.0 / depth_intr[1]
  cx_inv = -(depth_intr[2] - 0.5) * fx_inv
  cy_inv = -(depth_intr[3] - 0.5) * fy_inv
  new_fx = 1.0 / (fx_inv + sign * x[0])
  new_fy = 1.0 / (fy_inv + sign * x[1])
  new_cx = -(new_fx * (cx_inv + sign * x[2])) + 0.5
  new_cy = -(new_fy * (cy_inv + sign * x[3])) + 0.5
  return torch.stack([new_fx, new_fy, new_cx, new_cy])


def optimize_intrinsics(
    surfels: SurfelStore,
    kf: KeyframeStore,
    dp: DepthCalibration,
    color_intr: torch.Tensor,
    color_size: Tuple[int, int],
    optimize_depth: bool,
    optimize_color: bool,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    slots: Optional[Sequence[int]] = None,
    transfer_free: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """One self-calibration step (OptimizeIntrinsicsCUDA,
  kernel_opt_intrinsics.cc:39-281). Returns new (depth_intr, color_intr, a,
  cfactor); an unknown that is not optimized comes back as the tensor that
  went in. ``transfer_free``: sums by cell without a host read
  (``ops/segment.py``)."""
  optimize_depth = optimize_depth and use_depth_residuals
  optimize_color = optimize_color and use_descriptor_residuals
  depth_intr, a, cfactor = dp.depth_intr, dp.a, dp.cfactor
  if not (optimize_depth or optimize_color):
    return depth_intr, color_intr, a, cfactor
  cw, ch = color_size
  color_cam = PinholeCamera(cw, ch, color_intr[0], color_intr[1],
                            color_intr[2], color_intr[3])
  A, b1, B, D, b2, obs, cH, cb = _accumulate(
      surfels, kf, dp.camera(), color_cam, dp, optimize_depth,
      optimize_color, slots, transfer_free)

  new_depth_intr, new_a, new_cfactor = depth_intr, a, cfactor
  if optimize_depth:
    # Schur complement over the cfactor block; unconstrained cells (tiny D)
    # are skipped as by the original's 1e12 test on the inverse.
    D_inv = 1.0 / D
    cell_ok = D_inv < 1e12
    D_inv = torch.where(cell_ok, D_inv, 0.0)
    BD = B * D_inv[:, None]
    A_s = A - BD.T @ B
    b1_s = b1 - B.T @ (D_inv * b2)
    # The weak prior on a: w^2 on the diagonal and w^2 * a on the right-hand
    # side, which with the x -= update pulls a toward zero
    # (kernel_opt_intrinsics.cc:146-155).
    prior = A_PRIOR_WEIGHT * A_PRIOR_WEIGHT
    # One-hot on a, made on the device.
    a_row = (torch.arange(A_ROWS, device=A.device) == 4).to(torch.float32)
    A_s = A_s + prior * torch.outer(a_row, a_row)
    b1_s = b1_s + prior * a * a_row
    x1 = _finite_or_zero(_equilibrated_solve(A_s, b1_s))

    new_depth_intr = inverse_parameter_update(depth_intr, x1, -1.0)
    new_a = a - x1[4]
    # Back-substitute the per-cell update; reset unobserved cells to 0.
    x2 = torch.where(cell_ok, D_inv * b2 - BD @ x1, 0.0)
    cf_flat = torch.where(obs > 0, cfactor.reshape(-1) - x2, 0.0)
    new_cfactor = cf_flat.reshape(cfactor.shape)

  new_color_intr = color_intr
  if optimize_color:
    new_color_intr = color_intr - _finite_or_zero(_equilibrated_solve(cH, cb))

  return new_depth_intr, new_color_intr, new_a, new_cfactor
