"""Depth-image preprocessing: bilateral filter + cutoff, normals, radii.

Port of ``badslam_tpu/ops/depth_proc.py`` (cuda_depth_processing.cu:42,
:134, :331 of the original BAD SLAM). Depth is float32 metres with <= 0
meaning invalid. Each stencil is a sum of statically shifted views of a
zero-padded image; pixels outside the image read as 0, i.e. invalid.

This chain is the plain version of the hand-written kernel
``csrc/fused_preprocess.cu`` (see ``ops/fused_preprocess.py``), and the
kernel follows its operation order.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.ops import depth_model


def _pad(img: torch.Tensor, r: int) -> torch.Tensor:
  return F.pad(img[None, None], (r, r, r, r))[0, 0]


def bilateral_filter_and_cutoff(
    depth: torch.Tensor,
    sigma_xy: float = 1.5,
    sigma_inv_depth: float = 0.005,
    radius_factor: float = 2.0,
    max_depth: float = 3.0,
) -> torch.Tensor:
  """Joint xy / inverse-depth bilateral filter with max-depth cutoff
  (BilateralFilteringAndDepthCutoffCUDAKernel). Filters inverse depth and
  returns 1 / the weighted mean; pixels with depth <= 0 or > max_depth, or
  with no valid tap, become 0."""
  h, w = depth.shape
  radius = int(radius_factor * sigma_xy + 0.5)
  radius_sq = radius * radius
  denom_xy = 2.0 * sigma_xy * sigma_xy
  # Multiplied by its reciprocal, a float32 constant, so that the CPU and
  # the GPU (where PyTorch turns a division by a host scalar into this
  # product anyway) and the CUDA kernel all round the same way.
  inv_denom_value = 1.0 / (2.0 * sigma_inv_depth * sigma_inv_depth)

  center_valid = (depth > 0.0) & (depth <= max_depth)
  inv_center = 1.0 / torch.where(depth > 0.0, depth, 1.0)

  padded = _pad(depth, radius)
  wsum = torch.zeros_like(depth)
  vsum = torch.zeros_like(depth)
  for dy in range(-radius, radius + 1):
    for dx in range(-radius, radius + 1):
      grid_sq = dx * dx + dy * dy
      if grid_sq > radius_sq:
        continue
      sample = padded[radius + dy:radius + dy + h,
                      radius + dx:radius + dx + w]
      sample_valid = sample > 0.0
      inv_sample = 1.0 / torch.where(sample_valid, sample, 1.0)
      diff = inv_center - inv_sample
      wgt = torch.where(
          sample_valid,
          torch.exp(-grid_sq / denom_xy - (diff * diff) * inv_denom_value),
          0.0)
      wsum = wsum + wgt
      vsum = vsum + wgt * inv_sample

  ok = center_valid & (wsum > 0.0)
  out = wsum / torch.where(vsum > 0.0, vsum, 1.0)
  return torch.where(ok, out, 0.0)


def _pixel_grids(h: int, w: int, like: torch.Tensor):
  xs = torch.arange(w, dtype=like.dtype, device=like.device)[None, :]
  ys = torch.arange(h, dtype=like.dtype, device=like.device)[:, None]
  return xs, ys


def _unproj(camera: PinholeCamera, px, py, d):
  """(x, y, z) component planes of the center-convention unprojection."""
  return (d * (camera.fx_inv * px + camera.cx_inv),
          d * (camera.fy_inv * py + camera.cy_inv),
          d)


def _dist_sq(p, q):
  dx, dy, dz = (a - b for a, b in zip(p, q))
  return dx * dx + dy * dy + dz * dz


def compute_normals_planar(
    depth: torch.Tensor,
    camera: PinholeCamera,
    a,
    cfactor: torch.Tensor,
    cell: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Occlusion-aware central-difference normals of the *calibrated* depth
  (ComputeNormalsCUDAKernel), as (x, y, z) component planes.

  Border pixels and pixels with an invalid 4-neighbour are invalidated.
  Returns (out_depth, normal_x, normal_y)."""
  h, w = depth.shape
  calib = depth_model.calibrate_depth_image(a, cfactor, depth, cell)

  valid = depth > 0.0
  padded_valid = _pad(valid.to(depth.dtype), 1) > 0.5
  padded_calib = _pad(calib, 1)

  def shift(arr, dy, dx):
    return arr[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

  all_valid = (valid & shift(padded_valid, 0, -1) & shift(padded_valid, 0, 1)
               & shift(padded_valid, -1, 0) & shift(padded_valid, 1, 0))
  ys_b = torch.arange(h, device=depth.device)[:, None]
  xs_b = torch.arange(w, device=depth.device)[None, :]
  border = (ys_b == 0) | (ys_b == h - 1) | (xs_b == 0) | (xs_b == w - 1)
  all_valid = all_valid & ~border

  xs, ys = _pixel_grids(h, w, depth)
  p_c = _unproj(camera, xs, ys, calib)
  p_l = _unproj(camera, xs - 1, ys, shift(padded_calib, 0, -1))
  p_r = _unproj(camera, xs + 1, ys, shift(padded_calib, 0, 1))
  p_t = _unproj(camera, xs, ys - 1, shift(padded_calib, -1, 0))
  p_b = _unproj(camera, xs, ys + 1, shift(padded_calib, 1, 0))

  ratio_thr_sq = 4.0  # kRatioThreshold = 2

  def pick_difference(p_neg, p_pos):
    """Full central difference when both sides are at comparable distance,
    else the one-sided difference toward the nearer side."""
    neg_sq = _dist_sq(p_neg, p_c)
    pos_sq = _dist_sq(p_pos, p_c)
    ratio = neg_sq / torch.clamp(pos_sq, min=1e-30)
    use_central = (ratio < ratio_thr_sq) & (ratio > 1.0 / ratio_thr_sq)
    nearer_neg = neg_sq < pos_sq
    return tuple(
        torch.where(use_central, pos - neg,
                    torch.where(nearer_neg, c - neg, pos - c))
        for neg, pos, c in zip(p_neg, p_pos, p_c))

  ax, ay, az = pick_difference(p_l, p_r)   # left to right
  bx, by, bz = pick_difference(p_b, p_t)   # bottom to top

  nx = ay * bz - az * by
  ny = az * bx - ax * bz
  nz = ax * by - ay * bx
  length = torch.sqrt(nx * nx + ny * ny + nz * nz)
  degenerate = ~(length > 1e-6)
  sign = torch.where(torch.as_tensor(camera.fy_inv) < 0, -1.0, 1.0)
  inv_len = sign / torch.where(degenerate, 1.0, length)
  keep = all_valid & ~degenerate
  out_x = torch.where(keep, nx * inv_len, 0.0)
  out_y = torch.where(keep, ny * inv_len, 0.0)
  out_depth = torch.where(all_valid, depth, 0.0)
  return out_depth, out_x, out_y


def compute_normals(
    depth: torch.Tensor,
    camera: PinholeCamera,
    a,
    cfactor: torch.Tensor,
    cell: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Normals as (out_depth, normals (H, W, 2)): the image-space x/y of the
  unit normal; z is -sqrt(max(0, 1 - x^2 - y^2)) (``normal_z``)."""
  out_depth, out_x, out_y = compute_normals_planar(depth, camera, a, cfactor,
                                                   cell)
  return out_depth, torch.stack([out_x, out_y], dim=-1)


def normal_z(nxy: torch.Tensor) -> torch.Tensor:
  """z of the stored x/y normal, pointing toward the camera."""
  zsq = 1.0 - nxy[..., 0] ** 2 - nxy[..., 1] ** 2
  return -torch.sqrt(torch.clamp(zsq, min=0.0))


def normals_3d(nxy: torch.Tensor) -> torch.Tensor:
  return torch.cat([nxy, normal_z(nxy)[..., None]], dim=-1)


def compute_radii_and_remove_isolated(
    depth: torch.Tensor, camera: PinholeCamera
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Squared point radius = min squared 3-D distance to the valid
  4-neighbours; pixels with fewer than 4 valid neighbours are invalidated
  (ComputePointRadiiAndRemoveIsolatedPixelsCUDAKernel). Uses the
  *uncalibrated* depth, as the reference does.

  Returns (radius_sq, out_depth)."""
  h, w = depth.shape
  valid = depth > 0.0
  padded = _pad(depth, 1)
  padded_valid = _pad(valid.to(depth.dtype), 1) > 0.5

  def shift(arr, dy, dx):
    return arr[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

  xs, ys = _pixel_grids(h, w, depth)
  p_c = _unproj(camera, xs, ys, depth)

  min_sq = torch.full((h, w), float("inf"), dtype=depth.dtype,
                      device=depth.device)
  count = torch.zeros((h, w), dtype=torch.int32, device=depth.device)
  for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
    v_n = shift(padded_valid, dy, dx)
    p_n = _unproj(camera, xs + dx, ys + dy, shift(padded, dy, dx))
    dist_sq = _dist_sq(p_n, p_c)
    min_sq = torch.where(v_n & (dist_sq < min_sq), dist_sq, min_sq)
    count = count + v_n.to(torch.int32)

  ok = valid & (count >= 4)
  return torch.where(ok, min_sq, 0.0), torch.where(ok, depth, 0.0)


def compute_min_max_depth(depth: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(min, max) over valid pixels (ComputeMinMaxDepthCUDAKernel,
  cuda_depth_processing.cu:391-425), as 0-d tensors."""
  valid = depth > 0.0
  min_d = torch.where(valid, depth, float("inf")).min()
  max_d = torch.where(valid, depth, 0.0).max()
  return min_d, max_d
