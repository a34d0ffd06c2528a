"""The plain preprocess chain, frozen: what ``fused_depth_preprocess``
(``badslam_tpu_torch/csrc/fused_preprocess.cu``) computes, written as plain
PyTorch operations.

A copy of ``bilateral_filter_and_cutoff``, ``compute_normals`` and
``compute_radii_and_remove_isolated`` of ``badslam_tpu_torch/ops/
depth_proc.py`` and ``calibrate_depth`` of ``ops/depth_model.py``, in the
same operation order, so that on the same device it rounds as the program's
plain chain does (the kernel follows that order with FMA contraction off).
It imports nothing of the program. The calibration is the one a new map
starts from (the camera's intrinsics, the configuration's ``a``, a zero
cfactor grid): no cell of the benchmark optimizes intrinsics.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class Intrinsics(NamedTuple):
  """fx, fy, cx, cy (corner convention) as 0-d float32 tensors."""
  fx: torch.Tensor
  fy: torch.Tensor
  cx: torch.Tensor
  cy: torch.Tensor

  @property
  def fx_inv(self):
    return 1.0 / self.fx

  @property
  def fy_inv(self):
    return 1.0 / self.fy

  @property
  def cx_inv(self):
    return -(self.cx - 0.5) / self.fx

  @property
  def cy_inv(self):
    return -(self.cy - 0.5) / self.fy


def _pad(img: torch.Tensor, r: int) -> torch.Tensor:
  return F.pad(img[None, None], (r, r, r, r))[0, 0]


def bilateral_filter_and_cutoff(depth, sigma_xy, sigma_inv_depth,
                                radius_factor, max_depth):
  h, w = depth.shape
  radius = int(radius_factor * sigma_xy + 0.5)
  radius_sq = radius * radius
  denom_xy = 2.0 * sigma_xy * sigma_xy
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


def _pixel_grids(h, w, like):
  xs = torch.arange(w, dtype=like.dtype, device=like.device)[None, :]
  ys = torch.arange(h, dtype=like.dtype, device=like.device)[:, None]
  return xs, ys


def _unproj(cam: Intrinsics, px, py, d):
  return (d * (cam.fx_inv * px + cam.cx_inv),
          d * (cam.fy_inv * py + cam.cy_inv),
          d)


def _dist_sq(p, q):
  dx, dy, dz = (a - b for a, b in zip(p, q))
  return dx * dx + dy * dy + dz * dz


def _shift(arr, h, w, dy, dx):
  return arr[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def calibrate_depth_image(a, cfactor, depth, cell):
  h, w = depth.shape
  ys = torch.arange(h, device=cfactor.device) // cell
  xs = torch.arange(w, device=cfactor.device) // cell
  c = cfactor[ys[:, None], xs[None, :]]
  valid = depth > 0.0
  inv_depth = 1.0 / torch.where(valid, depth, 1.0)
  out = 1.0 / (inv_depth + c * torch.exp(-a * inv_depth))
  return torch.where(valid, out, 0.0)


def compute_normals(depth, cam: Intrinsics, a, cfactor, cell):
  h, w = depth.shape
  calib = calibrate_depth_image(a, cfactor, depth, cell)
  valid = depth > 0.0
  padded_valid = _pad(valid.to(depth.dtype), 1) > 0.5
  padded_calib = _pad(calib, 1)
  all_valid = (valid & _shift(padded_valid, h, w, 0, -1)
               & _shift(padded_valid, h, w, 0, 1)
               & _shift(padded_valid, h, w, -1, 0)
               & _shift(padded_valid, h, w, 1, 0))
  ys_b = torch.arange(h, device=depth.device)[:, None]
  xs_b = torch.arange(w, device=depth.device)[None, :]
  border = (ys_b == 0) | (ys_b == h - 1) | (xs_b == 0) | (xs_b == w - 1)
  all_valid = all_valid & ~border
  xs, ys = _pixel_grids(h, w, depth)
  p_c = _unproj(cam, xs, ys, calib)
  p_l = _unproj(cam, xs - 1, ys, _shift(padded_calib, h, w, 0, -1))
  p_r = _unproj(cam, xs + 1, ys, _shift(padded_calib, h, w, 0, 1))
  p_t = _unproj(cam, xs, ys - 1, _shift(padded_calib, h, w, -1, 0))
  p_b = _unproj(cam, xs, ys + 1, _shift(padded_calib, h, w, 1, 0))
  ratio_thr_sq = 4.0

  def pick_difference(p_neg, p_pos):
    neg_sq = _dist_sq(p_neg, p_c)
    pos_sq = _dist_sq(p_pos, p_c)
    ratio = neg_sq / torch.clamp(pos_sq, min=1e-30)
    use_central = (ratio < ratio_thr_sq) & (ratio > 1.0 / ratio_thr_sq)
    nearer_neg = neg_sq < pos_sq
    return tuple(
        torch.where(use_central, pos - neg,
                    torch.where(nearer_neg, c - neg, pos - c))
        for neg, pos, c in zip(p_neg, p_pos, p_c))

  ax, ay, az = pick_difference(p_l, p_r)
  bx, by, bz = pick_difference(p_b, p_t)
  nx = ay * bz - az * by
  ny = az * bx - ax * bz
  nz = ax * by - ay * bx
  length = torch.sqrt(nx * nx + ny * ny + nz * nz)
  degenerate = ~(length > 1e-6)
  sign = torch.where(torch.as_tensor(cam.fy_inv) < 0, -1.0, 1.0)
  inv_len = sign / torch.where(degenerate, 1.0, length)
  keep = all_valid & ~degenerate
  out_x = torch.where(keep, nx * inv_len, 0.0)
  out_y = torch.where(keep, ny * inv_len, 0.0)
  out_depth = torch.where(all_valid, depth, 0.0)
  return out_depth, torch.stack([out_x, out_y], dim=-1)


def compute_radii_and_remove_isolated(depth, cam: Intrinsics):
  h, w = depth.shape
  valid = depth > 0.0
  padded = _pad(depth, 1)
  padded_valid = _pad(valid.to(depth.dtype), 1) > 0.5
  xs, ys = _pixel_grids(h, w, depth)
  p_c = _unproj(cam, xs, ys, depth)
  min_sq = torch.full((h, w), float("inf"), dtype=depth.dtype,
                      device=depth.device)
  count = torch.zeros((h, w), dtype=torch.int32, device=depth.device)
  for dy, dx in ((0, -1), (0, 1), (-1, 0), (1, 0)):
    v_n = _shift(padded_valid, h, w, dy, dx)
    p_n = _unproj(cam, xs + dx, ys + dy, _shift(padded, h, w, dy, dx))
    dist_sq = _dist_sq(p_n, p_c)
    min_sq = torch.where(v_n & (dist_sq < min_sq), dist_sq, min_sq)
    count = count + v_n.to(torch.int32)
  ok = valid & (count >= 4)
  return torch.where(ok, min_sq, 0.0), torch.where(ok, depth, 0.0)


def preprocess(counts: np.ndarray, camera, config: dict, device
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """(filtered depth (H, W), normals (H, W, 2), radius_sq (H, W)) of a u16
  depth image, computed on ``device`` from the configuration file's
  ``preprocess`` block: the counts scaled to metres as the program's
  upload does it, then the three stages."""
  p = config["preprocess"]
  raw = torch.from_numpy(counts.astype(np.float32)).to(device)
  raw = raw * (1.0 / float(config["camera"]["depth_scaling"]))
  intr = torch.from_numpy(np.array(
      [camera.fx, camera.fy, camera.cx, camera.cy], np.float32)).to(device)
  cam = Intrinsics(intr[0], intr[1], intr[2], intr[3])
  cell = int(p["sparse_surfel_cell_size"])
  h, w = counts.shape
  cfactor = torch.zeros((-(-h // cell), -(-w // cell)), dtype=torch.float32,
                        device=device)
  a = torch.from_numpy(np.array(p["depth_deformation_a"], np.float32)
                       ).to(device).reshape(())
  filtered = bilateral_filter_and_cutoff(
      raw, p["bilateral_filter_sigma_xy"],
      p["bilateral_filter_sigma_inv_depth"],
      p["bilateral_filter_radius_factor"], p["max_depth"])
  filtered_b, normals = compute_normals(filtered, cam, a, cfactor, cell)
  radius_sq, filtered_a = compute_radii_and_remove_isolated(filtered_b, cam)
  return filtered_a, normals, radius_sq
