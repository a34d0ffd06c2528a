"""Multi-resolution pyramid construction for odometry.

Port of ``badslam_tpu/ops/pyramid.py`` (kernel_downsample.cu:40-160 of the
original BAD SLAM). Depth downsampling is occlusion-aware: of the four
source pixels, take the valid depth closest to the valid average and carry
that pixel's normal. Color takes the 4-pixel mean and re-quantizes to u8
steps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch


class FramePyramidLevel(NamedTuple):
  depth: torch.Tensor      # (H, W) float32 metric depth, 0 = invalid
  normals: torch.Tensor    # (H, W, 2) image-space normal x/y
  intensity: torch.Tensor  # (H, W) float32 in [0, 1]


def _quads(img: torch.Tensor) -> torch.Tensor:
  """(H, W, ...) -> (4, H//2, W//2, ...) the 2x2 source pixels per output."""
  h2, w2 = img.shape[0] // 2, img.shape[1] // 2
  img = img[: 2 * h2, : 2 * w2]
  return torch.stack([img[0::2, 0::2], img[0::2, 1::2], img[1::2, 0::2],
                      img[1::2, 1::2]], dim=0)


def _sum4(q: torch.Tensor) -> torch.Tensor:
  """Sum over the quad axis in a fixed left-to-right order, so ties in the
  closest-to-average pick resolve the same way on every device."""
  return ((q[0] + q[1]) + q[2]) + q[3]


def downsample_depth_and_normals(
    depth: torch.Tensor, normals: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Half-resolution depth + carried normals (closest-to-average pick;
  argmin takes the first of equal distances, and invalid taps are +inf)."""
  q = _quads(depth)
  valid = q > 0.0
  count = valid.to(torch.int32).sum(dim=0)
  avg = _sum4(torch.where(valid, q, 0.0)) / torch.clamp(count, min=1)
  dist = torch.where(valid, torch.abs(q - avg), float("inf"))
  closest = torch.argmin(dist, dim=0)
  out_depth = torch.where(
      count > 0, torch.gather(q, 0, closest[None])[0], 0.0)
  qn = _quads(normals)
  idx = closest[None, ..., None].expand(1, *closest.shape, qn.shape[-1])
  return out_depth, torch.gather(qn, 0, idx)[0]


def downsample_intensity(intensity: torch.Tensor) -> torch.Tensor:
  """Half-res color: 4-pixel mean, re-quantized to u8 steps."""
  mean = _sum4(_quads(intensity)) / 4.0
  return torch.floor(255.0 * mean + 0.5) * (1.0 / 255.0)


def build_pyramid(depth: torch.Tensor, normals: torch.Tensor,
                  intensity: torch.Tensor,
                  num_scales: int) -> List[FramePyramidLevel]:
  """Full pyramid, level 0 = full resolution."""
  levels = [FramePyramidLevel(depth, normals, intensity)]
  for _ in range(num_scales - 1):
    d, n = downsample_depth_and_normals(levels[-1].depth, levels[-1].normals)
    c = downsample_intensity(levels[-1].intensity)
    levels.append(FramePyramidLevel(d, n, c))
  return levels
