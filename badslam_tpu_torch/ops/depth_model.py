"""The non-parametric depth deformation model.

Port of ``badslam_tpu/ops/depth_model.py``: d' = 1 / (1/d + c * exp(-a/d)),
with c from a per-cell "cfactor" grid (one cell per sparse_surfel_cell_size
pixels) and a the global deformation factor. Depth is float32 metres, 0 =
invalid.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def calibrate_depth(a, cfactor: torch.Tensor,
                    depth: torch.Tensor) -> torch.Tensor:
  """d' = 1/(1/d + c*exp(-a/d)); invalid (<= 0) depth passes through as 0."""
  valid = depth > 0.0
  inv_depth = 1.0 / torch.where(valid, depth, 1.0)
  out = 1.0 / (inv_depth + cfactor * torch.exp(-a * inv_depth))
  return torch.where(valid, out, 0.0)


def cfactor_shape(height: int, width: int, cell: int) -> tuple:
  """cfactor grid dimensions: ceil(size / cell)."""
  return (-(-height // cell), -(-width // cell))


def resize_cfactor(cfactor: torch.Tensor, shape: Tuple[int, int]
                   ) -> torch.Tensor:
  """The cfactor grid resampled to ``shape`` (UpscaleBufferBilinearly,
  main.cc:806-812) as ``jax.image.resize(..., "bilinear")`` does it:
  half-pixel centres, and a triangle filter widened by the scale when the
  grid shrinks (antialiased)."""
  return F.interpolate(cfactor[None, None], size=tuple(shape),
                       mode="bilinear", align_corners=False,
                       antialias=True)[0, 0]


def cfactor_image(cfactor: torch.Tensor, height: int, width: int,
                  cell: int) -> torch.Tensor:
  """The cell grid upsampled to a full (H, W) image by nearest lookup,
  cfactor[y // cell, x // cell]. Indexing gives the same values as the
  reference's two 0/1 selection matmuls, which exist there only because
  Mosaic cannot lower a gather."""
  ys = torch.arange(height, device=cfactor.device) // cell
  xs = torch.arange(width, device=cfactor.device) // cell
  return cfactor[ys[:, None], xs[None, :]]


def calibrate_depth_image(a, cfactor: torch.Tensor, depth: torch.Tensor,
                          cell: int) -> torch.Tensor:
  """Calibrate a full (H, W) depth image with the per-cell cfactor grid."""
  h, w = depth.shape
  return calibrate_depth(a, cfactor_image(cfactor, h, w, cell), depth)
