"""Bilinear image sampling matching CUDA texture semantics.

Port of ``badslam_tpu/ops/interp.py``: ``tex2D`` with corner-convention
float coordinates, linear filtering (the pixel grid interpolated at
(x - 0.5, y - 0.5)) and clamp-to-edge addressing, plus the 4-tap analytic
gradient of cost_function.cuh:200-212. All functions take coordinate
tensors of any shape and gather from one (H, W) image.

The reference's packed-u32 sampling (one gather for four u8 taps) is a
workaround for slow TPU gathers and is not ported: on a GPU the four taps
are four cached loads, and intensity images already hold u8-step values,
so plain 4-tap sampling gives the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch


def gather_image(img: torch.Tensor, iy: torch.Tensor,
                 ix: torch.Tensor) -> torch.Tensor:
  """Clamped integer-pixel lookup for (H, W) or (H, W, C) images."""
  h, w = img.shape[0], img.shape[1]
  lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
  flat = img.reshape((h * w,) + img.shape[2:])
  return flat[lin].reshape(iy.shape + img.shape[2:])


def _lerp_setup(x: torch.Tensor, y: torch.Tensor):
  """Tap setup: ix = int(max(0, x-0.5)); tx = clamp(x-0.5-ix, 0, 1)."""
  ix = torch.clamp(x - 0.5, min=0.0).to(torch.int64)
  iy = torch.clamp(y - 0.5, min=0.0).to(torch.int64)
  tx = torch.clamp(x - 0.5 - ix.to(x.dtype), 0.0, 1.0)
  ty = torch.clamp(y - 0.5 - iy.to(y.dtype), 0.0, 1.0)
  return ix, iy, tx, ty


def _taps(img, x, y):
  ix, iy, tx, ty = _lerp_setup(x, y)
  tl = gather_image(img, iy, ix)
  tr = gather_image(img, iy, ix + 1)
  bl = gather_image(img, iy + 1, ix)
  br = gather_image(img, iy + 1, ix + 1)
  return tl, tr, bl, br, tx, ty


def sample_bilinear(img: torch.Tensor, x: torch.Tensor,
                    y: torch.Tensor) -> torch.Tensor:
  """tex2D(img, x, y) with linear filtering, corner-convention coords."""
  tl, tr, bl, br, tx, ty = _taps(img, x, y)
  top = tl + tx * (tr - tl)
  bottom = bl + tx * (br - bl)
  return top + ty * (bottom - top)


def sample_bilinear_grad(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
  """d(sample)/dx, d(sample)/dy of the bilinear interpolation (per pixel)."""
  tl, tr, bl, br, tx, ty = _taps(img, x, y)
  dx = (br - bl) * ty + (tr - tl) * (1.0 - ty)
  dy = (br - tr) * tx + (bl - tl) * (1.0 - tx)
  return dx, dy


def sample_bilinear_with_grad(img: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor):
  """Value and gradient from one set of 4 taps."""
  tl, tr, bl, br, tx, ty = _taps(img, x, y)
  top = tl + tx * (tr - tl)
  bottom = bl + tx * (br - bl)
  value = top + ty * (bottom - top)
  dx = (br - bl) * ty + (tr - tl) * (1.0 - ty)
  dy = (br - tr) * tx + (bl - tl) * (1.0 - tx)
  return value, dx, dy
