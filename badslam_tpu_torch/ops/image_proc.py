"""Color-image preprocessing: brightness (luma) and Sobel gradient magnitude.

Port of ``badslam_tpu/ops/image_proc.py``. Intensity is float32 in [0, 1]
on u8 steps, as the reference's uchar color texture reads.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
  """(H, W, 3) uint8/float RGB -> (H, W) float intensity in [0, 1]:
  u8 luma = floor(0.299R + 0.587G + 0.114B + 0.5), normalized by 255."""
  rgb_f = rgb.to(torch.float32)
  luma_u8 = torch.floor(
      0.299 * rgb_f[..., 0] + 0.587 * rgb_f[..., 1] + 0.114 * rgb_f[..., 2]
      + 0.5)
  return torch.clamp(luma_u8, 0.0, 255.0) * (1.0 / 255.0)


def sobel_gradient_magnitude(intensity: torch.Tensor) -> torch.Tensor:
  """Normalized Sobel gradient magnitude in [0, 1] with clamp-to-edge taps
  (ComputeSobelGradientMagnitudeKernel), truncated to u8 steps."""
  h, w = intensity.shape
  img = intensity * 255.0
  padded = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]

  def shift(dy, dx):
    return padded[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

  gx = (shift(-1, 1) - shift(-1, -1)
        + 2.0 * (shift(0, 1) - shift(0, -1))
        + shift(1, 1) - shift(1, -1))
  gy = (shift(1, -1) - shift(-1, -1)
        + 2.0 * (shift(1, 0) - shift(-1, 0))
        + shift(1, 1) - shift(-1, 1))
  normalizer = 255.99 / (math.sqrt(2.0) * 4.0 * 255.0)
  mag_u8 = torch.floor(torch.clamp(
      normalizer * torch.sqrt(gx * gx + gy * gy), 0.0, 255.0))
  return mag_u8 * (1.0 / 255.0)
