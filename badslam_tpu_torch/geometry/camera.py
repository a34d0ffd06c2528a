"""Pinhole camera with the reference's dual pixel-origin conventions.

Port of ``badslam_tpu/geometry/camera.py``. Intrinsics are stored in the
"pixel corner" convention: a projected float position ``p`` covers pixel
``int(p)``, while the unprojection of integer pixel (x, y) uses the center
convention (cx - 0.5). fx, fy, cx, cy may be Python floats or 0-d tensors
(views into ``DepthCalibration.depth_intr``), so a camera built from
device-resident intrinsics never reads them back to the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class PinholeCamera(NamedTuple):
  width: int
  height: int
  fx: "float | torch.Tensor"
  fy: "float | torch.Tensor"
  cx: "float | torch.Tensor"
  cy: "float | torch.Tensor"

  def project_corner(self, p: torch.Tensor) -> torch.Tensor:
    """(...,3) camera-space points -> (...,2) float pixels, corner origin."""
    z = p[..., 2]
    return torch.stack(
        [self.fx * (p[..., 0] / z) + self.cx,
         self.fy * (p[..., 1] / z) + self.cy], dim=-1)

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

  def nx(self, px: torch.Tensor) -> torch.Tensor:
    """Normalized image x-coordinate of integer pixel px (center
    convention)."""
    return self.fx_inv * px + self.cx_inv

  def ny(self, py: torch.Tensor) -> torch.Tensor:
    return self.fy_inv * py + self.cy_inv

  def unproject_center(self, px: torch.Tensor, py: torch.Tensor,
                       depth: torch.Tensor) -> torch.Tensor:
    """Unproject integer pixel indices (center convention) at given depth:
    (...,) x, y, depth -> (...,3)."""
    return torch.stack([depth * self.nx(px), depth * self.ny(py), depth],
                       dim=-1)

  def scaled(self, factor: float) -> "PinholeCamera":
    """Camera of a pyramid level (libvis camera.h Scaled): corner-convention
    intrinsics scale as fx*s, cx*s; shrinking floors the size so it matches
    repeated floor-halving, growing rounds."""
    if factor < 1.0:
      size = lambda v: int(math.floor(v * factor))
    else:
      size = lambda v: int(round(v * factor))
    return PinholeCamera(width=size(self.width), height=size(self.height),
                         fx=self.fx * factor, fy=self.fy * factor,
                         cx=self.cx * factor, cy=self.cy * factor)

  def in_image(self, pxy: torch.Tensor) -> torch.Tensor:
    """Bounds test of ProjectSurfelToImage (util.cuh:67-82): float coords
    >= 0 and the containing integer pixel inside the image.

    For p >= 0, ``int(p) < size`` holds exactly when ``p < size``, so the
    test compares floats. That also keeps +inf and NaN out, where a
    float-to-int cast of an out-of-range value is undefined (the CPU gives
    INT_MIN, which would pass an integer bound test)."""
    x, y = pxy[..., 0], pxy[..., 1]
    return (x >= 0) & (y >= 0) & (x < self.width) & (y < self.height)


class DepthToColorTransform(NamedTuple):
  """Affine pixel transform depth -> color (surfel_projection.cuh:184-207),
  for differing depth and color intrinsics; corner convention on both
  sides."""

  fx: "float | torch.Tensor"
  fy: "float | torch.Tensor"
  cx: "float | torch.Tensor"
  cy: "float | torch.Tensor"
  width: int
  height: int

  @staticmethod
  def between(depth_cam: PinholeCamera,
              color_cam: PinholeCamera) -> "DepthToColorTransform":
    # color_px = color_fx * ((depth_px - depth_cx) / depth_fx) + color_cx
    fx = color_cam.fx / depth_cam.fx
    fy = color_cam.fy / depth_cam.fy
    return DepthToColorTransform(
        fx=fx, fy=fy,
        cx=color_cam.cx - fx * depth_cam.cx,
        cy=color_cam.cy - fy * depth_cam.cy,
        width=color_cam.width, height=color_cam.height)

  def apply(self, pxy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (color_pxy, in_bounds). As in ``PinholeCamera.in_image``
    the bound test compares floats, which keeps inf and NaN out."""
    out = torch.stack([self.fx * pxy[..., 0] + self.cx,
                       self.fy * pxy[..., 1] + self.cy], dim=-1)
    x, y = out[..., 0], out[..., 1]
    ok = (x >= 0) & (y >= 0) & (x < self.width) & (y < self.height)
    return out, ok
