"""Distorted camera models and undistortion maps.

Port of ``badslam_tpu/geometry/distortion.py``: the original's
RadtanDistortion8/9 and ThinPrismFisheyeDistortion12 camera models (libvis
camera.h) and its undistortion path (undistortion.{h,cc}: a pinhole camera
chosen to cover the distorted view, and maps that resample a distorted
image into it). The SLAM core runs on pinhole intrinsics; these models bring
distorted live-camera images into the pinhole world.

A camera's parameters are 0-d float32 tensors, and it computes on their
device. Inverse distortion is a fixed number of fixed-point iterations with
no host read inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.ops import interp


def _project_corner(cam, p: torch.Tensor) -> torch.Tensor:
  z = p[..., 2]
  d = cam.distort(torch.stack([p[..., 0] / z, p[..., 1] / z], dim=-1))
  return torch.stack([cam.fx * d[..., 0] + cam.cx,
                      cam.fy * d[..., 1] + cam.cy], dim=-1)


def _unproject_center(cam, px, py, depth) -> torch.Tensor:
  nxy_d = torch.stack([(px - (cam.cx - 0.5)) / cam.fx,
                       (py - (cam.cy - 0.5)) / cam.fy], dim=-1)
  nxy = cam.undistort(nxy_d)
  return torch.stack([depth * nxy[..., 0], depth * nxy[..., 1], depth],
                     dim=-1)


class RadTanCamera(NamedTuple):
  """Pinhole with radial-tangential (plumb bob) distortion: Radtan8 (k3 = 0)
  or Radtan9. cx, cy in the corner convention, as PinholeCamera's."""
  width: int
  height: int
  fx: torch.Tensor
  fy: torch.Tensor
  cx: torch.Tensor
  cy: torch.Tensor
  k1: torch.Tensor
  k2: torch.Tensor
  p1: torch.Tensor
  p2: torch.Tensor
  k3: torch.Tensor

  def distort(self, nxy: torch.Tensor) -> torch.Tensor:
    """Normalized image coordinates (..., 2) -> distorted ones."""
    x, y = nxy[..., 0], nxy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
    xd = (x * radial + 2.0 * self.p1 * x * y
          + self.p2 * (r2 + 2.0 * x * x))
    yd = (y * radial + self.p1 * (r2 + 2.0 * y * y)
          + 2.0 * self.p2 * x * y)
    return torch.stack([xd, yd], dim=-1)

  def undistort(self, nxy_d: torch.Tensor, iterations: int = 20
                ) -> torch.Tensor:
    """Inverse distortion by ``iterations`` fixed-point steps. Far outside
    the model's domain the iteration diverges; there the distorted
    coordinates are returned, as the original's iterative Unproject does
    not converge there either."""
    est = nxy_d
    for _ in range(iterations):
      est = est - (self.distort(est) - nxy_d)
    ok = torch.isfinite(est).all(dim=-1, keepdim=True)
    return torch.where(ok, est, nxy_d)

  project_corner = _project_corner
  unproject_center = _unproject_center


class ThinPrismFisheyeCamera(NamedTuple):
  """Pinhole with equidistant fisheye, radial, tangential and thin-prism
  terms (the original's ThinPrismFisheyeDistortion12)."""
  width: int
  height: int
  fx: torch.Tensor
  fy: torch.Tensor
  cx: torch.Tensor
  cy: torch.Tensor
  k1: torch.Tensor
  k2: torch.Tensor
  k3: torch.Tensor
  k4: torch.Tensor
  p1: torch.Tensor
  p2: torch.Tensor
  sx1: torch.Tensor
  sy1: torch.Tensor

  def distort(self, nxy: torch.Tensor) -> torch.Tensor:
    x, y = nxy[..., 0], nxy[..., 1]
    r = torch.sqrt(x * x + y * y)
    theta = torch.atan(r)
    small = r < 1e-8
    scale = torch.where(small, 1.0, theta / torch.where(small, 1.0, r))
    xf = x * scale
    yf = y * scale
    r2 = xf * xf + yf * yf
    radial = 1.0 + r2 * (self.k1 + r2 * (self.k2
                                         + r2 * (self.k3 + r2 * self.k4)))
    xd = (xf * radial + 2.0 * self.p1 * xf * yf
          + self.p2 * (r2 + 2.0 * xf * xf) + self.sx1 * r2)
    yd = (yf * radial + self.p1 * (r2 + 2.0 * yf * yf)
          + 2.0 * self.p2 * xf * yf + self.sy1 * r2)
    return torch.stack([xd, yd], dim=-1)

  def undistort(self, nxy_d: torch.Tensor, iterations: int = 30
                ) -> torch.Tensor:
    """Inverse distortion by ``iterations`` damped fixed-point steps."""
    est = nxy_d
    for _ in range(iterations):
      est = est - 0.7 * (self.distort(est) - nxy_d)
    return est

  project_corner = _project_corner
  unproject_center = _unproject_center


def pinhole_from_distorted(distorted, avoid_invalid: bool = True
                           ) -> PinholeCamera:
  """Pinhole intrinsics that cover the distorted camera's view
  (undistortion.h:37-62): unproject the border pixels, bound the range of
  normalized coordinates and fit fx, fy, cx, cy so that the undistorted
  image spans the same pixel count. ``avoid_invalid``: the inner bounding
  box, the largest pinhole view that sees only valid pixels."""
  w, h = distorted.width, distorted.height
  xs = np.concatenate([
      np.stack([np.arange(w), np.zeros(w)], -1),
      np.stack([np.arange(w), np.full(w, h - 1)], -1),
      np.stack([np.zeros(h), np.arange(h)], -1),
      np.stack([np.full(h, w - 1), np.arange(h)], -1),
  ]).astype(np.float32)
  dev = distorted.fx.device
  pts = distorted.unproject_center(
      torch.from_numpy(xs[:, 0]).to(dev), torch.from_numpy(xs[:, 1]).to(dev),
      torch.ones(len(xs), dtype=torch.float32, device=dev)).cpu().numpy()
  nx = pts[:, 0]
  ny = pts[:, 1]
  if avoid_invalid:
    nx_min = np.max(nx[xs[:, 0] == 0])
    nx_max = np.min(nx[xs[:, 0] == w - 1])
    ny_min = np.max(ny[xs[:, 1] == 0])
    ny_max = np.min(ny[xs[:, 1] == h - 1])
  else:
    nx_min, nx_max = nx.min(), nx.max()
    ny_min, ny_max = ny.min(), ny.max()
  fx = w / (nx_max - nx_min)
  fy = h / (ny_max - ny_min)
  return PinholeCamera(width=w, height=h, fx=float(fx), fy=float(fy),
                       cx=float(-nx_min * fx), cy=float(-ny_min * fy))


def build_undistortion_maps(distorted, pinhole: PinholeCamera
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(map_x, map_y), each (H, W) on the distorted camera's device: for every
  pixel of the undistorted pinhole image, its source position in the
  distorted image (corner convention, for bilinear sampling)."""
  dev = distorted.fx.device
  ys, xs = torch.meshgrid(
      torch.arange(pinhole.height, dtype=torch.float32, device=dev),
      torch.arange(pinhole.width, dtype=torch.float32, device=dev),
      indexing="ij")
  rays = pinhole.unproject_center(xs, ys, torch.ones_like(xs))
  pxy = distorted.project_corner(rays)
  return pxy[..., 0], pxy[..., 1]


def undistort_image(img: torch.Tensor, map_x: torch.Tensor,
                    map_y: torch.Tensor) -> torch.Tensor:
  """Bilinear remap of an (H, W) image through the undistortion maps."""
  return interp.sample_bilinear(img, map_x, map_y)
