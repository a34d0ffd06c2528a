"""The traffic's frames, rendered on the device in batches.

A PyTorch copy of ``reference/scene.render`` (same operations and dtypes:
float64 rays and ray casting, int64 lattice hashes, float32 noise values;
divisions by a tensor, since CUDA turns a division by a host scalar into a
product with its reciprocal), so that a frame comes out as the numpy
reference renders it. It runs during set-up only; the frames reach the
program as host arrays, u16 depth and u8 RGB, as a sensor's would.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from portbench.reference import scene

# Frames per batch: a batch's temporaries are ~20 float64 planes of
# batch x H x W, some 1.5 GB at 640x480.
BATCH = 32


def _value_noise(x: torch.Tensor, y: torch.Tensor, cell: float, seed: int
                 ) -> torch.Tensor:
  xc = x / cell
  yc = y / cell
  xi = torch.floor(xc).to(torch.int64)
  yi = torch.floor(yc).to(torch.int64)
  tx = (xc - xi).to(torch.float32)
  ty = (yc - yi).to(torch.float32)
  denom = torch.tensor(65535.0, dtype=torch.float32, device=x.device)

  def h(ix, iy):
    v = (ix * 374761393 + iy * 668265263 + seed * 144665) & 0x7FFFFFFF
    v = ((v ^ (v >> 13)) * 1274126177) & 0x7FFFFFFF
    return ((v ^ (v >> 16)) & 0xFFFF).to(torch.float32) / denom

  v00 = h(xi, yi)
  v10 = h(xi + 1, yi)
  v01 = h(xi, yi + 1)
  v11 = h(xi + 1, yi + 1)
  top = v00 + tx * (v10 - v00)
  bot = v01 + tx * (v11 - v01)
  return top + ty * (bot - top)


def _heightmap_z(x, y, world: scene.World) -> torch.Tensor:
  v = (_value_noise(x, y, 0.35, world.seed)
       + 0.5 * _value_noise(x, y, 0.11, world.seed + 1))
  f32 = lambda c: torch.tensor(c, dtype=torch.float32, device=x.device)
  return f32(world.z_distance) + f32(world.z_variation) * (
      2.0 * v / f32(1.5) - 1.0)


def render_batch(camera: scene.Camera, poses: np.ndarray,
                 world: scene.World, depth_scaling: float, device,
                 border: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
  """(u16 depth counts as int32 (B, H, W), u8 grey (B, H, W)) on
  ``device`` of the poses (B, 4, 4)."""
  rays = torch.from_numpy(scene.pixel_rays(camera)).to(device)
  R = torch.from_numpy(poses[:, :3, :3].astype(np.float64)).to(device)
  o = torch.from_numpy(poses[:, :3, 3].astype(np.float64)).to(device)
  dirs = torch.einsum("hwk,bjk->bhwj", rays, R)
  ox, oy, oz = (o[:, k, None, None] for k in range(3))
  dz = dirs[..., 2]
  ok = dz > 1e-6
  dz_safe = torch.where(ok, dz, 1.0)
  t = (world.z_distance - oz) / dz_safe
  for _ in range(16):
    px = ox + t * dirs[..., 0]
    py = oy + t * dirs[..., 1]
    t = (_heightmap_z(px, py, world) - oz) / dz_safe
  depth = torch.where(ok & (t > 0.05), t, 0.0)
  counts = torch.floor(depth * depth_scaling + 0.5)
  mask = torch.zeros(counts.shape[1:], dtype=torch.bool, device=device)
  mask[border:-border, border:-border] = True
  counts = torch.where(mask, counts, 0.0).to(torch.int32)

  px = ox + t * dirs[..., 0]
  py = oy + t * dirs[..., 1]
  c, s = world.texture_cell, world.seed
  v = (0.40 * _value_noise(px, py, c * 17.0, s + 8)
       + 0.40 * _value_noise(px, py, c * 5.0, s + 7)
       + 0.20 * _value_noise(px, py, c, s + 9))
  v = 0.15 + 0.7 * v
  grey = torch.clamp(torch.floor(255.0 * v + 0.5), 0, 255).to(torch.uint8)
  return counts, grey


def render_frames(camera: scene.Camera, poses: np.ndarray,
                  world: scene.World, depth_scaling: float, device
                  ) -> Tuple[np.ndarray, np.ndarray]:
  """(u16 depth (N, H, W), u8 RGB (N, H, W, 3)) host arrays of every pose,
  rendered on ``device`` in batches of ``BATCH``."""
  n = len(poses)
  depth = np.empty((n, camera.height, camera.width), np.uint16)
  rgb = np.empty((n, camera.height, camera.width, 3), np.uint8)
  for start in range(0, n, BATCH):
    counts, grey = render_batch(camera, poses[start:start + BATCH], world,
                                depth_scaling, device)
    depth[start:start + len(counts)] = counts.cpu().numpy().astype(np.uint16)
    grey = grey.cpu().numpy()
    rgb[start:start + len(grey)] = grey[..., None]
  return depth, rgb
