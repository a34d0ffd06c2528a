"""Synthetic RGB-D data: the heightmap world and a TUM-format writer.

Port of the parts of ``badslam_tpu/utils/synthetic.py`` (the convergence
tests' camera and the heightmap world) and ``badslam_tpu/utils/tum_synth.py``
(the constant-twist trajectory and the dataset writer) that the port needs,
and the map-quality metric. The world is a smooth random heightmap z(x, y)
about 1 m in front of the camera, with band-limited value-noise texture, so
depth and photometric residuals agree across views. Everything here is numpy
on the host, except the trajectory, which uses the port's SE(3) exponential.
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from badslam_tpu_torch.geometry import se3, se3_np
from badslam_tpu_torch.geometry.camera import PinholeCamera


def default_test_camera(width: int = 640, height: int = 480
                        ) -> PinholeCamera:
  """The convergence tests' camera: fx = fy = h/2, center at the image
  center (corner-convention cx = 0.5 w - 0.5)."""
  return PinholeCamera(width=width, height=height, fx=0.5 * height,
                       fy=0.5 * height, cx=0.5 * width - 0.5,
                       cy=0.5 * height - 0.5)


def _value_noise_2d(x: np.ndarray, y: np.ndarray, cell: float,
                    seed: int) -> np.ndarray:
  """Smooth value noise in [0, 1]: hash lattice + bilinear interpolation."""
  xi = np.floor(x / cell).astype(np.int64)
  yi = np.floor(y / cell).astype(np.int64)
  tx = (x / cell - xi).astype(np.float32)
  ty = (y / cell - yi).astype(np.float32)

  def h(ix, iy):
    v = (ix * 374761393 + iy * 668265263 + seed * 144665) & 0x7FFFFFFF
    v = (v ^ (v >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((v ^ (v >> 16)) & 0xFFFF).astype(np.float32) / 65535.0

  v00 = h(xi, yi)
  v10 = h(xi + 1, yi)
  v01 = h(xi, yi + 1)
  v11 = h(xi + 1, yi + 1)
  top = v00 + tx * (v10 - v00)
  bot = v01 + tx * (v11 - v01)
  return top + ty * (bot - top)


def heightmap_z(x: np.ndarray, y: np.ndarray, z_distance: float = 1.0,
                z_variation: float = 0.05, seed: int = 5) -> np.ndarray:
  """Smooth random surface z(x, y)."""
  v = (_value_noise_2d(x, y, 0.35, seed)
       + 0.5 * _value_noise_2d(x, y, 0.11, seed + 1))
  return z_distance + z_variation * (2.0 * v / 1.5 - 1.0)


def render_heightmap(camera: PinholeCamera, global_T_frame: np.ndarray,
                     z_distance: float = 1.0, z_variation: float = 0.05,
                     seed: int = 5, texture_cell: float = 0.02,
                     border: int = 2,
                     raw_to_float_depth: float = 1.0 / 5000.0):
  """(depth, intensity) of the heightmap from a pose, by fixed-point ray
  casting. Depth is quantized to the raw sensor step; intensity is
  band-limited value noise on u8 steps."""
  w, h = camera.width, camera.height
  R = global_T_frame[:3, :3].astype(np.float64)
  o = global_T_frame[:3, 3].astype(np.float64)
  nx = (np.arange(w, dtype=np.float64) - (float(camera.cx) - 0.5)) \
      / float(camera.fx)
  ny = (np.arange(h, dtype=np.float64) - (float(camera.cy) - 0.5)) \
      / float(camera.fy)
  dx, dy = np.meshgrid(nx, ny)
  dirs = np.stack([dx, dy, np.ones_like(dx)], axis=-1) @ R.T

  dz = dirs[..., 2]
  ok = dz > 1e-6
  dz_safe = np.where(ok, dz, 1.0)
  t = (z_distance - o[2]) / dz_safe
  for _ in range(16):
    px = o[0] + t * dirs[..., 0]
    py = o[1] + t * dirs[..., 1]
    t = (heightmap_z(px, py, z_distance, z_variation, seed) - o[2]) / dz_safe
  depth = np.where(ok & (t > 0.05), t, 0.0)
  depth = np.floor(depth / raw_to_float_depth + 0.5) * raw_to_float_depth
  mask = np.zeros((h, w), bool)
  mask[border:h - border, border:w - border] = True
  depth = np.where(mask, depth, 0.0).astype(np.float32)

  px = o[0] + t * dirs[..., 0]
  py = o[1] + t * dirs[..., 1]
  v = (0.40 * _value_noise_2d(px, py, texture_cell * 17.0, seed + 8)
       + 0.40 * _value_noise_2d(px, py, texture_cell * 5.0, seed + 7)
       + 0.20 * _value_noise_2d(px, py, texture_cell, seed + 9))
  v = 0.15 + 0.7 * v
  u8 = np.clip(np.floor(255.0 * v + 0.5), 0, 255)
  return depth, u8.astype(np.float32) * np.float32(1.0 / 255.0)


def straight_trajectory(num_frames: int, step=None) -> List[np.ndarray]:
  """The constant-twist trajectory of the odometry-only benchmark
  configuration: frame i is exp(i * step)."""
  if step is None:
    step = [0.002, 0.0008, -0.0005, 0.0005, -0.00025, 0.0004]
  step = np.asarray(step, np.float64)
  return [se3.exp(torch.as_tensor(i * step, dtype=torch.float32)).numpy()
          for i in range(num_frames)]


def write_tum_dataset(out_dir: str, trajectory: List[np.ndarray],
                      width: int = 640, height: int = 480,
                      depth_scaling: float = 5000.0, fps: float = 30.0,
                      seed: int = 5,
                      camera: Optional[PinholeCamera] = None) -> str:
  """Render the heightmap world along ``trajectory`` and write a TUM
  dataset: calibration.txt, associated.txt, groundtruth.txt, rgb/*.png
  (grey as RGB) and depth/*.png (16-bit, depth_scaling * metres)."""
  cam = camera or default_test_camera(width, height)
  os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
  os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
  with open(os.path.join(out_dir, "calibration.txt"), "w") as f:
    # The file carries the center convention; the loader adds 0.5 back.
    f.write(f"{float(cam.fx)} {float(cam.fy)} "
            f"{float(cam.cx) - 0.5} {float(cam.cy) - 0.5}\n")
  assoc_lines, gt_lines = [], []
  for i, T in enumerate(trajectory):
    depth, inten = render_heightmap(cam, T, seed=seed,
                                    raw_to_float_depth=1.0 / depth_scaling)
    u8 = np.clip(np.floor(inten * 255.0 + 0.5), 0, 255).astype(np.uint8)
    Image.fromarray(np.stack([u8, u8, u8], axis=-1)).save(
        os.path.join(out_dir, f"rgb/{i:06d}.png"))
    Image.fromarray(np.floor(depth * depth_scaling + 0.5).astype(
        np.uint16)).save(os.path.join(out_dir, f"depth/{i:06d}.png"))
    ts = i / fps
    assoc_lines.append(f"{ts:.6f} rgb/{i:06d}.png {ts:.6f} depth/{i:06d}.png")
    q = se3_np.matrix_to_quaternion(T[:3, :3])
    t = T[:3, 3]
    gt_lines.append(f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
  with open(os.path.join(out_dir, "associated.txt"), "w") as f:
    f.write("\n".join(assoc_lines) + "\n")
  with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
    f.write("\n".join(gt_lines) + "\n")
  return out_dir


def surfel_map_error(positions: np.ndarray, z_distance: float = 1.0,
                     z_variation: float = 0.05, seed: int = 5) -> dict:
  """Map-quality metric against the analytic heightmap world.

  The world is the graph of z(x, y) = heightmap_z(x, y), so every
  reconstructed surfel has a closed-form ground-truth surface point directly
  below or above it: error_i = pos_z_i - z(pos_x_i, pos_y_i). The slopes are
  small, so the vertical distance overestimates the point-to-surface
  distance by a few percent only.

  positions: (N, 3) world-frame positions of the valid surfels. Returns
  summary statistics in metres."""
  positions = np.asarray(positions, np.float64)
  if positions.size == 0:
    return {"count": 0}
  err = positions[:, 2] - heightmap_z(positions[:, 0], positions[:, 1],
                                      z_distance, z_variation, seed)
  abs_err = np.abs(err)
  return {
      "count": int(positions.shape[0]),
      "rmse_m": float(np.sqrt(np.mean(err ** 2))),
      "mean_abs_m": float(np.mean(abs_err)),
      "median_abs_m": float(np.median(abs_err)),
      "p95_abs_m": float(np.quantile(abs_err, 0.95)),
      "max_abs_m": float(np.max(abs_err)),
      "bias_m": float(np.mean(err)),
  }
