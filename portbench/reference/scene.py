"""The scene's ground truth, in plain numpy: the heightmap world, its
renderer, and the camera path of a traffic mix.

A frozen copy of the arithmetic of ``badslam_tpu_torch/utils/synthetic.py``
(``_value_noise_2d``, ``heightmap_z``, ``render_heightmap`` without the
occluder boxes and the repeating texture) and of
``badslam_tpu_torch/utils/tum_synth.py`` (``loop_trajectory``), generalised
to a circle of any radius that starts at a phase drawn from the seed (the
default generator of a traffic mix, ``traffic/circle.py``, draws its poses
from here). It imports nothing of the program: the benchmark renders its
frames from the same formulas on the device (``harness/render.py``), and
the judge (``judge.py``) reads the surface from here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class World(NamedTuple):
  """The heightmap world a seed chooses: its terrain and texture seed, and
  the traffic file's shape parameters."""
  seed: int
  z_distance: float
  z_variation: float
  texture_cell: float


class Camera(NamedTuple):
  """Pinhole intrinsics in the corner convention (cx = the center
  convention's cx + 0.5), as the port stores them."""
  width: int
  height: int
  fx: float
  fy: float
  cx: float
  cy: float


def seeded(seed: int):
  """(terrain seed, start phase in radians) drawn from the run's seed: the
  same seed gives the same world and path, every seed the same sizes."""
  rng = np.random.default_rng(int(seed))
  return int(rng.integers(0, 1 << 20)), float(rng.uniform(0.0, 2.0 * np.pi))


def world_of(traffic: dict, seed: int) -> World:
  terrain, _ = seeded(seed)
  w = traffic["world"]
  return World(terrain, float(w["z_distance"]), float(w["z_variation"]),
               float(w["texture_cell"]))


def value_noise_2d(x: np.ndarray, y: np.ndarray, cell: float,
                   seed: int) -> np.ndarray:
  """Smooth value noise in [0, 1]: hash lattice + bilinear interpolation."""
  xi = np.floor(x / cell).astype(np.int64)
  yi = np.floor(y / cell).astype(np.int64)
  tx = (x / cell - xi).astype(np.float32)
  ty = (y / cell - yi).astype(np.float32)

  def h(ix, iy):
    v = (ix * 374761393 + iy * 668265263 + seed * 144665) & 0x7FFFFFFF
    v = (v ^ (v >> 13)) * 1274126177 & 0x7FFFFFFF
    return ((v ^ (v >> 16)) & 0xFFFF).astype(np.float32) / np.float32(65535.0)

  v00 = h(xi, yi)
  v10 = h(xi + 1, yi)
  v01 = h(xi, yi + 1)
  v11 = h(xi + 1, yi + 1)
  top = v00 + tx * (v10 - v00)
  bot = v01 + tx * (v11 - v01)
  return top + ty * (bot - top)


def heightmap_z(x: np.ndarray, y: np.ndarray, world: World) -> np.ndarray:
  """The surface z(x, y) of the world (float32)."""
  v = (value_noise_2d(x, y, 0.35, world.seed)
       + np.float32(0.5) * value_noise_2d(x, y, 0.11, world.seed + 1))
  return (np.float32(world.z_distance) + np.float32(world.z_variation)
          * (np.float32(2.0) * v / np.float32(1.5) - np.float32(1.0)))


def circle_pose(s: np.ndarray, radius: float, wobble: float,
                look_jitter: float) -> np.ndarray:
  """global_T_frame (N, 4, 4) float32 at circle angles ``s``: a horizontal
  circle of ``radius`` through the origin's neighbourhood with a height
  wobble and a gentle look around, the camera looking along +z onto the
  surface (``loop_trajectory``'s formulas)."""
  s = np.asarray(s, np.float64)
  out = np.zeros((len(s), 4, 4), np.float64)
  yaw = look_jitter * np.sin(3.0 * s)
  pitch = look_jitter * np.cos(2.0 * s) * 0.7
  cy, sy = np.cos(yaw), np.sin(yaw)
  cp, sp = np.cos(pitch), np.sin(pitch)
  # Ry @ Rx, written out.
  out[:, 0, 0] = cy
  out[:, 0, 1] = sy * sp
  out[:, 0, 2] = sy * cp
  out[:, 1, 1] = cp
  out[:, 1, 2] = -sp
  out[:, 2, 0] = -sy
  out[:, 2, 1] = cy * sp
  out[:, 2, 2] = cy * cp
  out[:, 0, 3] = radius * np.sin(s)
  out[:, 1, 3] = radius * (1.0 - np.cos(s))
  out[:, 2, 3] = wobble * np.sin(2.0 * s)
  out[:, 3, 3] = 1.0
  return out.astype(np.float32)


def pose_index(poses: np.ndarray, traffic: dict, i: int) -> int:
  """The pose frame i shows: a cyclic mix replays its poses."""
  return i % len(poses) if traffic["cyclic"] else i


def pixel_rays(camera: Camera) -> np.ndarray:
  """(H, W, 3) float64 camera-frame directions with z = 1 of the pixel
  centers."""
  nx = (np.arange(camera.width, dtype=np.float64) - (camera.cx - 0.5)) \
      / camera.fx
  ny = (np.arange(camera.height, dtype=np.float64) - (camera.cy - 0.5)) \
      / camera.fy
  dx, dy = np.meshgrid(nx, ny)
  return np.stack([dx, dy, np.ones_like(dx)], axis=-1)


def render(camera: Camera, global_T_frame: np.ndarray, world: World,
           depth_scaling: float, border: int = 2):
  """(u16 depth counts (H, W), u8 grey (H, W)) of the world from a pose, by
  fixed-point ray casting; depth quantized to the sensor's step."""
  R = global_T_frame[:3, :3].astype(np.float64)
  o = global_T_frame[:3, 3].astype(np.float64)
  dirs = pixel_rays(camera) @ R.T
  dz = dirs[..., 2]
  ok = dz > 1e-6
  dz_safe = np.where(ok, dz, 1.0)
  t = (world.z_distance - o[2]) / dz_safe
  for _ in range(16):
    px = o[0] + t * dirs[..., 0]
    py = o[1] + t * dirs[..., 1]
    t = (heightmap_z(px, py, world) - o[2]) / dz_safe
  depth = np.where(ok & (t > 0.05), t, 0.0)
  counts = np.floor(depth * depth_scaling + 0.5)
  mask = np.zeros(counts.shape, bool)
  mask[border:-border, border:-border] = True
  counts = np.where(mask, counts, 0.0).astype(np.uint16)

  px = o[0] + t * dirs[..., 0]
  py = o[1] + t * dirs[..., 1]
  c, s = world.texture_cell, world.seed
  v = (np.float32(0.40) * value_noise_2d(px, py, c * 17.0, s + 8)
       + np.float32(0.40) * value_noise_2d(px, py, c * 5.0, s + 7)
       + np.float32(0.20) * value_noise_2d(px, py, c, s + 9))
  v = np.float32(0.15) + np.float32(0.7) * v
  grey = np.clip(np.floor(np.float32(255.0) * v + np.float32(0.5)), 0, 255)
  return counts, grey.astype(np.uint8)
