"""Synthetic RGB-D data: the convergence tests' scenes and the heightmap
world.

Port of ``badslam_tpu/utils/synthetic.py``: the convergence tests' camera,
plane scene and intensity image, the heightmap world (with floating
occluder boxes and a repeating texture as options), and the map-quality
metric. The heightmap world is a smooth random surface z(x, y) about 1 m in
front of the camera, with band-limited value-noise texture, so depth and
photometric residuals agree across views. A second world, a set of infinite
planes seen from scattered poses, serves the self-calibration checks and,
with checker texture, the loop-closure scenes (``make_synthetic_video``).
Everything here is numpy on the host, except the poses, which use the
port's SE(3) exponential, and the test-keyframe pipeline, which runs the
port's normal and radius stencils. The TUM-format dataset writer is
``utils/tum_synth.py`` (its names are reachable here too).
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.io.dataset import Frame, RGBDVideo
from badslam_tpu_torch.ops import depth_proc
from badslam_tpu_torch.ops.depth_model import cfactor_shape


def default_test_camera(width: int = 640, height: int = 480
                        ) -> PinholeCamera:
  """The convergence tests' camera: fx = fy = h/2, center at the image
  center (corner-convention cx = 0.5 w - 0.5)."""
  return PinholeCamera(width=width, height=height, fx=0.5 * height,
                       fy=0.5 * height, cx=0.5 * width - 0.5,
                       cy=0.5 * height - 0.5)


def make_plane_scene(camera: PinholeCamera, num_planes: int = 3,
                     plane_distance: float = 2.5, border: int = 10,
                     raw_to_float_depth: float = 1.0 / 1000.0, seed: int = 0,
                     rng: Optional[np.random.Generator] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
  """The convergence tests' scene (test_pose_optimization_geometric_
  residual.cc:85-110 of the original): ``num_planes`` planes with random
  normals (z forced to -1 before normalization) at ``plane_distance``, each
  seen in its own vertical stripe of the image inside a ``border``, depth
  quantized to the raw sensor step. Returns (depth (H, W) float32, 0 where
  invalid; the plane normals (num_planes, 3))."""
  if rng is None:
    rng = np.random.default_rng(seed)
  w, h = camera.width, camera.height
  depth = np.zeros((h, w), np.float32)
  normals = np.zeros((num_planes, 3), np.float32)
  # Center-convention ray directions with z = 1.
  nx = (np.arange(w, dtype=np.float32) - (float(camera.cx) - 0.5)) \
      / float(camera.fx)
  ny = (np.arange(h, dtype=np.float32) - (float(camera.cy) - 0.5)) \
      / float(camera.fy)
  dir_x, dir_y = np.meshgrid(nx, ny)
  min_x, max_x = border, w - border - 1
  for p in range(num_planes):
    n = rng.uniform(-1.0, 1.0, size=3).astype(np.float32)
    n[2] = -1.0
    n /= np.linalg.norm(n)
    normals[p] = n
    left = int(min_x + (max_x - min_x) * ((2 * p) / (2.0 * num_planes - 1)))
    right = int(min_x + (max_x - min_x)
                * ((2 * p + 1) / (2.0 * num_planes - 1)))
    # The ray t (dir_x, dir_y, 1) meets n . x + plane_distance = 0.
    t = -plane_distance / (n[0] * dir_x + n[1] * dir_y + n[2])
    region = np.zeros((h, w), bool)
    region[border:h - border, left:right] = True
    z = np.where(region & (t > 0), t, 0.0)
    z = np.floor(z / raw_to_float_depth + 0.5) * raw_to_float_depth
    depth = np.where(region, z.astype(np.float32), depth)
  return depth, normals


def intensity_function_image(camera: PinholeCamera, kind: str = "sine"
                             ) -> np.ndarray:
  """An analytic intensity image for photometric tests, in [0, 1] on u8
  steps: ``sine``, a sum of sines in x and y, or ``ramp``."""
  w, h = camera.width, camera.height
  xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                       np.arange(h, dtype=np.float32))
  if kind == "sine":
    v = 0.5 + 0.25 * np.sin(0.1 * xs) + 0.25 * np.sin(0.1 * ys)
  elif kind == "ramp":
    v = (xs + ys) / (w + h)
  else:
    raise ValueError(kind)
  u8 = np.floor(255.0 * v + 0.5)
  return u8.astype(np.float32) * np.float32(1.0 / 255.0)


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


def occlusion_boxes(seed: int = 5, z_distance: float = 1.0,
                    spread: float = 0.55, num_boxes: int = 7) -> np.ndarray:
  """Floating axis-aligned boxes between the camera and the heightmap, made
  from ``seed``: their silhouettes put depth discontinuities and occlusion
  shadows into the images, their sides steep normals. Returns (B, 2, 3):
  per box its (min corner, max corner) in the world frame, 0.18-0.38 m
  above the surface (in front of it for the downward-looking cameras)."""
  rng = np.random.default_rng(seed + 1000)
  boxes = []
  for _ in range(num_boxes):
    cx_ = rng.uniform(-spread, spread)
    cy_ = rng.uniform(-spread * 0.5, spread * 1.5)
    half = rng.uniform(0.05, 0.11, size=2)
    height = rng.uniform(0.02, 0.05)
    top = z_distance - rng.uniform(0.18, 0.38)
    boxes.append([[cx_ - half[0], cy_ - half[1], top],
                  [cx_ + half[0], cy_ + half[1], top + height]])
  return np.asarray(boxes, np.float64)


def _ray_box_hits(o: np.ndarray, dirs: np.ndarray, boxes: np.ndarray):
  """Nearest positive ray/box hit per pixel by the slab method. Returns
  (t_hit, hit_mask), t_hit = +inf where no box is hit; a ray that starts
  inside a box hits where it leaves it."""
  t_best = np.full(dirs.shape[:-1], np.inf)
  inv = 1.0 / np.where(np.abs(dirs) < 1e-12, 1e-12, dirs)
  for bmin, bmax in boxes:
    t0 = (bmin[None, None, :] - o[None, None, :]) * inv
    t1 = (bmax[None, None, :] - o[None, None, :]) * inv
    tnear = np.minimum(t0, t1).max(axis=-1)
    tfar = np.maximum(t0, t1).min(axis=-1)
    hit = (tfar >= tnear) & (tfar > 1e-6)
    t_entry = np.where(tnear > 1e-6, tnear, tfar)
    t_best = np.where(hit & (t_entry < t_best), t_entry, t_best)
  return t_best, np.isfinite(t_best)


def render_heightmap(camera: PinholeCamera, global_T_frame: np.ndarray,
                     z_distance: float = 1.0, z_variation: float = 0.05,
                     seed: int = 5, texture_cell: float = 0.02,
                     border: int = 2,
                     raw_to_float_depth: float = 1.0 / 5000.0,
                     boxes: Optional[np.ndarray] = None,
                     texture_period: Optional[float] = None):
  """(depth, intensity) of the heightmap from a pose, by fixed-point ray
  casting. Depth is quantized to the raw sensor step; intensity is
  band-limited value noise on u8 steps.

  ``boxes`` (``occlusion_boxes``): occluders; each pixel sees the nearer of
  the surface and a box, and box faces carry their own texture.
  ``texture_period``: the texture repeats with this world period (x and y
  taken modulo it) while the geometry stays unique, so distinct places look
  alike to appearance-only place recognition."""
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
  box_hit = None
  if boxes is not None and len(boxes):
    t_box, box_mask = _ray_box_hits(o, dirs, np.asarray(boxes, np.float64))
    box_hit = box_mask & (t_box < t) & ok
    t = np.where(box_hit, t_box, t)
  depth = np.where(ok & (t > 0.05), t, 0.0)
  depth = np.floor(depth / raw_to_float_depth + 0.5) * raw_to_float_depth
  mask = np.zeros((h, w), bool)
  mask[border:h - border, border:w - border] = True
  depth = np.where(mask, depth, 0.0).astype(np.float32)

  px = o[0] + t * dirs[..., 0]
  py = o[1] + t * dirs[..., 1]
  if texture_period is not None:
    px = np.mod(px, texture_period)
    py = np.mod(py, texture_period)
  v = (0.40 * _value_noise_2d(px, py, texture_cell * 17.0, seed + 8)
       + 0.40 * _value_noise_2d(px, py, texture_cell * 5.0, seed + 7)
       + 0.20 * _value_noise_2d(px, py, texture_cell, seed + 9))
  if box_hit is not None:
    # The z coordinate breaks the side faces' degeneracy (x or y constant).
    pz = o[2] + t * dirs[..., 2]
    bx = px + 3.7 * pz
    by = py + 1.3 * pz
    vb = (0.45 * _value_noise_2d(bx, by, texture_cell * 13.0, seed + 21)
          + 0.35 * _value_noise_2d(bx, by, texture_cell * 4.0, seed + 22)
          + 0.20 * _value_noise_2d(bx, by, texture_cell, seed + 23))
    v = np.where(box_hit, vb, v)
  v = 0.15 + 0.7 * v
  u8 = np.clip(np.floor(255.0 * v + 0.5), 0, 255)
  return depth, u8.astype(np.float32) * np.float32(1.0 / 255.0)


def _pixel_rays(camera: PinholeCamera) -> np.ndarray:
  """(H, W, 3) camera-frame directions with z = 1 of the pixel centers."""
  nx = (np.arange(camera.width, dtype=np.float64)
        - (float(camera.cx) - 0.5)) / float(camera.fx)
  ny = (np.arange(camera.height, dtype=np.float64)
        - (float(camera.cy) - 0.5)) / float(camera.fy)
  dx, dy = np.meshgrid(nx, ny)
  return np.stack([dx, dy, np.ones_like(dx)], axis=-1)


def render_planes(camera: PinholeCamera, global_T_frame: np.ndarray,
                  plane_normals: np.ndarray, plane_d: float = 2.5,
                  border: int = 10, raw_to_float_depth: float = 1.0 / 1000.0,
                  max_depth: float = 10.0) -> np.ndarray:
  """Depth of the infinite-plane world {n_p . x + d = 0} from a pose: per
  pixel the nearest positive ray intersection, quantized to the raw sensor
  step. One world geometry gives consistent depth maps from every view."""
  w, h = camera.width, camera.height
  R = global_T_frame[:3, :3].astype(np.float64)
  o = global_T_frame[:3, 3].astype(np.float64)
  world_dirs = _pixel_rays(camera) @ R.T

  best = np.full((h, w), np.inf)
  for n in plane_normals:
    denom = world_dirs @ n
    t = -(plane_d + o @ n) / np.where(np.abs(denom) > 1e-12, denom, 1e-12)
    t = np.where((np.abs(denom) > 1e-12) & (t > 0), t, np.inf)
    best = np.minimum(best, t)

  depth = np.where(np.isfinite(best) & (best <= max_depth), best, 0.0)
  depth = np.floor(depth / raw_to_float_depth + 0.5) * raw_to_float_depth
  mask = np.zeros((h, w), bool)
  mask[border:h - border, border:w - border] = True
  return np.where(mask, depth, 0.0).astype(np.float32)


def render_intensity(camera: PinholeCamera, global_T_frame: np.ndarray,
                     depth: np.ndarray, freq: float = 3.0,
                     kind: str = "sine") -> np.ndarray:
  """World-anchored intensity of the 3-D point each pixel sees, so
  photometric residuals agree across views; on u8 steps. ``sine``: a sum of
  sines; ``checker``: a hash of the 3-D cell, whose sharp corners feature
  detectors (ORB/FAST) need."""
  R = global_T_frame[:3, :3].astype(np.float64)
  o = global_T_frame[:3, 3].astype(np.float64)
  pts = (_pixel_rays(camera) * depth[..., None]) @ R.T + o
  if kind == "sine":
    v = (0.5 + 0.2 * np.sin(freq * pts[..., 0])
         + 0.2 * np.sin(freq * pts[..., 1])
         + 0.1 * np.sin(freq * pts[..., 2]))
  elif kind == "checker":
    cells = np.floor(freq * pts).astype(np.int64)
    h = (cells[..., 0] * 73856093 ^ cells[..., 1] * 19349663
         ^ cells[..., 2] * 83492791) & 0xFF
    v = 0.25 + 0.5 * (h.astype(np.float32) / 255.0)
  else:
    raise ValueError(kind)
  u8 = np.clip(np.floor(255.0 * v + 0.5), 0, 255)
  return u8.astype(np.float32) * np.float32(1.0 / 255.0)


def plane_world_normals(count: int = 3, seed: int = 7) -> np.ndarray:
  """(count, 3) unit normals of random planes facing the camera (z
  component -1 before normalization), as the loop-closure scenes use."""
  rng = np.random.default_rng(seed)
  normals = []
  for _ in range(count):
    n = rng.uniform(-1, 1, 3).astype(np.float32)
    n[2] = -1.0
    normals.append(n / np.linalg.norm(n))
  return np.asarray(normals)


def _grey_rgb(intensity: np.ndarray) -> np.ndarray:
  u8 = np.clip(np.floor(intensity * 255.0 + 0.5), 0, 255).astype(np.uint8)
  return np.stack([u8, u8, u8], axis=-1)


def _in_memory_video(camera: PinholeCamera, images, raw_to_float_depth: float,
                     fps: float) -> RGBDVideo:
  """RGBDVideo of (u8 RGB, metric depth) pairs, the depth stored as u16
  counts at ``raw_to_float_depth``; every frame's pose starts at the
  identity, to be estimated."""
  frames = []
  for i, (rgb, depth) in enumerate(images):
    f = Frame(rgb_path="", depth_path="", rgb_timestamp=i / fps,
              depth_timestamp=i / fps)
    f._rgb = rgb
    f._depth = np.floor(depth / raw_to_float_depth + 0.5).astype(np.uint16)
    frames.append(f)
  return RGBDVideo(frames=frames, color_camera=camera, depth_camera=camera,
                   raw_to_float_depth=raw_to_float_depth)


def make_synthetic_video(camera: PinholeCamera,
                         trajectory: List[np.ndarray],
                         plane_normals: np.ndarray, plane_d: float = 2.5,
                         raw_to_float_depth: float = 1.0 / 5000.0,
                         fps: float = 30.0, textured: bool = True,
                         texture_kind: str = "sine") -> RGBDVideo:
  """In-memory RGBDVideo of the plane world rendered along ``trajectory``
  (per-frame global_T_frame), with grey RGB (black without texture)."""
  def images():
    for T in trajectory:
      depth = render_planes(camera, T, plane_normals, plane_d,
                            raw_to_float_depth=raw_to_float_depth)
      rgb = (_grey_rgb(render_intensity(camera, T, depth, kind=texture_kind))
             if textured else np.zeros(depth.shape + (3,), np.uint8))
      yield rgb, depth
  return _in_memory_video(camera, images(), raw_to_float_depth, fps)


def make_heightmap_video(camera: PinholeCamera,
                         trajectory: List[np.ndarray],
                         z_distance: float = 1.0, z_variation: float = 0.05,
                         seed: int = 5,
                         raw_to_float_depth: float = 1.0 / 5000.0,
                         fps: float = 30.0) -> RGBDVideo:
  """In-memory RGBDVideo of the heightmap world along ``trajectory`` (dense
  texture and varied normals, so it tracks well), with grey RGB. The frames
  render on up to RENDER_WORKERS threads (numpy releases the interpreter
  lock), in order."""
  def image(T):
    depth, intensity = render_heightmap(
        camera, T, z_distance, z_variation, seed,
        raw_to_float_depth=raw_to_float_depth)
    return _grey_rgb(intensity), depth
  workers = max(1, min(RENDER_WORKERS, os.cpu_count() or 1, len(trajectory)))
  with concurrent.futures.ThreadPoolExecutor(workers) as pool:
    return _in_memory_video(camera, pool.map(image, trajectory),
                            raw_to_float_depth, fps)


class SyntheticKeyframe(NamedTuple):
  depth: torch.Tensor       # (H, W) preprocessed depth (0 invalid)
  normals: torch.Tensor     # (H, W, 2)
  radius_sq: torch.Tensor   # (H, W)
  intensity: torch.Tensor   # (H, W)
  rgb: torch.Tensor         # (H, W, 3) uint8


def preprocess_like_test_keyframe(depth: np.ndarray, camera: PinholeCamera,
                                  intensity: Optional[np.ndarray] = None,
                                  cell: int = 1) -> SyntheticKeyframe:
  """The original's test-keyframe pipeline (keyframe.cc:81-158) on the CPU:
  normals (which invalidate incomplete neighbourhoods), then radii and the
  removal of isolated pixels; no bilateral filter, zero deformation."""
  h, w = depth.shape
  d = torch.from_numpy(np.asarray(depth, np.float32))
  cfactor = torch.zeros(cfactor_shape(h, w, cell), dtype=torch.float32)
  d_n, nxy = depth_proc.compute_normals(d, camera, 0.0, cfactor, cell)
  radius_sq, d_out = depth_proc.compute_radii_and_remove_isolated(d_n, camera)
  if intensity is None:
    intensity_t = torch.zeros((h, w), dtype=torch.float32)
    rgb = torch.zeros((h, w, 3), dtype=torch.uint8)
  else:
    intensity_t = torch.from_numpy(np.asarray(intensity, np.float32))
    u8 = np.clip(np.floor(np.asarray(intensity) * 255.0 + 0.5), 0, 255
                 ).astype(np.uint8)
    rgb = torch.from_numpy(np.stack([u8, u8, u8], axis=-1))
  return SyntheticKeyframe(d_out, nxy, radius_sq, intensity_t, rgb)


def multi_view_plane_keyframes(
    camera: PinholeCamera, n_kf: int = 8, n_planes: int = 8, seed: int = 1,
    textured: bool = False, t_range: float = 0.3, texture_freq: float = 12.0,
    cell: int = 4) -> Iterator[Tuple[SyntheticKeyframe, np.ndarray]]:
  """The self-calibration tests' world (test_intrinsics_optimization_
  geometric_residual.cc:430-545 of the original): ``n_planes`` random
  planes 2.5 m away, seen by ``n_kf`` keyframes at poses scattered by up to
  ``t_range`` m and 0.1 rad. Yields (keyframe, global_T_frame). A large
  ``t_range`` makes the views span different distances, which is what makes
  fx and fy observable from descriptor residuals."""
  rng = np.random.default_rng(seed)
  normals = []
  for _ in range(n_planes):
    n = rng.uniform(-1, 1, 3).astype(np.float32)
    n[2] = -1.0
    normals.append(n / np.linalg.norm(n))
  normals = np.asarray(normals)
  for _ in range(n_kf):
    tangent = np.concatenate([rng.uniform(-t_range, t_range, 3),
                              rng.uniform(-0.1, 0.1, 3)]).astype(np.float32)
    T = se3.exp(torch.from_numpy(tangent)).numpy()
    depth = render_planes(camera, T, normals, raw_to_float_depth=1e-3,
                          max_depth=20.0)
    intensity = (render_intensity(camera, T, depth, freq=texture_freq)
                 if textured else None)
    yield preprocess_like_test_keyframe(depth, camera, intensity, cell), T


# Threads that render a dataset's frames (``tum_synth.write_tum_dataset``).
RENDER_WORKERS = 8

# The dataset writer lives in ``tum_synth``, which imports this module; its
# names are also reachable here, as the same function objects, for the
# callers that take them from this module (``tools/``).
_TUM_SYNTH_NAMES = ("straight_trajectory", "write_tum_dataset",
                    "write_tum_video")


def __getattr__(name):
  if name in _TUM_SYNTH_NAMES:
    from badslam_tpu_torch.utils import tum_synth
    return getattr(tum_synth, name)
  raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def surfel_map_error(positions: np.ndarray, z_distance: float = 1.0,
                     z_variation: float = 0.05, seed: int = 5,
                     boxes: Optional[np.ndarray] = None) -> dict:
  """Map-quality metric against the analytic heightmap world.

  The world is the graph of z(x, y) = heightmap_z(x, y), so every
  reconstructed surfel has a closed-form ground-truth surface point directly
  below or above it: error_i = pos_z_i - z(pos_x_i, pos_y_i). The slopes are
  small, so the vertical distance overestimates the point-to-surface
  distance by a few percent only. With ``boxes`` (the occlusion world) a
  surfel's error is its distance to the nearest surface, box or heightmap,
  with the heightmap term's sign.

  positions: (N, 3) world-frame positions of the valid surfels. Returns
  summary statistics in metres."""
  positions = np.asarray(positions, np.float64)
  if positions.size == 0:
    return {"count": 0}
  err = positions[:, 2] - heightmap_z(positions[:, 0], positions[:, 1],
                                      z_distance, z_variation, seed)
  if boxes is not None and len(boxes):
    abs_box = np.full(positions.shape[0], np.inf)
    for bmin, bmax in np.asarray(boxes, np.float64):
      q = np.maximum(np.maximum(bmin[None, :] - positions,
                                positions - bmax[None, :]), 0.0)
      outside = np.linalg.norm(q, axis=1)
      inside = np.minimum(np.min(positions - bmin[None, :], axis=1),
                          np.min(bmax[None, :] - positions, axis=1))
      d = np.where(outside > 0, outside, np.maximum(inside, 0.0))
      abs_box = np.minimum(abs_box, d)
    err = np.where(abs_box < np.abs(err), np.sign(err) * abs_box, err)
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
