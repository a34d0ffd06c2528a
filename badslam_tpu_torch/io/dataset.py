"""TUM RGB-D dataset loading and the RGBDVideo frame container.

Port of ``badslam_tpu/io/dataset.py`` without JAX: the same directory
layout (calibration.txt "fx fy cx cy" in the center convention,
associated.txt, depth/*.png 16-bit, rgb/*.png 8-bit, optional
groundtruth.txt), lazy per-frame image loading and a per-frame
``global_T_frame``. PNGs are decoded with Pillow. The native prefetching
loader of the reference is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
from PIL import Image

from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.geometry.camera import PinholeCamera


def _load_image(path: str) -> np.ndarray:
  with Image.open(path) as im:
    return np.asarray(im)


@dataclasses.dataclass
class Frame:
  """One RGB-D frame: lazy image access + pose."""
  rgb_path: str
  depth_path: str
  rgb_timestamp: float
  depth_timestamp: float
  global_T_frame: np.ndarray = dataclasses.field(
      default_factory=lambda: np.eye(4, dtype=np.float32))
  _rgb: Optional[np.ndarray] = None
  _depth: Optional[np.ndarray] = None

  def rgb(self) -> np.ndarray:
    if self._rgb is None:
      img = _load_image(self.rgb_path)
      if img.ndim == 2:
        img = np.stack([img] * 3, axis=-1)
      self._rgb = img[..., :3].astype(np.uint8)
    return self._rgb

  def depth_raw(self) -> np.ndarray:
    """Raw u16 depth image."""
    if self._depth is None:
      self._depth = _load_image(self.depth_path).astype(np.uint16)
    return self._depth

  def clear_cache(self):
    self._rgb = None
    self._depth = None


@dataclasses.dataclass
class RGBDVideo:
  """Frame list + cameras; color and depth share each frame's pose."""
  frames: List[Frame]
  color_camera: PinholeCamera
  depth_camera: PinholeCamera
  raw_to_float_depth: float = 1.0 / 5000.0

  def frame_count(self) -> int:
    return len(self.frames)


def read_tum_trajectory(path: str) -> Tuple[np.ndarray, np.ndarray]:
  """(timestamps (N,), poses (N, 4, 4) global_T_frame) of a TUM trajectory
  file 'ts tx ty tz qx qy qz qw'."""
  ts, poses = [], []
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line or line.startswith("#"):
        continue
      parts = line.split()
      if len(parts) < 8:
        raise ValueError(f"Cannot read pose line: {line}")
      tx, ty, tz, qx, qy, qz, qw = (float(v) for v in parts[1:8])
      T = np.eye(4, dtype=np.float32)
      T[:3, :3] = se3_np.quaternion_to_matrix([qx, qy, qz, qw])
      T[:3, 3] = [tx, ty, tz]
      ts.append(float(parts[0]))
      poses.append(T)
  return np.asarray(ts), np.asarray(poses)


def interpolate_pose(timestamp: float, ts: np.ndarray,
                     poses: np.ndarray) -> np.ndarray:
  """Slerp + lerp between the bracketing poses; clamps at the ends."""
  if timestamp <= ts[0]:
    return poses[0]
  if timestamp >= ts[-1]:
    return poses[-1]
  i = int(np.searchsorted(ts, timestamp, side="right")) - 1
  i = max(0, min(i, len(ts) - 2))
  factor = (timestamp - ts[i]) / (ts[i + 1] - ts[i])
  return se3_np.interpolate(poses[i], poses[i + 1], float(factor))


def _read_file_list(path: str):
  entries = []
  with open(path) as f:
    for line in f:
      line = line.strip()
      if not line or line.startswith("#"):
        continue
      parts = line.split()
      entries.append((float(parts[0]), parts[0], parts[1]))
  return entries


def _associate_rgb_depth(dataset_dir: str, max_diff: float = 0.02):
  """Greedy nearest-timestamp matching of rgb.txt and depth.txt entries."""
  rgb = _read_file_list(os.path.join(dataset_dir, "rgb.txt"))
  depth = _read_file_list(os.path.join(dataset_dir, "depth.txt"))
  if not rgb or not depth:
    raise FileNotFoundError(
        f"{dataset_dir}: neither associated.txt nor rgb.txt/depth.txt found")
  dts = np.asarray([d[0] for d in depth])
  used = set()
  lines = []
  for t, ts_str, rgb_file in rgb:
    j = int(np.argmin(np.abs(dts - t)))
    if abs(dts[j] - t) <= max_diff and j not in used:
      used.add(j)
      lines.append(f"{ts_str} {rgb_file} {depth[j][1]} {depth[j][2]}")
  return lines


def load_tum_dataset(dataset_dir: str,
                     trajectory_filename: Optional[str] = None,
                     raw_to_float_depth: float = 1.0 / 5000.0) -> RGBDVideo:
  """ReadTUMRGBDDatasetAssociatedAndCalibrated."""
  with open(os.path.join(dataset_dir, "calibration.txt")) as f:
    fx, fy, cx, cy = (float(v) for v in f.readline().split()[:4])

  pose_ts = pose_mats = None
  if trajectory_filename:
    pose_ts, pose_mats = read_tum_trajectory(
        os.path.join(dataset_dir, trajectory_filename))

  assoc_path = os.path.join(dataset_dir, "associated.txt")
  if os.path.exists(assoc_path):
    with open(assoc_path) as f:
      assoc_lines = [l.strip() for l in f]
  else:
    assoc_lines = _associate_rgb_depth(dataset_dir)
  frames: List[Frame] = []
  for line in assoc_lines:
    if not line or line.startswith("#"):
      continue
    rgb_ts, rgb_file, depth_ts, depth_file = line.split()[:4]
    frame = Frame(rgb_path=os.path.join(dataset_dir, rgb_file),
                  depth_path=os.path.join(dataset_dir, depth_file),
                  rgb_timestamp=float(rgb_ts),
                  depth_timestamp=float(depth_ts))
    if pose_ts is not None:
      frame.global_T_frame = interpolate_pose(
          frame.depth_timestamp, pose_ts, pose_mats).astype(np.float32)
    frames.append(frame)
  if not frames:
    raise ValueError(f"No frames in {assoc_path}")

  first = frames[0].rgb()
  height, width = first.shape[0], first.shape[1]
  frames[0].clear_cache()
  # calibration.txt is center-convention; storage is corner convention.
  cam = PinholeCamera(width=width, height=height, fx=fx, fy=fy,
                      cx=cx + 0.5, cy=cy + 0.5)
  return RGBDVideo(frames=frames, color_camera=cam, depth_camera=cam,
                   raw_to_float_depth=raw_to_float_depth)


def save_tum_trajectory(path: str, timestamps: List[float],
                        poses_global_T_frame: List[np.ndarray]):
  """TUM-format export 'ts tx ty tz qx qy qz qw'."""
  with open(path, "w") as f:
    for t, T in zip(timestamps, poses_global_T_frame):
      q = se3_np.matrix_to_quaternion(T[:3, :3])
      tr = T[:3, 3]
      f.write(f"{t} {tr[0]} {tr[1]} {tr[2]} {q[0]} {q[1]} {q[2]} {q[3]}\n")
