"""TUM RGB-D dataset loading and the RGBDVideo frame container.

Port of ``badslam_tpu/io/dataset.py`` without JAX: the same directory
layout (calibration.txt "fx fy cx cy" in the center convention,
associated.txt, depth/*.png 16-bit, rgb/*.png 8-bit, optional
groundtruth.txt), lazy per-frame image loading and a per-frame
``global_T_frame``. PNGs are decoded with Pillow.

``RGBDVideo.enable_prefetch`` takes the place of the reference's native
prefetching loader (PreLoadThread, main.cc:569): a small pool of threads
decodes the PNGs of the next frames while the frame loop works on the
current one (Pillow and zlib release the GIL while they decode). With
``pin_memory`` the decoded images also land in page-locked host memory, so
that the system copies them to the device without blocking the host.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
from PIL import Image

from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.geometry.camera import PinholeCamera


def _load_image(path: str) -> np.ndarray:
  with Image.open(path) as im:
    return np.asarray(im)


def _decode_rgb(path: str) -> np.ndarray:
  img = _load_image(path)
  if img.ndim == 2:
    img = np.stack([img] * 3, axis=-1)
  return img[..., :3].astype(np.uint8)


def _decode_depth(path: str) -> np.ndarray:
  return _load_image(path).astype(np.uint16)


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
  # Set by RGBDVideo.enable_prefetch: the prefetcher and this frame's index.
  _prefetcher: Optional["FramePrefetcher"] = dataclasses.field(
      default=None, repr=False, compare=False)
  _index: int = dataclasses.field(default=-1, repr=False, compare=False)
  # Page-locked (u8 RGB, depth as int16 bits) copies of the two images.
  _pinned: Optional[tuple] = dataclasses.field(
      default=None, repr=False, compare=False)

  def _fetch(self):
    if self._prefetcher is not None:
      self._rgb, self._depth, self._pinned = self._prefetcher.get(self._index)

  def rgb(self) -> np.ndarray:
    if self._rgb is None:
      self._fetch()
    if self._rgb is None:
      self._rgb = _decode_rgb(self.rgb_path)
    return self._rgb

  def depth_raw(self) -> np.ndarray:
    """Raw u16 depth image."""
    if self._depth is None:
      self._fetch()
    if self._depth is None:
      self._depth = _decode_depth(self.depth_path)
    return self._depth

  def pinned(self) -> Optional[tuple]:
    """The frame's images as page-locked tensors (u8 RGB (H, W, 3), u16
    depth as int16 bits (H, W)) where a prefetcher with ``pin_memory``
    decoded it, else None."""
    if self._rgb is None and self._depth is None:
      self._fetch()
    return self._pinned

  def clear_cache(self):
    self._rgb = None
    self._depth = None
    self._pinned = None


# The prefetcher decodes up to this many frames ahead, on this many threads.
PREFETCH_AHEAD = 4
PREFETCH_WORKERS = 2


class FramePrefetcher:
  """Decodes frames on a thread pool ahead of their use: a request for
  frame i returns its images and starts the decode of frames i+1 ..
  i+PREFETCH_AHEAD; a decode that is no longer in that window is
  dropped."""

  def __init__(self, frames: List[Frame], pin_memory: bool):
    self._frames = frames
    self._pin_memory = pin_memory
    self._pool = concurrent.futures.ThreadPoolExecutor(
        PREFETCH_WORKERS, thread_name_prefix="frame_prefetch")
    self._pending: Dict[int, concurrent.futures.Future] = {}
    self._lock = threading.Lock()

  def _decode(self, index: int):
    frame = self._frames[index]
    rgb = _decode_rgb(frame.rgb_path)
    depth = _decode_depth(frame.depth_path)
    pinned = None
    if self._pin_memory:
      import torch
      pinned = (torch.from_numpy(rgb).pin_memory(),
                torch.from_numpy(depth.view(np.int16)).pin_memory())
    return rgb, depth, pinned

  def get(self, index: int):
    """(rgb, depth, pinned or None) of frame ``index``."""
    with self._lock:
      window = range(index,
                     min(index + PREFETCH_AHEAD + 1, len(self._frames)))
      for i in list(self._pending):
        if i not in window:
          self._pending.pop(i).cancel()
      for i in window:
        if i not in self._pending:
          self._pending[i] = self._pool.submit(self._decode, i)
      future = self._pending.pop(index)
    return future.result()

  def close(self):
    """Stop the worker threads; frames decode on demand again."""
    with self._lock:
      for future in self._pending.values():
        future.cancel()
      self._pending.clear()
    self._pool.shutdown(wait=True)
    for frame in self._frames:
      if frame._prefetcher is self:
        frame._prefetcher = None


@dataclasses.dataclass
class RGBDVideo:
  """Frame list + cameras; color and depth share each frame's pose."""
  frames: List[Frame]
  color_camera: PinholeCamera
  depth_camera: PinholeCamera
  raw_to_float_depth: float = 1.0 / 5000.0
  _prefetcher: Optional[FramePrefetcher] = dataclasses.field(
      default=None, repr=False, compare=False)

  def frame_count(self) -> int:
    return len(self.frames)

  def enable_prefetch(self, pin_memory: bool = False) -> bool:
    """Decode the frames' PNGs on a thread pool before the frame loop needs
    them (``FramePrefetcher``); with ``pin_memory`` into page-locked
    memory too, for copies to a GPU. False (and nothing changes) where the
    frames are not PNG files on disk."""
    if not all(f.depth_path.lower().endswith(".png")
               and f.rgb_path.lower().endswith(".png") for f in self.frames):
      return False
    self.close_prefetch()
    self._prefetcher = FramePrefetcher(self.frames, pin_memory)
    for i, f in enumerate(self.frames):
      f._prefetcher, f._index = self._prefetcher, i
    return True

  def close_prefetch(self):
    """Stop the prefetcher's threads, if any."""
    if self._prefetcher is not None:
      self._prefetcher.close()
      self._prefetcher = None

  def fps(self, default: float = 30.0) -> float:
    """Frame rate from the depth timestamps (the median positive
    inter-frame delta). The loop-detection throttle derives its default
    frequency from it (bad_slam_config.h:367-370), not from a fixed 30."""
    if len(self.frames) < 2:
      return default
    ts = np.asarray([f.depth_timestamp for f in self.frames], np.float64)
    dt = np.diff(ts)
    dt = dt[dt > 0]
    if dt.size == 0:
      return default
    return float(1.0 / np.median(dt))


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
