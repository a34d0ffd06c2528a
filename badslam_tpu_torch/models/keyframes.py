"""Keyframe store: fixed-capacity batched image stacks + pose and metadata.

Port of ``badslam_tpu/models/keyframes.py`` (the Keyframe class,
keyframe.h:50-237 of the original BAD SLAM). All keyframes live in batched
tensors (K, H, W[, C]); activation states and the covisibility relation are
dense masks.

Activation states (keyframe.h:54-67):
  0 = inactive, 1 = covisible-active, 2 = active.

The store is a NamedTuple. The image stacks (7.1 MB per 640x480 keyframe)
are written in place: ``add_keyframe`` fills slot ``index`` of the stacks
it was given and returns a store that shares them. The small per-keyframe
vectors (pose, activation, covisibility, ...) are replaced by new tensors,
so a caller that keeps ``kf.global_T_frame`` keeps the old poses.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

INACTIVE = 0
COVISIBLE_ACTIVE = 1
ACTIVE = 2


class KeyframeStore(NamedTuple):
  # Image data (filtered but *uncalibrated* metric depth; the depth
  # deformation is applied on the fly, so self-calibration acts on all
  # keyframes retroactively).
  depth: torch.Tensor        # (K, H, W) float32, 0 = invalid
  normals: torch.Tensor      # (K, H, W, 2) float32 image-space normal x/y
  radius_sq: torch.Tensor    # (K, H, W) float32
  intensity: torch.Tensor    # (K, H, W) float32 in [0, 1]
  rgb: torch.Tensor          # (K, H, W, 3) uint8 (export, color voting)

  # Pose and metadata.
  global_T_frame: torch.Tensor  # (K, 4, 4) float32
  frame_index: torch.Tensor     # (K,) int32, source video frame
  min_depth: torch.Tensor       # (K,) float32
  max_depth: torch.Tensor       # (K,) float32
  valid: torch.Tensor           # (K,) bool
  activation: torch.Tensor      # (K,) int32 (states above)
  covis: torch.Tensor           # (K, K) bool, symmetric covisibility
  count: torch.Tensor           # () int32

  @property
  def capacity(self) -> int:
    return self.depth.shape[0]

  @property
  def image_shape(self):
    return self.depth.shape[1], self.depth.shape[2]

  @property
  def device(self) -> torch.device:
    return self.depth.device


_DTYPES = dict(depth=torch.float32, normals=torch.float32,
               radius_sq=torch.float32, intensity=torch.float32,
               rgb=torch.uint8, global_T_frame=torch.float32,
               frame_index=torch.int32, min_depth=torch.float32,
               max_depth=torch.float32, valid=torch.bool,
               activation=torch.int32, covis=torch.bool, count=torch.int32)


def create(capacity: int, height: int, width: int, device) -> KeyframeStore:
  def z(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype, device=device)

  k = capacity
  return KeyframeStore(
      depth=z((k, height, width)),
      normals=z((k, height, width, 2)),
      radius_sq=z((k, height, width)),
      intensity=z((k, height, width)),
      rgb=z((k, height, width, 3), torch.uint8),
      global_T_frame=torch.eye(4, device=device).repeat(k, 1, 1),
      frame_index=torch.full((k,), -1, dtype=torch.int32, device=device),
      min_depth=z((k,)),
      max_depth=z((k,)),
      valid=z((k,), torch.bool),
      activation=z((k,), torch.int32),
      covis=z((k, k), torch.bool),
      count=z((), torch.int32),
  )


def from_numpy(arrays: Dict[str, np.ndarray], device) -> KeyframeStore:
  """From host arrays named like the fields (e.g. the reference store's
  ``_asdict()`` through ``np.asarray``); dtypes are kept."""
  fields = {}
  for name, dtype in _DTYPES.items():
    t = torch.from_numpy(np.array(arrays[name])).to(device)
    if t.dtype != dtype:
      raise ValueError(f"{name}: {t.dtype}, expected {dtype}")
    fields[name] = t
  return KeyframeStore(**fields)


def to_numpy(kf: KeyframeStore) -> Dict[str, np.ndarray]:
  return {name: getattr(kf, name).cpu().numpy() for name in kf._fields}


def grow(kf: KeyframeStore, new_capacity: int) -> KeyframeStore:
  pad = new_capacity - kf.capacity
  assert pad >= 0

  def _pad(x, value=0):
    return torch.cat(
        [x, x.new_full((pad,) + x.shape[1:], value)], dim=0)

  covis = kf.covis.new_zeros((new_capacity, new_capacity))
  covis[:kf.capacity, :kf.capacity] = kf.covis
  return kf._replace(
      depth=_pad(kf.depth),
      normals=_pad(kf.normals),
      radius_sq=_pad(kf.radius_sq),
      intensity=_pad(kf.intensity),
      rgb=_pad(kf.rgb),
      global_T_frame=torch.cat(
          [kf.global_T_frame,
           torch.eye(4, device=kf.device).repeat(pad, 1, 1)], dim=0),
      frame_index=_pad(kf.frame_index, -1),
      min_depth=_pad(kf.min_depth),
      max_depth=_pad(kf.max_depth),
      valid=_pad(kf.valid),
      activation=_pad(kf.activation),
      covis=covis,
  )


def add_keyframe(
    kf: KeyframeStore,
    depth: torch.Tensor,
    normals: torch.Tensor,
    radius_sq: torch.Tensor,
    intensity: torch.Tensor,
    rgb: torch.Tensor,
    global_T_frame: torch.Tensor,
    frame_index: int,
    min_depth,
    max_depth,
    index: Optional[int] = None,
) -> KeyframeStore:
  """Insert at slot ``index`` (``kf.count``, read from the device when the
  caller has no host mirror of it). The caller ensures capacity. The image
  stacks are filled in place; see the module docstring."""
  i = int(kf.count) if index is None else index
  kf.depth[i] = depth
  kf.normals[i] = normals
  kf.radius_sq[i] = radius_sq
  kf.intensity[i] = intensity
  kf.rgb[i] = rgb

  def put(old, value):
    out = old.clone()
    out[i] = value
    return out

  return kf._replace(
      global_T_frame=put(kf.global_T_frame, global_T_frame),
      frame_index=put(kf.frame_index, frame_index),
      min_depth=put(kf.min_depth, min_depth),
      max_depth=put(kf.max_depth, max_depth),
      valid=put(kf.valid, True),
      activation=put(kf.activation, ACTIVE),
      count=kf.count + 1,
  )


def frustum_spheres(kf: KeyframeStore, fx_inv, fy_inv, cx_inv, cy_inv,
                    width: int, height: int):
  """(centers (K, 3), radii (K,)): for each slot, the sphere around the
  mean of its frustum's 8 corner points (the image corners at min and max
  depth) that contains them all."""
  dev = kf.device
  xs = torch.stack([torch.as_tensor(cx_inv, device=dev),
                    torch.as_tensor(width * fx_inv + cx_inv, device=dev)])
  ys = torch.stack([torch.as_tensor(cy_inv, device=dev),
                    torch.as_tensor(height * fy_inv + cy_inv, device=dev)])
  dirs = torch.stack([xs.repeat(2), ys.repeat_interleave(2),
                      torch.ones(4, device=dev)], dim=-1)          # (4, 3)
  pts = torch.cat([dirs[None] * kf.min_depth[:, None, None],
                   dirs[None] * kf.max_depth[:, None, None]], dim=1)
  R = kf.global_T_frame[:, 0:3, 0:3]
  t = kf.global_T_frame[:, 0:3, 3]
  pts_g = torch.einsum("kij,knj->kni", R, pts) + t[:, None, :]    # (K, 8, 3)
  centers = pts_g.mean(dim=1)
  radii = torch.linalg.norm(pts_g - centers[:, None, :], dim=-1).amax(dim=1)
  return centers, radii


def frustums_intersect(kf: KeyframeStore, i, j, fx_inv, fy_inv, cx_inv,
                       cy_inv, width: int, height: int) -> torch.Tensor:
  """Conservative frustum intersection test for covisibility
  (camera_frustum.h:225 via direct_ba.cc:233-247): each keyframe's frustum
  is bounded by a sphere, and frustums "intersect" when the spheres do.
  More permissive than a separating-axis test (extra covisible pairs only
  add work). ``i`` and ``j`` are slot indices, ints or index tensors that
  broadcast."""
  centers, radii = frustum_spheres(kf, fx_inv, fy_inv, cx_inv, cy_inv,
                                   width, height)
  return (torch.linalg.norm(centers[i] - centers[j], dim=-1)
          <= radii[i] + radii[j])
