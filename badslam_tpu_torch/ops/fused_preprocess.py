"""Fused depth preprocess: the hand-written CUDA kernel and its plain version.

Port of ``badslam_tpu/ops/pallas_preprocess.py:fused_depth_preprocess``, the
reference's one Pallas kernel. One pass computes, per pixel:
  1. the inverse-depth bilateral filter with max-depth cutoff;
  2. calibrated depth and occlusion-aware normals (border and incomplete
     4-neighbourhoods invalid);
  3. the squared point radius on the uncalibrated stage-2 depth, with
     isolated-pixel removal.

``fused_depth_preprocess`` launches ``csrc/fused_preprocess.cu`` for a CUDA
tensor and raises if it cannot; for a CPU tensor it runs
``fused_depth_preprocess_reference``, the plain chain of ``ops/depth_proc``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import depth_proc
from badslam_tpu_torch.ops.depth_model import cfactor_shape

Outputs = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def fused_depth_preprocess_reference(
    raw_depth: torch.Tensor, calib: DepthCalibration, *, sigma_xy: float,
    sigma_inv_depth: float, radius_factor: float, max_depth: float
) -> Outputs:
  """The plain PyTorch chain: (filtered (H, W), normals (H, W, 2),
  radius_sq (H, W))."""
  cam = calib.camera()
  filtered = depth_proc.bilateral_filter_and_cutoff(
      raw_depth, sigma_xy=sigma_xy, sigma_inv_depth=sigma_inv_depth,
      radius_factor=radius_factor, max_depth=max_depth)
  filtered_b, normals = depth_proc.compute_normals(
      filtered, cam, calib.a, calib.cfactor, calib.cell_size)
  radius_sq, filtered_a = depth_proc.compute_radii_and_remove_isolated(
      filtered_b, cam)
  return filtered_a, normals, radius_sq


def _check(t: torch.Tensor, name: str, shape, device) -> None:
  if t.dtype != torch.float32:
    raise TypeError(f"{name}: expected float32, got {t.dtype}")
  if t.device != device:
    raise ValueError(f"{name}: on {t.device}, expected {device}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: not contiguous")


@functools.lru_cache(maxsize=None)
def _launcher():
  """The kernel's C entry point, built and declared once on first use
  (pointers as c_void_p, or ctypes would cut them to 32 bits)."""
  from badslam_tpu_torch.kernels import build
  fn = build.load("fused_preprocess").fused_depth_preprocess_launch
  vp, ci = ctypes.c_void_p, ctypes.c_int
  fn.argtypes = [vp] * 7 + [ci] * 5 + [ctypes.c_double, ctypes.c_float,
                                       ctypes.c_float, vp]
  fn.restype = ci
  return fn


def fused_depth_preprocess(
    raw_depth: torch.Tensor, calib: DepthCalibration, *, sigma_xy: float,
    sigma_inv_depth: float, radius_factor: float, max_depth: float
) -> Outputs:
  """(filtered (H, W), normals (H, W, 2), radius_sq (H, W)) of raw metric
  depth (H, W) f32, 0 = invalid. On a CUDA tensor: one launch of the
  hand-written kernel on the current stream, counted in
  ``fused_depth_preprocess.launches``. Every bilateral radius goes to the
  kernel: radius 3 to its unrolled instantiation, any other to the generic
  one."""
  if raw_depth.device.type == "cpu":
    return fused_depth_preprocess_reference(
        raw_depth, calib, sigma_xy=sigma_xy, sigma_inv_depth=sigma_inv_depth,
        radius_factor=radius_factor, max_depth=max_depth)
  if raw_depth.device.type != "cuda":
    raise ValueError(f"no kernel for device {raw_depth.device}")
  dev = raw_depth.device
  h, w = raw_depth.shape
  if (w, h) != calib.depth_size:
    raise ValueError(f"depth is {w}x{h}, calibration is for "
                     f"{calib.depth_size[0]}x{calib.depth_size[1]}")
  _check(raw_depth, "raw_depth", (h, w), dev)
  _check(calib.depth_intr, "depth_intr", (4,), dev)
  _check(calib.a, "a", (), dev)
  _check(calib.cfactor, "cfactor", cfactor_shape(h, w, calib.cell_size), dev)
  radius = int(radius_factor * sigma_xy + 0.5)

  launch = _launcher()
  filtered = torch.empty((h, w), dtype=torch.float32, device=dev)
  normals = torch.empty((h, w, 2), dtype=torch.float32, device=dev)
  radius_sq = torch.empty((h, w), dtype=torch.float32, device=dev)
  with torch.cuda.device(dev):
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = launch(
        raw_depth.data_ptr(), calib.depth_intr.data_ptr(),
        calib.a.data_ptr(), calib.cfactor.data_ptr(),
        filtered.data_ptr(), normals.data_ptr(), radius_sq.data_ptr(),
        h, w, calib.cfactor.shape[1], calib.cell_size, radius,
        2.0 * sigma_xy * sigma_xy,
        1.0 / (2.0 * sigma_inv_depth * sigma_inv_depth), max_depth, stream)
  if err != 0:
    raise RuntimeError(f"fused_depth_preprocess launch failed: CUDA error "
                       f"{err}")
  fused_depth_preprocess.launches += 1
  return filtered, normals, radius_sq


fused_depth_preprocess.launches = 0
