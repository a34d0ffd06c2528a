"""The BA pose phase's hand-written CUDA kernels: every keyframe lane's H/b
in one launch, and the lanes' Gauss-Newton step in another.

``csrc/pose_h_b.cu`` holds both; ``models/pose_opt.py`` holds their plain
PyTorch versions (``accumulate_lanes_h_b_plain``, ``step_lanes_plain``) and
the shared loop that calls them (``estimate_frame_poses_batched``), which
takes the plain versions for CPU tensors and these launchers for CUDA
tensors. A launcher raises on a tensor it does not take, a CPU tensor
included; each counts its launches (``accumulate.launches``,
``step.launches``). ``off_tap_cell_edges`` and ``h_b_scales`` give what a
comparison of the accumulate kernel with its plain version needs (the
tests and ``chip_smoke.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops.depth_model import cfactor_shape

# The values a block sums per lane: H's upper triangle, b, the count.
SUMS = 28


def _check(t: torch.Tensor, name: str, shape, dtype, device) -> None:
  if t.device != device:
    raise ValueError(f"{name}: on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name}: not contiguous")


def _device(t: torch.Tensor) -> torch.device:
  if t.device.type != "cuda":
    raise ValueError(f"no pose_h_b kernel for device {t.device}")
  return t.device


@functools.lru_cache(maxsize=None)
def _library():
  """The kernels' C entry points, built and declared once on first use
  (pointers as c_void_p, or ctypes would cut them to 32 bits)."""
  from badslam_tpu_torch.kernels import build
  lib = build.load("pose_h_b")
  vp, ci = ctypes.c_void_p, ctypes.c_int
  lib.pose_h_b_blocks.argtypes = [ci]
  lib.pose_h_b_blocks.restype = ci
  lib.pose_h_b_accumulate_launch.argtypes = (
      [vp] * 6 + [ci] + [vp] * 5 + [ci] * 5 + [vp] * 5 + [ci] * 6
      + [vp] * 5 + [ci, vp])
  lib.pose_h_b_accumulate_launch.restype = ci
  lib.pose_h_b_step_launch.argtypes = [vp] * 6 + [ci, vp]
  lib.pose_h_b_step_launch.restype = ci
  return lib


def load_kernel() -> None:
  """Build the kernels' library if need be and load it now, ahead of the
  first launch (``BadSlam.prewarm``); raises if either fails."""
  _library()


def blocks(capacity: int, device: torch.device) -> int:
  """The accumulate launch's grid for a surfel capacity on ``device``: the
  partial rows per lane its scratch must hold."""
  with torch.cuda.device(device):
    n = _library().pose_h_b_blocks(int(capacity))
  if n < 1:
    raise RuntimeError("pose_h_b: the device query failed")
  return n


def _stream(device: torch.device) -> int:
  return torch.cuda.current_stream(device).cuda_stream


def accumulate(T: torch.Tensor, done: torch.Tensor, surfels: SurfelStore,
               kf_depth: torch.Tensor, kf_normals: torch.Tensor,
               kf_intensity: torch.Tensor, depth_intr: torch.Tensor,
               color_intr: torch.Tensor, color_size: Tuple[int, int],
               dp: DepthCalibration, use_depth_residuals: bool,
               use_descriptor_residuals: bool, out: Tuple[torch.Tensor, ...],
               partials: torch.Tensor, ticket: torch.Tensor) -> None:
  """One launch: H (K, 6, 6), b (K, 6) and the residual count (K,) of every
  lane that ``done`` leaves open, at the lanes' poses ``T`` (K, 4, 4),
  written into ``out`` = (H, b, count); the rows of done lanes are left as
  they were. ``partials`` (blocks, K, 28) float32 and ``ticket`` () int32,
  zero, are the launch's scratch (``blocks``); the launch leaves the ticket
  at zero."""
  dev = _device(T)
  k = T.shape[0]
  n = surfels.capacity
  h, w = kf_depth.shape[1:]
  hi, wi = kf_intensity.shape[1:]
  f32 = torch.float32
  _check(T, "T", (k, 4, 4), f32, dev)
  _check(done, "done", (k,), torch.bool, dev)
  for name, shape in (("pos", (n, 3)), ("normal", (n, 3)),
                      ("radius_sq", (n,)), ("desc", (n, 2))):
    _check(getattr(surfels, name), name, shape, f32, dev)
  _check(surfels.valid, "valid", (n,), torch.bool, dev)
  _check(surfels.count, "count", (), torch.int32, dev)
  _check(kf_depth, "kf_depth", (k, h, w), f32, dev)
  _check(kf_normals, "kf_normals", (k, h, w, 2), f32, dev)
  _check(kf_intensity, "kf_intensity", (k, hi, wi), f32, dev)
  _check(depth_intr, "depth_intr", (4,), f32, dev)
  _check(color_intr, "color_intr", (4,), f32, dev)
  _check(dp.a, "a", (), f32, dev)
  _check(dp.baseline_fx, "baseline_fx", (), f32, dev)
  _check(dp.cfactor, "cfactor", cfactor_shape(h, w, dp.cell_size), f32, dev)
  H, b, count = out
  _check(H, "H", (k, 6, 6), f32, dev)
  _check(b, "b", (k, 6), f32, dev)
  _check(count, "count_out", (k,), torch.int32, dev)
  grid = blocks(n, dev)
  _check(partials, "partials", (grid, k, SUMS), f32, dev)
  _check(ticket, "ticket", (), torch.int32, dev)

  lib = _library()
  with torch.cuda.device(dev):
    err = lib.pose_h_b_accumulate_launch(
        surfels.pos.data_ptr(), surfels.normal.data_ptr(),
        surfels.radius_sq.data_ptr(), surfels.desc.data_ptr(),
        surfels.valid.data_ptr(), surfels.count.data_ptr(), n,
        T.data_ptr(), done.data_ptr(), kf_depth.data_ptr(),
        kf_normals.data_ptr(), kf_intensity.data_ptr(),
        k, h, w, hi, wi,
        depth_intr.data_ptr(), color_intr.data_ptr(), dp.a.data_ptr(),
        dp.cfactor.data_ptr(), dp.baseline_fx.data_ptr(),
        dp.cfactor.shape[1], dp.cell_size, color_size[0], color_size[1],
        int(use_depth_residuals), int(use_descriptor_residuals),
        partials.data_ptr(), ticket.data_ptr(), H.data_ptr(), b.data_ptr(),
        count.data_ptr(), grid, _stream(dev))
  if err != 0:
    raise RuntimeError(f"pose_h_b accumulate launch failed: CUDA error "
                       f"{err}")
  accumulate.launches += 1


def step(T: torch.Tensor, done: torch.Tensor, H: torch.Tensor,
         b: torch.Tensor, state: torch.Tensor,
         all_done: torch.Tensor) -> None:
  """One launch: the Gauss-Newton step of every open lane, in place on
  ``T`` and ``done``; ``state`` (2,) int32 becomes (lanes open after the
  step, lane steps so far: the lanes open at each step, summed) and
  ``all_done`` () bool whether no lane is open."""
  dev = _device(T)
  k = T.shape[0]
  f32 = torch.float32
  _check(T, "T", (k, 4, 4), f32, dev)
  _check(done, "done", (k,), torch.bool, dev)
  _check(H, "H", (k, 6, 6), f32, dev)
  _check(b, "b", (k, 6), f32, dev)
  _check(state, "state", (2,), torch.int32, dev)
  _check(all_done, "all_done", (), torch.bool, dev)
  with torch.cuda.device(dev):
    err = _library().pose_h_b_step_launch(
        T.data_ptr(), done.data_ptr(), H.data_ptr(), b.data_ptr(),
        state.data_ptr(), all_done.data_ptr(), k, _stream(dev))
  if err != 0:
    raise RuntimeError(f"pose_h_b step launch failed: CUDA error {err}")
  step.launches += 1


accumulate.launches = 0
step.launches = 0


def off_tap_cell_edges(T: torch.Tensor, surfels: SurfelStore,
                       depth: torch.Tensor, normals: torch.Tensor,
                       depth_cam: PinholeCamera, color_cam: PinholeCamera,
                       dp: DepthCalibration,
                       margin: float = 1e-3) -> torch.Tensor:
  """(N,) bool: surfels whose three descriptor sample points (the center
  and the two tangent points) in the image of the keyframe at ``T`` (4, 4)
  lie more than ``margin`` px from an edge of their bilinear tap cell. At
  an edge the intensity is continuous but its gradient jumps, and the
  kernel and cuBLAS round the surfel's transform differently, so a point
  within an ulp of an edge may take its gradient from either side. A
  surfel created from a keyframe projects onto that keyframe's pixel
  centers, which are such edges."""
  frame_T_global = se3.inverse(T)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global, depth,
      normals, depth_cam, dp)
  center, _ = DepthToColorTransform.between(depth_cam, color_cam).apply(
      assoc.pxy)
  t1, t2 = cost.tangent_projections(
      surfels.pos, surfels.normal, surfels.radius_sq,
      frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
  ok = torch.ones_like(surfels.valid)
  for p in (center, t1, t2):
    frac = (p - 0.5) - torch.floor(p - 0.5)
    ok &= ((frac > margin) & (frac < 1.0 - margin)).all(dim=-1)
  return ok


def h_b_scales(T: torch.Tensor, surfels: SurfelStore, depth: torch.Tensor,
               normals: torch.Tensor, intensity: torch.Tensor,
               depth_cam: PinholeCamera, color_cam: PinholeCamera,
               dp: DepthCalibration, use_depth: bool,
               use_desc: bool) -> Tuple[torch.Tensor, torch.Tensor]:
  """For the keyframe at ``T``, the largest over the entries of H, and of
  b, of the sum of the magnitudes of the entry's summands over the
  keyframe's residuals, |J_i w| |J_j| and |J_i w| |r| (as
  ``accumulate_pose_h_b`` forms them), in float64 on the host: the scale
  of a sum's rounding, which cancellation can leave far above the sum
  itself (b of a keyframe at its optimum is near zero)."""
  frame_T_global = se3.inverse(T)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global, depth,
      normals, depth_cam, dp)
  terms = []
  if use_depth:
    unproj = depth_cam.unproject_center(
        assoc.px.to(torch.float32), assoc.py.to(torch.float32),
        assoc.calibrated_depth)
    r = cost.raw_depth_residual(unproj, assoc.local_pos, assoc.local_normal,
                                assoc.inv_stddev)
    terms.append((cost.depth_residual_pose_jacobian(
        unproj, assoc.local_normal, assoc.inv_stddev), r,
                  cost.depth_weight(r), assoc.mask))
  if use_desc:
    center, in_color = DepthToColorTransform.between(
        depth_cam, color_cam).apply(assoc.pxy)
    t1, t2 = cost.tangent_projections(
        surfels.pos, surfels.normal, surfels.radius_sq,
        frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
    r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
        intensity, center, t1, t2, surfels.desc)
    for r, gx, gy in ((r1, gx1, gy1), (r2, gx2, gy2)):
      terms.append((cost.projected_position_pose_jacobian(
          gx * color_cam.fx, gy * color_cam.fy, assoc.local_pos), r,
                    cost.descriptor_weight(r), assoc.mask & in_color))
  scale_H = torch.zeros((6, 6), dtype=torch.float64)
  scale_b = torch.zeros((6,), dtype=torch.float64)
  for J, r, w, mask in terms:
    J = torch.where(mask[:, None], J, 0.0).double().abs().cpu()
    w = torch.where(mask, w, 0.0).double().abs().cpu()
    r = torch.where(mask, r, 0.0).double().abs().cpu()
    scale_H += (J * w[:, None]).T @ J
    scale_b += (J * w[:, None]).T @ r
  return scale_H.max(), scale_b.max()
