"""The depth-sanity gate of the loop closure, on the device.

Port of ``alignment_depth_sanity`` and its two limits from
``badslam_tpu/loop/device_closure.py``. The rest of that module, the
pipelined front-end's closure as one device program, is not ported yet
(ROADMAP queue 1 item 10).

The gate goes beyond the original: it takes the mean |depth mismatch| of
the refined alignment, normalized by the propagated-stddev model sigma(z) =
z^2 / (baseline fx) (cost_function.cuh:81-88). A true closure refines to
mm-cm alignment (ratio <= ~0.2); a perceptual-aliasing match (identical
texture, different geometry) converges onto depth fields whose mismatch is
the scene's structure scale (~1.3-1.5 measured by the reference on its
aliasing world, where 10 of 388 aliased candidates otherwise passed RANSAC
and the three-way refinement gates).
"""

from __future__ import annotations

from typing import Tuple

import torch

DEPTH_SANITY_RATIO = 0.5
DEPTH_SANITY_MIN_OVERLAP = 200
MAX_DEPTH = 100.0   # depths at or beyond this are invalid on both sides


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
  """a * b + c of float32 tensors, rounded to float32 once."""
  return (a.double() * b.double() + c.double()).float()


def alignment_depth_sanity(cur_depth: torch.Tensor, old_depth: torch.Tensor,
                           old_T_cur: torch.Tensor, depth_intr: torch.Tensor,
                           baseline_fx: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
  """(mean |dz| / sigma(z), overlap count), both 0-d tensors, of warping
  cur's depth into the old keyframe under the refined relative pose, with
  nearest-neighbour sampling (a sanity gate, not a residual)."""
  h, w = cur_depth.shape
  dev = cur_depth.device
  fx, fy, cx, cy = depth_intr[0], depth_intr[1], depth_intr[2], depth_intr[3]
  ys, xs = torch.meshgrid(
      torch.arange(h, dtype=torch.float32, device=dev),
      torch.arange(w, dtype=torch.float32, device=dev), indexing="ij")
  z = cur_depth
  valid = (z > 0) & (z < MAX_DEPTH)
  px = (xs + 0.5 - cx) / fx * z
  py = (ys + 0.5 - cy) / fy * z
  p = torch.stack([px, py, z], dim=-1)
  q = p @ old_T_cur[:3, :3].T + old_T_cur[:3, 3]
  qz = q[..., 2]
  front = qz > 1e-3
  qzs = torch.where(front, qz, 1.0)
  # x / z * f + c is rounded once after the product and the sum, as the
  # reference's compiled program does with a fused multiply-add (float64
  # holds the product and the sum exactly): a one-ulp difference here moves
  # a pixel that lies on a rounding tie to its other neighbour.
  u = _fma32(q[..., 0] / qzs, fx, cx) - 0.5
  v = _fma32(q[..., 1] / qzs, fy, cy) - 0.5
  # torch.round rounds half to even, as jnp.round does.
  ui = torch.clamp(torch.round(u).to(torch.int64), 0, w - 1)
  vi = torch.clamp(torch.round(v).to(torch.int64), 0, h - 1)
  inb = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
  sampled = old_depth[vi, ui]
  ok = valid & front & inb & (sampled > 0) & (sampled < MAX_DEPTH)
  sigma = torch.clamp(sampled * sampled / baseline_fx, min=1e-4)
  ratio = torch.abs(qz - sampled) / sigma
  n = torch.sum(ok)
  mean_ratio = torch.sum(torch.where(ok, ratio, 0.0)) / torch.clamp(n, min=1)
  return mean_ratio, n
