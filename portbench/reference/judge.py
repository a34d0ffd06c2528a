"""The comparison that decides ``correct``: what the timed path produced
against the scene's ground truth and the frozen preprocess chain.

Readings, each in its own unit:
  ate_rmse_m      the window frames' camera positions, after the
                  closed-form SE(3) alignment (Horn/Umeyama) of the
                  estimate onto the rendered poses, RMSE in metres
  ate_max_m       the same, the largest error
  rpe_rmse_m      frame-to-frame relative translation error, RMSE
  rot_rmse_deg    the frames' orientations against the rendered ones after
                  the alignment of whole poses (below), RMSE in degrees
  map_median_m    the live surfels, moved into the world by the alignment
                  of whole poses (the mean rotation and translation that
                  take the estimated poses onto the rendered ones, which
                  unlike a fit of positions alone holds where the window's
                  path is nearly straight), against the analytic surface:
                  median of |z - z(x, y)|
  map_p95_m       the same, the 95th percentile
  map_missing_share  the ground that the session's keyframes saw (their
                  rendered depth at their rendered poses, every
                  ``VIEW_STEP_PX``-th pixel) with no live surfel near it:
                  none in its own or the eight neighbouring cells of an x, y
                  grid as wide as the surfels' spacing (the sparse surfel
                  cell over fx, at the ground's median depth), the surfels
                  moved as for ``map_median_m``; a BA that makes or keeps
                  no surfels leaves it high where the accuracy of the few
                  it has cannot show
  kernel_max_abs  the preprocess kernel's three outputs on frames sampled
                  from the window against the plain chain, largest
                  absolute difference (inf where an output is not finite
                  or has another shape)
  lost_frames     window frames whose aligned error exceeds 1 cm

The limits file of a cell (``limits/<cell>.json``) names the readings that
are compared and their limits; ``correct`` holds where each is finite and
at most its limit. Plain numpy (float64) and the frozen chain; nothing of
the program is imported.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import preprocess, scene

LOST_FRAME_M = 0.01
VIEW_STEP_PX = 16


def umeyama_alignment(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
  """Least-squares rigid T (4, 4) with dst ~= T @ src (the closed form of
  ``loop/ransac.umeyama_alignment``, without scale)."""
  mu_s = src.mean(axis=0)
  mu_d = dst.mean(axis=0)
  xs = src - mu_s
  xd = dst - mu_d
  cov = xd.T @ xs / len(src)
  U, _, Vt = np.linalg.svd(cov)
  d = np.sign(np.linalg.det(U @ Vt))
  R = U @ np.diag([1.0, 1.0, d]) @ Vt
  T = np.eye(4)
  T[:3, :3] = R
  T[:3, 3] = mu_d - R @ mu_s
  return T


def pose_alignment(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
  """world_T_est (4, 4): the rotation nearest to the sum of the frames'
  gt R est R^T, and the mean translation that remains."""
  U, _, Vt = np.linalg.svd(
      np.einsum("nij,nkj->ik", gt[:, :3, :3], est[:, :3, :3]))
  R = U @ np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))]) @ Vt
  T = np.eye(4)
  T[:3, :3] = R
  T[:3, 3] = np.mean(gt[:, :3, 3] - est[:, :3, 3] @ R.T, axis=0)
  return T


def trajectory_readings(est: np.ndarray, gt: np.ndarray
                        ) -> Tuple[Dict[str, float], np.ndarray]:
  """Readings of the estimated poses ``est`` (N, 4, 4) against ``gt``, and
  the alignment of whole poses (4, 4) that maps the estimate's frame into
  the world."""
  est = np.asarray(est, np.float64)
  gt = np.asarray(gt, np.float64)
  if len(est) < 3 or not np.isfinite(est).all():
    return {"ate_rmse_m": math.inf, "ate_max_m": math.inf,
            "rpe_rmse_m": math.inf, "rot_rmse_deg": math.inf,
            "lost_frames": len(est)}, np.eye(4)
  T = umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
  aligned = est[:, :3, 3] @ T[:3, :3].T + T[:3, 3]
  err = np.linalg.norm(aligned - gt[:, :3, 3], axis=1)
  rel_e = np.linalg.inv(est[:-1]) @ est[1:]
  rel_g = np.linalg.inv(gt[:-1]) @ gt[1:]
  rpe = np.linalg.norm((np.linalg.inv(rel_g) @ rel_e)[:, :3, 3], axis=1)
  W = pose_alignment(est, gt)
  d = np.einsum("nji,jk,nkl->nil", gt[:, :3, :3], W[:3, :3], est[:, :3, :3])
  # |R - I|_F = 2 sqrt(2) sin(angle / 2), exact for small angles too.
  angle = 2.0 * np.arcsin(np.minimum(
      np.linalg.norm(d - np.eye(3), axis=(1, 2)) / (2.0 * np.sqrt(2.0)), 1.0))
  return {"ate_rmse_m": float(np.sqrt(np.mean(err ** 2))),
          "ate_max_m": float(err.max()),
          "rpe_rmse_m": float(np.sqrt(np.mean(rpe ** 2))),
          "rot_rmse_deg": float(np.degrees(np.sqrt(np.mean(angle ** 2)))),
          "lost_frames": int((err > LOST_FRAME_M).sum())}, W


def map_readings(positions: np.ndarray, world_T_est: np.ndarray,
                 world: scene.World, surface_z=scene.heightmap_z
                 ) -> Dict[str, float]:
  """Readings of the live surfels against the surface ``surface_z(x, y,
  world)`` (the mix's; by default the heightmap)."""
  positions = np.asarray(positions, np.float64).reshape(-1, 3)
  if len(positions) == 0 or not np.isfinite(positions).all():
    return {"map_median_m": math.inf, "map_p95_m": math.inf}
  p = positions @ world_T_est[:3, :3].T + world_T_est[:3, 3]
  err = np.abs(p[:, 2] - surface_z(p[:, 0], p[:, 1], world))
  return {"map_median_m": float(np.median(err)),
          "map_p95_m": float(np.quantile(err, 0.95))}


def map_missing_share(positions: np.ndarray, world_T_est: np.ndarray,
                      views: Sequence, camera, depth_scaling: float,
                      cell_px: int) -> Dict[str, float]:
  """``views``: (rendered global_T_frame, u16 depth counts) per keyframe of
  the session that the map must hold."""
  positions = np.asarray(positions, np.float64).reshape(-1, 3)
  if not views:
    return {}
  if len(positions) == 0 or not np.isfinite(positions).all():
    return {"map_missing_share": 1.0}
  rays = scene.pixel_rays(camera)[::VIEW_STEP_PX, ::VIEW_STEP_PX]
  ground = []
  for pose, counts in views:
    z = counts[::VIEW_STEP_PX, ::VIEW_STEP_PX].astype(np.float64) \
        / depth_scaling
    ok = z > 0
    pose = np.asarray(pose, np.float64)
    ground.append((rays[ok] * z[ok, None]) @ pose[:3, :3].T + pose[:3, 3])
  ground = np.concatenate(ground)
  surfels = positions @ world_T_est[:3, :3].T + world_T_est[:3, 3]
  depth = np.median(np.concatenate([c[c > 0] for _, c in views])) \
      / depth_scaling
  cell = cell_px * depth / camera.fx

  def keys(ix, iy):
    return ix * (1 << 32) + iy

  have = np.floor(surfels[:, :2] / cell).astype(np.int64)
  have = np.unique(keys(have[:, 0], have[:, 1]))
  q = np.floor(ground[:, :2] / cell).astype(np.int64)
  covered = np.zeros(len(q), bool)
  for dx in (-1, 0, 1):
    for dy in (-1, 0, 1):
      k = keys(q[:, 0] + dx, q[:, 1] + dy)
      at = np.minimum(np.searchsorted(have, k), len(have) - 1)
      covered |= have[at] == k
  return {"map_missing_share": float(1.0 - covered.mean())}


def kernel_readings(samples: Sequence, camera, config: dict, device
                    ) -> Dict[str, float]:
  """``samples``: (u16 depth counts, (filtered, normals, radius_sq) as the
  program's kernel returned them) per sampled frame."""
  worst = 0.0 if samples else math.inf
  for counts, outputs in samples:
    want = preprocess.preprocess(counts, camera, config, device)
    for got, ref in zip(outputs, want):
      if tuple(got.shape) != tuple(ref.shape) or not bool(
          torch.isfinite(got).all()):
        return {"kernel_max_abs": math.inf}
      worst = max(worst, float((got.to(ref.device) - ref).abs().max()))
  return {"kernel_max_abs": worst}


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
  """(correct, [(name, reading, limit)]) over the limits' readings."""
  rows = [(name, float(readings.get(name, math.inf)), float(limit))
          for name, limit in limits.items()]
  ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
  return ok, rows
