"""3D-3D alignment: Umeyama/Horn absolute orientation and RANSAC.

The port's own copy of ``badslam_tpu/loop/ransac.py``: it stands in for
opengv's PointCloudSacProblem of the original's loop-closure verification
(loop_detector.cc:284-360: threshold 0.06, at most 500 iterations, >= 10
inliers). Host numpy; the random generator is passed in.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False) -> np.ndarray:
  """Least-squares transform T (4, 4) with dst ~= T @ src (the Horn/Umeyama
  closed form): rigid, or a similarity with ``with_scale``."""
  mu_s = src.mean(axis=0)
  mu_d = dst.mean(axis=0)
  xs = src - mu_s
  xd = dst - mu_d
  cov = xd.T @ xs / len(src)
  U, S, Vt = np.linalg.svd(cov)
  d = np.sign(np.linalg.det(U @ Vt))
  D = np.diag([1.0, 1.0, d])
  R = U @ D @ Vt
  c = np.trace(np.diag(S) @ D) / ((xs ** 2).sum() / len(src)) \
      if with_scale else 1.0
  T = np.eye(4)
  T[:3, :3] = c * R
  T[:3, 3] = mu_d - c * R @ mu_s
  return T


def ransac_3d3d(
    src: np.ndarray,       # (N, 3) points in frame A
    dst: np.ndarray,       # (N, 3) corresponding points in frame B
    rng: np.random.Generator,
    threshold: float = 0.06,
    max_iterations: int = 500,
    min_inliers: int = 10,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
  """(B_T_A (4, 4) float32 or None, inlier mask)."""
  n = len(src)
  if n < 3:
    return None, np.zeros(n, bool)

  best_inliers = np.zeros(n, bool)
  best_count = 0
  for _ in range(max_iterations):
    idx = rng.choice(n, size=3, replace=False)
    s, d = src[idx], dst[idx]
    # A (nearly) collinear sample defines no rotation.
    if np.linalg.norm(np.cross(s[1] - s[0], s[2] - s[0])) < 1e-9:
      continue
    T = umeyama_alignment(s, d)
    err = np.linalg.norm(dst - (src @ T[:3, :3].T + T[:3, 3]), axis=1)
    inliers = err < threshold
    count = int(inliers.sum())
    if count > best_count:
      best_count = count
      best_inliers = inliers
      if count == n:
        break

  if best_count < min_inliers:
    return None, best_inliers
  # Refit on all inliers, re-select them, refit once more.
  T = umeyama_alignment(src[best_inliers], dst[best_inliers])
  err = np.linalg.norm(dst - (src @ T[:3, :3].T + T[:3, 3]), axis=1)
  best_inliers = err < threshold
  if int(best_inliers.sum()) < min_inliers:
    return None, best_inliers
  T = umeyama_alignment(src[best_inliers], dst[best_inliers])
  return T.astype(np.float32), best_inliers
