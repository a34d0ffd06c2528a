"""Host-side (numpy) SE(3) helpers for per-frame pose bookkeeping.

Port of ``badslam_tpu/geometry/se3_np.py`` (which cannot be imported without
JAX because its package pins JAX's matmul precision). The motion model and
keyframe rebasing compose single 4x4 poses on the host; plain numpy keeps
that off the device stream.
"""

from __future__ import annotations

import numpy as np

_EPS = 1e-12


def inverse(T: np.ndarray) -> np.ndarray:
  """Inverse of a rigid transform (R.T, -R.T t)."""
  T = np.asarray(T, np.float32)
  R = T[..., 0:3, 0:3]
  t = T[..., 0:3, 3]
  Rt = np.swapaxes(R, -1, -2)
  out = np.zeros_like(T)
  out[..., 0:3, 0:3] = Rt
  out[..., 0:3, 3] = -(Rt @ t[..., None])[..., 0]
  out[..., 3, 3] = 1.0
  return out


def orthonormalize(T: np.ndarray) -> np.ndarray:
  """Re-project the rotation block onto SO(3) (nearest rotation, via SVD).

  Applied at every host composition: the constant-velocity motion model
  squares the last relative pose every frame, and the tracker preserves any
  defect of its init, so float32 roundoff otherwise doubles ||R^T R - I||
  per frame (measured divergence by frame 17 in the reference; PERF.md
  "Odometry accuracy")."""
  T = np.asarray(T, np.float32)
  u, _, vt = np.linalg.svd(T[0:3, 0:3].astype(np.float64))
  d = np.sign(np.linalg.det(u @ vt))
  R = (u * np.array([1.0, 1.0, d])) @ vt
  return make(R.astype(np.float32), T[0:3, 3])


def make(R: np.ndarray, t: np.ndarray) -> np.ndarray:
  out = np.zeros(R.shape[:-2] + (4, 4), np.float32)
  out[..., 0:3, 0:3] = R
  out[..., 0:3, 3] = t
  out[..., 3, 3] = 1.0
  return out


def matrix_to_quaternion(R: np.ndarray) -> np.ndarray:
  """(3,3) -> (4,) quaternion (x, y, z, w); branch-robust Shepperd method."""
  R = np.asarray(R, np.float64)
  m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
  m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
  m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
  trace = m00 + m11 + m22
  if trace > 0.0:
    s = np.sqrt(max(trace + 1.0, _EPS)) * 2.0
    q = np.array([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                  0.25 * s])
  elif m00 >= m11 and m00 >= m22:
    s = np.sqrt(max(1.0 + m00 - m11 - m22, _EPS)) * 2.0
    q = np.array([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                  (m21 - m12) / s])
  elif m11 >= m22:
    s = np.sqrt(max(1.0 + m11 - m00 - m22, _EPS)) * 2.0
    q = np.array([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                  (m02 - m20) / s])
  else:
    s = np.sqrt(max(1.0 + m22 - m00 - m11, _EPS)) * 2.0
    q = np.array([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                  (m10 - m01) / s])
  return q / np.linalg.norm(q)


def quaternion_to_matrix(q: np.ndarray) -> np.ndarray:
  q = np.asarray(q, np.float64)
  q = q / np.linalg.norm(q)
  x, y, z, w = q
  return np.array([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ])


def slerp(q0: np.ndarray, q1: np.ndarray, alpha: float) -> np.ndarray:
  dot = float(np.dot(q0, q1))
  if dot < 0.0:
    q1 = -q1
    dot = -dot
  theta = np.arccos(np.clip(dot, -1.0, 1.0))
  sin_theta = np.sin(theta)
  if sin_theta < 1e-6:
    w0, w1 = 1.0 - alpha, alpha
  else:
    w0 = np.sin((1.0 - alpha) * theta) / sin_theta
    w1 = np.sin(alpha * theta) / sin_theta
  q = w0 * q0 + w1 * q1
  return q / np.linalg.norm(q)


def average_poses(T_list: np.ndarray) -> np.ndarray:
  """Average of (K, 4, 4) poses: the mean translation and the chordal mean
  rotation, by averaging hemisphere-aligned quaternions (AveragePose,
  util.cc:110 of the original)."""
  T_list = np.asarray(T_list, np.float32)
  t = T_list[:, 0:3, 3].mean(axis=0)
  qs = np.stack([matrix_to_quaternion(T[0:3, 0:3]) for T in T_list])
  signs = np.where(qs @ qs[0] < 0, -1.0, 1.0)
  q = (qs * signs[:, None]).mean(axis=0)
  q = q / np.linalg.norm(q)
  return make(quaternion_to_matrix(q).astype(np.float32), t)


def interpolate(T0: np.ndarray, T1: np.ndarray, alpha: float) -> np.ndarray:
  """Pose interpolation: slerp on rotation + lerp on translation."""
  T0 = np.asarray(T0, np.float32)
  T1 = np.asarray(T1, np.float32)
  q = slerp(matrix_to_quaternion(T0[0:3, 0:3]),
            matrix_to_quaternion(T1[0:3, 0:3]), alpha)
  t = (1.0 - alpha) * T0[0:3, 3] + alpha * T1[0:3, 3]
  return make(quaternion_to_matrix(q).astype(np.float32),
              t.astype(np.float32))
