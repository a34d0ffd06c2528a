"""SE(3) Lie-group operations on torch tensors.

Port of ``badslam_tpu/geometry/se3.py``; the conventions are the same:

  * a transform is a (..., 4, 4) homogeneous matrix ``[[R, t], [0, 1]]``;
  * the tangent vector is ``[upsilon(3), omega(3)]``, translation first;
  * ``exp``/``log`` are the full SE(3) maps with the V matrix (as Sophus).

All functions are batched over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def hat_so3(omega: torch.Tensor) -> torch.Tensor:
  """Skew-symmetric matrix of (...,3) -> (...,3,3)."""
  ox, oy, oz = omega[..., 0], omega[..., 1], omega[..., 2]
  zeros = torch.zeros_like(ox)
  return torch.stack(
      [
          torch.stack([zeros, -oz, oy], dim=-1),
          torch.stack([oz, zeros, -ox], dim=-1),
          torch.stack([-oy, ox, zeros], dim=-1),
      ],
      dim=-2,
  )


def _eye3(like: torch.Tensor) -> torch.Tensor:
  return torch.eye(3, dtype=like.dtype, device=like.device).expand(
      like.shape[:-1] + (3, 3))


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
  """SO(3) exponential map: (...,3) -> (...,3,3) via Rodrigues' formula,
  with the series below theta = 0.1 (float32 cancellation, see the
  reference)."""
  theta_sq = torch.sum(omega * omega, dim=-1)
  theta = torch.sqrt(theta_sq + _EPS * _EPS)
  small = theta_sq < 1e-2
  a = torch.where(small, 1.0 - theta_sq / 6.0 + theta_sq * theta_sq / 120.0,
                  torch.sin(theta) / theta)
  b = torch.where(small, 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0,
                  (1.0 - torch.cos(theta)) / theta_sq)
  K = hat_so3(omega)
  return _eye3(omega) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
  """SO(3) logarithm: (...,3,3) -> (...,3), through the quaternion and
  ``theta = 2 atan2(|v|, w)``."""
  q = matrix_to_quaternion(R)
  v = q[..., 0:3]
  w = q[..., 3]
  sign = torch.where(w < 0, -1.0, 1.0)
  v = v * sign[..., None]
  w = w * sign
  v_norm = torch.linalg.norm(v, dim=-1)
  theta = 2.0 * torch.atan2(v_norm, w)
  small = v_norm < 1e-6
  scale = torch.where(
      small,
      2.0 / torch.clamp(w, min=0.5),
      theta / torch.where(small, torch.ones_like(v_norm), v_norm),
  )
  return scale[..., None] * v


def _so3_left_jacobian_terms(omega: torch.Tensor):
  theta_sq = torch.sum(omega * omega, dim=-1)
  theta = torch.sqrt(theta_sq + _EPS * _EPS)
  small = theta_sq < 1e-2
  sin_t = torch.sin(theta)
  cos_t = torch.cos(theta)
  b = torch.where(small, 0.5 - theta_sq / 24.0 + theta_sq * theta_sq / 720.0,
                  (1.0 - cos_t) / theta_sq)
  c = torch.where(
      small, 1.0 / 6.0 - theta_sq / 120.0 + theta_sq * theta_sq / 5040.0,
      (theta - sin_t) / (theta_sq * theta))
  return theta, theta_sq, small, sin_t, cos_t, b, c


def exp(tangent: torch.Tensor) -> torch.Tensor:
  """SE(3) exponential: (...,6) [upsilon, omega] -> (...,4,4)."""
  upsilon = tangent[..., 0:3]
  omega = tangent[..., 3:6]
  R = exp_so3(omega)
  _, _, _, _, _, b, c = _so3_left_jacobian_terms(omega)
  K = hat_so3(omega)
  V = _eye3(omega) + b[..., None, None] * K + c[..., None, None] * (K @ K)
  t = torch.einsum("...ij,...j->...i", V, upsilon)
  return make(R, t)


def log(T: torch.Tensor) -> torch.Tensor:
  """SE(3) logarithm: (...,4,4) -> (...,6) [upsilon, omega]."""
  R = T[..., 0:3, 0:3]
  t = T[..., 0:3, 3]
  omega = log_so3(R)
  theta, theta_sq, small, sin_t, cos_t, _, _ = _so3_left_jacobian_terms(omega)
  K = hat_so3(omega)
  denom = 2.0 * (1.0 - cos_t)
  coef = torch.where(
      small,
      1.0 / 12.0 + theta_sq / 720.0 + theta_sq * theta_sq / 30240.0,
      (1.0 - (theta * sin_t) / torch.where(small, torch.ones_like(denom),
                                           denom))
      / torch.where(small, torch.ones_like(theta_sq), theta_sq),
  )
  V_inv = _eye3(omega) - 0.5 * K + coef[..., None, None] * (K @ K)
  upsilon = torch.einsum("...ij,...j->...i", V_inv, t)
  return torch.cat([upsilon, omega], dim=-1)


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """Assemble (...,4,4) from rotation (...,3,3) and translation (...,3)."""
  batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
  R = R.expand(batch + (3, 3))
  t = t.expand(batch + (3,))
  top = torch.cat([R, t[..., :, None]], dim=-1)
  # The row [0, 0, 0, 1] is made on the device: a tensor built from a host
  # list would be a host-to-device copy, which waits for the stream.
  bottom = torch.cat([R.new_zeros(batch + (1, 3)), R.new_ones(batch + (1, 1))],
                     dim=-1)
  return torch.cat([top, bottom], dim=-2)


def inverse(T: torch.Tensor) -> torch.Tensor:
  R = T[..., 0:3, 0:3]
  t = T[..., 0:3, 3]
  Rt = R.transpose(-1, -2)
  return make(Rt, -torch.einsum("...ij,...j->...i", Rt, t))


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
  """Apply one (4, 4) transform to points (N, 3) or (3,)."""
  return points @ T[0:3, 0:3].T + T[0:3, 3]


def rotate(T: torch.Tensor, vectors: torch.Tensor) -> torch.Tensor:
  """Apply only the rotation of one (4, 4) transform to vectors (N, 3) or
  (3,)."""
  return vectors @ T[0:3, 0:3].T


# Newton steps of orthonormalize: from 1e-3 off orthonormal the error goes
# ~5e-7, ~1e-13, then float32 rounding; the fourth step is margin.
POLAR_NEWTON_STEPS = 4


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
  """Re-project the rotation block of (..., 4, 4) onto SO(3) (drift control
  after many compositions).

  The reference takes U V^T of the block's SVD. ``torch.linalg.svd`` on a
  GPU checks its result on the host, so this takes the same matrix, the
  polar factor of the block, by Newton's iteration R <- (R + R^-T) / 2 a
  fixed number of times: no host check, a few elementwise launches per
  step. The polar factor is unique for a block near a rotation, so it
  equals the SVD's up to rounding; the inverse transpose is the cofactor
  matrix over the determinant. The steps run in float64, so the result is
  the float32 rounding of the polar factor."""
  R = T[..., 0:3, 0:3].double()
  for _ in range(POLAR_NEWTON_STEPS):
    r0, r1, r2 = R[..., 0, :], R[..., 1, :], R[..., 2, :]
    cof = torch.stack([torch.linalg.cross(r1, r2), torch.linalg.cross(r2, r0),
                       torch.linalg.cross(r0, r1)], dim=-2)
    det = torch.sum(r0 * cof[..., 0, :], dim=-1)
    R = 0.5 * (R + cof / det[..., None, None])
  return make(R.to(T.dtype), T[..., 0:3, 3])


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
  """(...,3,3) -> (...,4) quaternion (x, y, z, w), TUM export order."""
  m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
  m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
  m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
  trace = m00 + m11 + m22

  def case(diag, cols):
    s = torch.sqrt(torch.clamp(diag, min=_EPS)) * 2.0
    return torch.stack([c(s) for c in cols], dim=-1)

  q0 = case(trace + 1.0, [lambda s: (m21 - m12) / s, lambda s: (m02 - m20) / s,
                          lambda s: (m10 - m01) / s, lambda s: 0.25 * s])
  q1 = case(1.0 + m00 - m11 - m22,
            [lambda s: 0.25 * s, lambda s: (m01 + m10) / s,
             lambda s: (m02 + m20) / s, lambda s: (m21 - m12) / s])
  q2 = case(1.0 + m11 - m00 - m22,
            [lambda s: (m01 + m10) / s, lambda s: 0.25 * s,
             lambda s: (m12 + m21) / s, lambda s: (m02 - m20) / s])
  q3 = case(1.0 + m22 - m00 - m11,
            [lambda s: (m02 + m20) / s, lambda s: (m12 + m21) / s,
             lambda s: 0.25 * s, lambda s: (m10 - m01) / s])
  cond1 = (trace > 0.0)[..., None]
  cond2 = ((m00 >= m11) & (m00 >= m22))[..., None]
  cond3 = (m11 >= m22)[..., None]
  q = torch.where(cond1, q0, torch.where(cond2, q1, torch.where(cond3, q2,
                                                                 q3)))
  return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
  """(...,4) quaternion (x, y, z, w) -> (...,3,3)."""
  q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
  x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
  xx, yy, zz = x * x, y * y, z * z
  xy, xz, yz = x * y, x * z, y * z
  wx, wy, wz = w * x, w * y, w * z
  return torch.stack(
      [
          torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
          torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
          torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
      ],
      dim=-2,
  )


def average_poses(T_list: torch.Tensor) -> torch.Tensor:
  """Average of (K, 4, 4) poses: the mean translation and the chordal mean
  rotation, by averaging quaternions aligned to the first one's hemisphere
  (AveragePose, util.cc:110 of the original)."""
  t = torch.mean(T_list[..., 0:3, 3], dim=0)
  qs = matrix_to_quaternion(T_list[..., 0:3, 0:3])
  signs = torch.where(torch.sum(qs * qs[0], dim=-1, keepdim=True) < 0,
                      -1.0, 1.0)
  q = torch.mean(qs * signs, dim=0)
  q = q / torch.linalg.norm(q)
  return make(quaternion_to_matrix(q), t)
