"""Gauss-Newton helpers shared by the pose solvers: the part odometry
reaches.

Port of ``badslam_tpu/models/pose_opt.py:34-57``. The frame-to-model pose
estimation itself comes with the BA slice.
"""

from __future__ import annotations

import torch

_TRANSLATION_CONVERGENCE_THRESHOLD = 1e-6
_ROTATION_SCALE = 10.0  # translation_threshold / rotation_threshold


def is_scale1_converged(x: torch.Tensor) -> torch.Tensor:
  """IsScale1PoseEstimationConverged (convergence_analysis.h:45-52)."""
  scale = torch.tensor([1.0, 1.0, 1.0, _ROTATION_SCALE, _ROTATION_SCALE,
                        _ROTATION_SCALE], dtype=x.dtype, device=x.device)
  scaled = x * scale
  return torch.sum(scaled * scaled) < _TRANSLATION_CONVERGENCE_THRESHOLD


def solve_6x6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """6x6 GN solve in float32 with Jacobi equilibration and 2 steps of
  iterative refinement. A plain f32 solve loses the weak direction of an
  ill-conditioned H (translation and rotation columns differ by the scene
  scale); the reference solves in double.

  ``solve_ex`` does not check the factorization, so a singular H gives a
  non-finite x (which the caller zeroes) instead of raising, and the solve
  never waits for the device."""
  d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
  s = 1.0 / d
  Hs = H * s[:, None] * s[None, :]
  bs = b * s
  y = torch.linalg.solve_ex(Hs, bs)[0]
  for _ in range(2):
    r = bs - Hs @ y
    y = y + torch.linalg.solve_ex(Hs, r)[0]
  return y * s
