"""Robust loss functions (Tukey biweight, Huber).

Port of ``badslam_tpu/ops/robust.py`` (robust_weighting.cuh:39-86 of the
original BAD SLAM), in branchless form.
"""

from __future__ import annotations

import torch


def tukey_residual(raw_residual: torch.Tensor,
                   tukey_parameter: float) -> torch.Tensor:
  """rho(r) for the Tukey biweight."""
  quot = raw_residual / tukey_parameter
  term = 1.0 - quot * quot
  inside = (1.0 / 6.0) * tukey_parameter * tukey_parameter * (
      1.0 - term * term * term)
  outside = (1.0 / 6.0) * tukey_parameter * tukey_parameter
  return torch.where(torch.abs(raw_residual) < tukey_parameter, inside,
                     outside)


def tukey_weight(raw_residual: torch.Tensor,
                 tukey_parameter: float) -> torch.Tensor:
  """IRLS weight = rho'(r)/r."""
  quot = raw_residual / tukey_parameter
  term = 1.0 - quot * quot
  return torch.where(torch.abs(raw_residual) < tukey_parameter, term * term,
                     0.0)


def huber_residual(raw_residual: torch.Tensor,
                   huber_parameter: float) -> torch.Tensor:
  """rho(r) for Huber."""
  abs_r = torch.abs(raw_residual)
  return torch.where(abs_r < huber_parameter,
                     0.5 * raw_residual * raw_residual,
                     huber_parameter * (abs_r - 0.5 * huber_parameter))


def huber_weight(raw_residual: torch.Tensor,
                 huber_parameter: float) -> torch.Tensor:
  """IRLS weight."""
  abs_r = torch.abs(raw_residual)
  return torch.where(abs_r < huber_parameter, 1.0,
                     huber_parameter / torch.clamp(abs_r, min=1e-30))
