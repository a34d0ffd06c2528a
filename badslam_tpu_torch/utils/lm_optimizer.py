"""Generic Levenberg-Marquardt optimizer.

Port of ``badslam_tpu/utils/lm_optimizer.py``, the counterpart of libvis's
templated LMOptimizer (lm_optimizer.h, exercised by libvis's curve-fitting
tests). The SLAM path does not use it (it has its own solvers); it serves
calibration-style side problems.

  result = lm_minimize(residual_fn, x0, max_iterations=50)
  # residual_fn: params (P,) -> residuals (R,); minimizes sum(r^2).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class LMResult(NamedTuple):
  params: torch.Tensor
  cost: torch.Tensor          # final 0.5 * sum(r^2)
  iterations: int
  converged: bool


def lm_minimize(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    max_iterations: int = 50,
    initial_lambda: float = 1e-4,
    update_tolerance: float = 1e-10,
) -> LMResult:
  """Dense LM with multiplicative damping (lm_optimizer.h semantics: lambda
  halved on success and doubled on failure, converged when the squared
  update norm falls under ``update_tolerance``). The Jacobian comes from
  ``torch.func.jacfwd``, in float32 on ``x0``'s device.

  A side utility: the loop reads the convergence flag on the host once per
  iteration, which waits for the device."""

  def cost_of(x):
    r = residual_fn(x)
    return 0.5 * torch.sum(r * r)

  x = torch.as_tensor(x0, dtype=torch.float32)
  lam = torch.tensor(initial_lambda, dtype=torch.float32, device=x.device)
  iterations = 0
  converged = False
  while iterations < max_iterations and not converged:
    r = residual_fn(x)
    J = torch.func.jacfwd(residual_fn)(x)
    H = J.T @ J
    g = J.T @ r
    H_damped = H + lam * torch.diag(torch.clamp(torch.diagonal(H),
                                                min=1e-12))
    dx = torch.linalg.solve_ex(H_damped, -g)[0]
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    improved = cost_of(x + dx) < cost_of(x)
    x = torch.where(improved, x + dx, x)
    lam = torch.where(improved, lam * 0.5, lam * 2.0)
    # Converged when the step, taken or not, is tiny: at an exact optimum
    # no step improves, but the solve still returns an update near 0.
    converged = bool(torch.sum(dx * dx) < update_tolerance)
    iterations += 1
  return LMResult(params=x, cost=cost_of(x), iterations=iterations,
                  converged=converged)
