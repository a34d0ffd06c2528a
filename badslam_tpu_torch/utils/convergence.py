"""Convergence analysis: per-iteration Gauss-Newton statistics, and the
convergence thresholds derived from them.

Port of ``badslam_tpu/utils/convergence.py`` (convergence_analysis.{h,cc}
of the original BAD SLAM). The original has a hidden data-gathering mode
(gather_convergence_samples_, direct_ba.h:537-538) that runs pose
estimation for a fixed number of iterations with no convergence test and
streams (update, cost) samples to a file; RunConvergenceAnalysis derives
from them the thresholds hard-coded in convergence_analysis.h:45-63. Here
the sampled loop keeps its history on the device and returns it to the
host once, at the end; the analysis is numpy.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import pose_opt


class ConvergenceSamples(NamedTuple):
  update_norm_sq: np.ndarray   # (I,) squared GN update norm of iteration i
  cost: np.ndarray             # (I,) robust cost BEFORE applying update i
  residual_count: np.ndarray   # (I,)


def gather_pose_samples(
    global_T_frame_init, surfels, kf_depth, kf_normals, kf_intensity,
    depth_cam, color_cam, dp, num_iterations: int = 100,
    use_depth_residuals: bool = True, use_descriptor_residuals: bool = True,
) -> ConvergenceSamples:
  """Frame-to-model pose GN for a fixed ``num_iterations`` with no
  convergence test, recording each iteration's statistics (the original's
  sample-gathering mode). A non-finite update is zeroed."""
  T = global_T_frame_init
  upd, costs, counts = [], [], []
  for _ in range(num_iterations):
    H, b, c, n = pose_opt.accumulate_pose_h_b(
        T, surfels, kf_depth, kf_normals, kf_intensity, depth_cam, color_cam,
        dp, use_depth_residuals, use_descriptor_residuals, compute_cost=True)
    x = pose_opt.solve_6x6(H, b)
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    T = T @ se3.exp(-x)
    upd.append(torch.sum(x * x))
    costs.append(c)
    counts.append(n)
  return ConvergenceSamples(torch.stack(upd).cpu().numpy(),
                            torch.stack(costs).cpu().numpy(),
                            torch.stack(counts).cpu().numpy())


def analyze_samples(samples: ConvergenceSamples,
                    relative_cost_tolerance: float = 1e-5) -> dict:
  """RunConvergenceAnalysis: the iteration after which the remaining
  relative cost improvement is under the tolerance, and the squared update
  observed there, the value for the IsScale*PoseEstimationConverged
  predicates."""
  cost = samples.cost
  final = cost[-1]
  initial = cost[0]
  denom = max(initial - final, 1e-30)
  remaining = (cost - final) / denom
  converged_at = int(np.argmax(remaining < relative_cost_tolerance))
  # cost[i] precedes update[i], so the update that reached cost[i] is
  # update[i - 1]: its norm is the threshold.
  thr_idx = max(converged_at - 1, 0)
  return {
      "converged_at_iteration": converged_at,
      "recommended_update_threshold_sq":
          float(samples.update_norm_sq[min(thr_idx, len(cost) - 1)]),
      "initial_cost": float(initial),
      "final_cost": float(final),
      "iterations": len(cost),
  }
