"""Pose-graph optimization on SE(3).

Port of ``badslam_tpu/loop/pose_graph.py``, which stands in for the
original's thin g2o wrapper (pose_graph_optimizer.{h,cc}): a vertex per
keyframe, odometry edges from the current relative poses, the loop edges,
identity information, vertex 0 fixed.

The graph is small (a few hundred 6-vectors at most), so it is solved as
plain tensor code on the system's device, in float32 as the reference does:
20 Levenberg-Marquardt steps over the stacked pose tangents. The residual of
an edge is r_e = w_e log(Z_ij^-1 T_i^-1 T_j) with T_k = T_k0 exp(x_k); the
full Jacobian (6E x 6K) comes from forward-mode differentiation
(``torch.func.jacfwd``) of the port's ``se3.exp``/``log``, and the normal
equations are solved densely. A step is kept or dropped with
``torch.where``, so the 20 steps read nothing back to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3


def optimize_poses(T0: torch.Tensor, edges_i: torch.Tensor,
                   edges_j: torch.Tensor, edges_Z: torch.Tensor,
                   edge_weight: torch.Tensor,
                   num_iterations: int = 20) -> torch.Tensor:
  """LM on the pose-graph edges. T0 (K, 4, 4); vertex 0 is the gauge.
  Returns the optimized (K, 4, 4) poses."""
  k = T0.shape[0]
  Z_inv = se3.inverse(edges_Z)

  def residuals(x):
    T = T0 @ se3.exp(x)
    e = se3.log(Z_inv @ se3.inverse(T[edges_i]) @ T[edges_j])
    r = (edge_weight[:, None] * e).reshape(-1)
    return r, r

  jacobian = torch.func.jacfwd(residuals, has_aux=True)
  x = torch.zeros((k, 6), dtype=torch.float32, device=T0.device)
  lm_lambda = torch.full((), 1e-4, dtype=torch.float32, device=T0.device)
  ones = torch.ones(6 * k, dtype=torch.float32, device=T0.device)
  gauge = torch.arange(6 * k, device=T0.device) < 6
  for _ in range(num_iterations):
    J, r = jacobian(x)
    J = J.reshape(r.shape[0], k * 6)
    H = J.T @ J
    b = J.T @ r
    # Gauge: vertex 0's rows and columns are zeroed, its diagonal set to 1.
    H = torch.where(gauge[:, None] | gauge[None, :], 0.0, H)
    H = H + torch.diag(torch.where(gauge, ones, lm_lambda * ones))
    b = torch.where(gauge, 0.0, b)
    dx = torch.linalg.solve_ex(H, -b[:, None]).result[:, 0].reshape(k, 6)
    dx = torch.where(torch.isfinite(dx), dx, 0.0)
    x_new = x + dx
    improved = (torch.sum(residuals(x_new)[0] ** 2) < torch.sum(r ** 2))
    x = torch.where(improved, x_new, x)
    lm_lambda = torch.where(improved, lm_lambda * 0.5, lm_lambda * 4.0)
  return T0 @ se3.exp(x)


class PoseGraphOptimizer:
  """The original's PoseGraphOptimizer surface (pose_graph_optimizer.h:
  49-72): the constructor adds a vertex per keyframe and odometry edges
  between consecutive keyframes from their current relative poses;
  ``add_edge`` adds loop constraints; ``optimize`` solves on ``device``
  and returns the poses."""

  def __init__(self, keyframe_poses: np.ndarray,
               odometry_weights: np.ndarray, device):
    """keyframe_poses: (K, 4, 4) global_T_frame of the valid keyframes.

    odometry_weights: (K-1,) confidence of the consecutive-keyframe edges.
    The original uses identity information everywhere, which spreads a loop
    correction evenly along the chain; an edge whose tracking failed (a
    constant-position guess, not a measurement) should absorb the
    correction instead, so the front-end gives such edges
    ``WEAK_EDGE_WEIGHT`` (``slam/system.py``).

    device: where the solve runs, the system's device (no default, so that
    a caller cannot move the solve to the host by leaving it out)."""
    self.device = torch.device(device)
    self.T0 = np.asarray(keyframe_poses, np.float32)
    self.edges_i: List[int] = []
    self.edges_j: List[int] = []
    self.edges_Z: List[np.ndarray] = []
    self.weights: List[float] = []
    if len(self.T0) > 1:
      T = torch.from_numpy(self.T0).to(self.device)
      odometry = (se3.inverse(T[:-1]) @ T[1:]).cpu().numpy()
      for i, z in enumerate(odometry):
        self.add_edge(i, i + 1, z, weight=float(odometry_weights[i]))
    self.result: Optional[np.ndarray] = None

  def add_edge(self, i: int, j: int, i_T_j: np.ndarray, weight: float = 1.0):
    """An edge with measurement Z = i_T_j (identity information)."""
    self.edges_i.append(i)
    self.edges_j.append(j)
    self.edges_Z.append(np.asarray(i_T_j, np.float32))
    self.weights.append(weight)

  def optimize(self, num_iterations: int = 20) -> np.ndarray:
    if not self.edges_i:
      self.result = self.T0
      return self.result
    dev = self.device
    self.result = optimize_poses(
        torch.from_numpy(self.T0).to(dev),
        torch.tensor(self.edges_i, dtype=torch.long, device=dev),
        torch.tensor(self.edges_j, dtype=torch.long, device=dev),
        torch.from_numpy(np.stack(self.edges_Z)).to(dev),
        torch.tensor(self.weights, dtype=torch.float32, device=dev),
        num_iterations).cpu().numpy()
    return self.result
