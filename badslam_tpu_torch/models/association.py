"""Association constants and the depth-residual uncertainty: the part
odometry reaches.

Port of ``badslam_tpu/models/association.py:34-75``. The surfel association
itself (``associate_surfels``) comes with the BA slice.
"""

from __future__ import annotations

import torch

# cos(40 deg): surfel vs measured normal compatibility (kernels.cuh:56-58).
COS_NORMAL_COMPATIBILITY_THRESHOLD = 0.76604
# Tukey parameter on the depth residual (cost_function.cuh:48).
DEPTH_TUKEY_PARAMETER = 10.0
# Empirical stereo-matching uncertainty factor (cost_function.cuh:52).
DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR = 0.1


def depth_residual_inv_stddev(nx: torch.Tensor, ny: torch.Tensor,
                              depth: torch.Tensor,
                              local_normal: torch.Tensor,
                              baseline_fx) -> torch.Tensor:
  """Propagated inverse depth stddev (cost_function.cuh:86-88)."""
  denom = (DEPTH_UNCERTAINTY_EMPIRICAL_FACTOR
           * torch.abs(local_normal[..., 0] * nx + local_normal[..., 1] * ny
                       + local_normal[..., 2])
           * depth * depth)
  return baseline_fx / torch.clamp(denom, min=1e-12)
