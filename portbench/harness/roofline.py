"""The table of peaks and the operation and byte counts of the program's
hand-written kernel, frozen here so that a change to the program cannot
move its own yardstick.

A copy of ``preprocess_bound`` and its constants from ``chip_smoke.py``:
the least time an H100 could take for ``fused_depth_preprocess`` on a
frame, counted from the frame's own data.
"""

from __future__ import annotations

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# device memory rate, float32 rate outside the tensor cores (an FMA counts
# as two operations).
H100_BYTES_PER_S = 3.35e12
H100_FP32_OPS_PER_S = 67e12

# float32 operations, counted from the plain chain (reference/preprocess.py):
# each float add, subtract and multiply whose result is used counts one;
# compares, selects, min/max and index arithmetic count nothing. expf, IEEE
# division, reciprocal and square root count as the instruction sequences
# nvcc emits for them on sm_90a without --use_fast_math, an FFMA as two.
OPS_EXP, OPS_DIV, OPS_RCP, OPS_SQRT = 11, 11, 6, 7
# One bilateral tap with a valid center and a valid sample.
OPS_PER_TAP = 7 + OPS_EXP
# Once per valid pixel: its inverse depth, which every tap on it reads.
OPS_PER_VALID_PIXEL = OPS_RCP
# Once per pixel that passes the cutoff: the filter's quotient, the
# calibration, five unprojections, two one-sided or central differences,
# the cross product, its length and normalisation, the radii.
OPS_PER_CENTER_PIXEL = (3 + 30 + 38 + 9 + 5 + 2 + 62
                        + 4 * OPS_DIV + 2 * OPS_RCP + OPS_EXP + OPS_SQRT)


def preprocess_bound(raw, *, sigma_xy: float, radius_factor: float,
                     max_depth: float) -> dict:
  """The least time for the kernel on ``raw`` (metric depth (H, W), a
  tensor): the larger of its bytes (the frame read once, four planes
  written once) over the memory rate and its float32 operations over the
  float32 peak. A tap counts where the center passes the cutoff and the
  sample is valid."""
  import torch.nn.functional as F
  h, w = raw.shape
  radius = int(radius_factor * sigma_xy + 0.5)
  valid = raw > 0.0
  center = valid & (raw <= max_depth)
  padded = F.pad(valid[None, None], (radius,) * 4)[0, 0]
  taps = 0
  for dy in range(-radius, radius + 1):
    for dx in range(-radius, radius + 1):
      if dx * dx + dy * dy <= radius * radius:
        sample = padded[radius + dy:radius + dy + h,
                        radius + dx:radius + dx + w]
        taps += int((center & sample).sum())
  n_valid, n_center = int(valid.sum()), int(center.sum())
  nbytes = 5 * 4 * h * w
  ops = (taps * OPS_PER_TAP + n_valid * OPS_PER_VALID_PIXEL
         + n_center * OPS_PER_CENTER_PIXEL)
  bytes_s = nbytes / H100_BYTES_PER_S
  ops_s = ops / H100_FP32_OPS_PER_S
  return {"bytes": nbytes, "ops": ops, "bound_s": max(bytes_s, ops_s),
          "bound_by": "operations" if ops_s > bytes_s else "bytes"}
