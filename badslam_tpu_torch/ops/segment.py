"""Sums by segment in a fixed order: the port's ``jax.ops.segment_sum``.

``index_add_`` and ``scatter_add_`` on a CUDA device add with float atomics,
whose order, and so whose rounding, changes from run to run. Here the lanes
of each segment are laid out once as a row of a padded index table (lanes in
ascending order, rows padded with a lane that holds zero), and every sum is a
gather through that table followed by a reduction along the row: the same
bits in every run, and each segment adds its lanes in lane order, as the
reference's sequential scatter does.

The table depends only on the segment ids, so one ``SegmentPlan`` serves
every sum over the same ids (the four of an intrinsics step, the one of
every Hessian-vector product of a PCG solve). Building it reads one number
back to the host: the length of the longest row.

The pipelined front-end's BA must not read it, and the host knows no bound
on a row short of the whole store. There ``plan_segments(...,
transfer_free=True)`` gives a ``PrefixSegmentPlan`` instead: the lanes
sorted by segment, each sum the difference of a float64 running sum taken
at the segment's ends (one scan, the same bits in every run; its rounding
lies below float32's unless a segment's sum is tiny beside the running sum
at its start). Lanes that are not finite are counted apart, so that they
reach their own segment and no other. The two plans round differently,
and the joint PCG solve carries such differences into the map (the host
path keeps the row sums, which its tests hold to the reference's at
tight tolerances).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class SegmentPlan(NamedTuple):
  table: torch.Tensor   # (num_segments, longest) int64 lane index, pad = N
  counts: torch.Tensor  # (num_segments,) int64 lanes per segment

  def sum(self, values: torch.Tensor) -> torch.Tensor:
    """(N, ...) values -> (num_segments, ...) sums. A lane the plan left out
    contributes nothing, whatever it holds."""
    pad = values.new_zeros((1,) + values.shape[1:])
    return torch.cat([values, pad])[self.table].sum(dim=1)


class PrefixSegmentPlan(NamedTuple):
  order: torch.Tensor   # (N,) lanes sorted by segment, left-out lanes last
  starts: torch.Tensor  # (num_segments + 1,) first sorted lane of each
  counts: torch.Tensor  # (num_segments,) int64 lanes per segment

  def sum(self, values: torch.Tensor) -> torch.Tensor:
    """(N, ...) values -> (num_segments, ...) sums, without a host read. A
    lane the plan left out contributes nothing, whatever it holds. A lane
    that is not finite makes its own segment's sum what float addition
    makes it (NaN, or an infinity of its sign) and leaves every other
    segment's alone, as in the row sums."""
    v = values[self.order]
    finite = torch.isfinite(v)
    sums = self._between(torch.where(finite, v, 0.0).double()).to(v.dtype)
    pos, neg, nan = (self._between(torch.stack(
        [v == math.inf, v == -math.inf, torch.isnan(v)], dim=-1)) > 0
                     ).unbind(-1)
    return torch.where(nan | (pos & neg), math.nan,
                       torch.where(pos, math.inf,
                                   torch.where(neg, -math.inf, sums)))

  def _between(self, sorted_values: torch.Tensor) -> torch.Tensor:
    """Per segment, the running sum at its end less the one at its start."""
    running = torch.cumsum(sorted_values, dim=0)
    running = torch.cat([torch.zeros_like(running[:1]), running])
    return running[self.starts[1:]] - running[self.starts[:-1]]


def plan_segments(segment_ids: torch.Tensor, num_segments: int,
                  transfer_free: bool = False):
  """Plan sums over ``segment_ids`` (N,) int64. Ids outside
  [0, num_segments) leave their lane out (the reference sends such lanes to
  one extra segment that it cuts off). A ``SegmentPlan``, or with
  ``transfer_free`` a ``PrefixSegmentPlan`` (see the module's
  docstring)."""
  n = segment_ids.shape[0]
  dev = segment_ids.device
  ids = torch.where((segment_ids >= 0) & (segment_ids < num_segments),
                    segment_ids, num_segments)
  sorted_ids, order = torch.sort(ids, stable=True)
  starts = torch.searchsorted(
      sorted_ids, torch.arange(num_segments + 1, device=dev))
  counts = starts[1:] - starts[:-1]
  if transfer_free:
    return PrefixSegmentPlan(order, starts, counts)
  longest = max(int(counts.max()), 1) if num_segments else 1  # host read
  # Left-out lanes all land on the first entry of one extra row, which is
  # cut off; every other entry is written once.
  table = torch.full((num_segments + 1, longest), n, dtype=torch.int64,
                     device=dev)
  inside = sorted_ids < num_segments
  rank = torch.arange(n, device=dev) - starts[
      torch.clamp(sorted_ids, max=num_segments - 1)]
  table[sorted_ids, torch.where(inside, rank, 0)] = order
  return SegmentPlan(table[:num_segments], counts)
