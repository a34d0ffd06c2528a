"""Statistics of a run's samples."""

from __future__ import annotations

from typing import Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
  """The ``q``-th percentile (0-100) of all values, interpolated linearly
  between the two nearest ranks (numpy's default); None for no values."""
  xs = sorted(values)
  if not xs:
    return None
  pos = (len(xs) - 1) * q / 100.0
  lo = int(pos)
  hi = min(lo + 1, len(xs) - 1)
  return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def mean(values: Sequence[float]) -> Optional[float]:
  return sum(values) / len(values) if values else None


def merge(intervals) -> list:
  """The union of (start, end) intervals as disjoint sorted intervals."""
  out = []
  for s, e in sorted(intervals):
    if out and s <= out[-1][1]:
      out[-1][1] = max(out[-1][1], e)
    else:
      out.append([s, e])
  return out
