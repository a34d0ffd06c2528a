"""The port's sums by segment (badslam_tpu_torch/ops/segment.py), both
plans (the host path's row sums and the transfer-free prefix sums),
against ``jax.ops.segment_sum``, against exact float64 sums and against
each other, on seeded ids.

Tolerances, per segment, in units of float32's epsilon times the segment's
sum of magnitudes: the prefix sums lie within 1 of the exact sum (they add
in float64); the row sums (float32), the JAX package's (sequential
float32) and the two plans' difference within one rounding per lane, the
segment's lane count plus 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu_torch.ops.segment import (PrefixSegmentPlan, SegmentPlan,
                                           plan_segments)

EPS32 = float(np.finfo(np.float32).eps)


def _inputs(seed, n, num_segments, width):
  """Seeded ids, a share of them outside [0, num_segments) and some
  segments empty, and float32 values of mixed sign and magnitude."""
  rng = np.random.default_rng(seed)
  ids = rng.integers(-3, num_segments + 3, n)
  ids[np.isin(ids, [1, num_segments - 2])] = -1   # two empty segments
  shape = (n,) if width is None else (n, width)
  values = (rng.standard_normal(shape)
            * 10.0 ** rng.integers(-3, 4, shape)).astype(np.float32)
  return ids, values


def _jax_sum(ids, values, num_segments):
  """The reference's segment sum: lanes outside go to one extra segment
  that is cut off."""
  inside = np.where((ids >= 0) & (ids < num_segments), ids, num_segments)
  return np.asarray(jax.ops.segment_sum(
      jnp.asarray(values), jnp.asarray(inside),
      num_segments + 1))[:num_segments]


def _exact(ids, values, num_segments, absolute=False):
  v = np.abs(values) if absolute else values
  out = np.zeros((num_segments,) + values.shape[1:], np.float64)
  for s in range(num_segments):
    out[s] = v[ids == s].astype(np.float64).sum(axis=0)
  return out


@pytest.mark.parametrize("transfer_free", [False, True],
                         ids=["rows", "prefix"])
@pytest.mark.parametrize("seed,n,num_segments,width", [
    (0, 1, 4, None), (1, 257, 16, None), (2, 4096, 300, 3),
    (3, 20000, 1200, 2)])
def test_segment_sums_match_jax_and_exact_sums(seed, n, num_segments, width,
                                               transfer_free):
  ids, values = _inputs(seed, n, num_segments, width)
  plan = plan_segments(torch.from_numpy(ids), num_segments, transfer_free)
  assert isinstance(plan, PrefixSegmentPlan if transfer_free
                    else SegmentPlan)
  got = plan.sum(torch.from_numpy(values))
  assert got.dtype == torch.float32
  got = got.numpy().astype(np.float64)
  counts = np.asarray([(ids == s).sum() for s in range(num_segments)])
  np.testing.assert_array_equal(plan.counts.numpy(), counts)
  exact = _exact(ids, values, num_segments)
  magnitude = _exact(ids, values, num_segments, absolute=True)
  per_lane = (counts.reshape((-1,) + (1,) * (values.ndim - 1)) + 1) * EPS32
  own = EPS32 if transfer_free else per_lane
  assert np.all(np.abs(got - exact) <= own * magnitude)
  ref = _jax_sum(ids, values, num_segments).astype(np.float64)
  assert np.all(np.abs(got - ref) <= per_lane * magnitude)
  assert np.all(got[counts == 0] == 0.0)
  # The same bits in every call over the same plan.
  assert torch.equal(plan.sum(torch.from_numpy(values)),
                     plan.sum(torch.from_numpy(values)))
  if transfer_free:
    rows = plan_segments(torch.from_numpy(ids), num_segments).sum(
        torch.from_numpy(values)).numpy().astype(np.float64)
    assert np.all(np.abs(got - rows) <= per_lane * magnitude)


@pytest.mark.parametrize("transfer_free", [False, True],
                         ids=["rows", "prefix"])
def test_non_finite_lanes_stay_in_their_segment(transfer_free):
  """NaN and infinities reach their own segment's sum as float addition
  makes it, and no other; left-out lanes reach none."""
  ids, values = _inputs(4, 600, 12, None)
  lane = {s: int(np.flatnonzero(ids == s)[0]) for s in (2, 3, 4, 5)}
  values[lane[2]] = np.nan
  values[lane[3]] = np.inf
  values[lane[4]] = np.inf
  values[np.flatnonzero(ids == 4)[1]] = -np.inf
  values[lane[5]] = -np.inf
  values[np.flatnonzero(ids < 0)[:2]] = (np.nan, np.inf)
  got = plan_segments(torch.from_numpy(ids), 12, transfer_free).sum(
      torch.from_numpy(values)).numpy()
  ref = _jax_sum(ids, values, 12)
  np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
  assert np.isnan(got[[2, 4]]).all()
  assert got[3] == np.inf and got[5] == -np.inf
  finite = np.isfinite(ref)
  assert finite.sum() == 12 - 4
  magnitude = _exact(ids, np.where(np.isfinite(values), values, 0), 12,
                     absolute=True)
  assert np.all(np.abs(got[finite] - ref[finite])
                <= 600 * EPS32 * magnitude[finite])
