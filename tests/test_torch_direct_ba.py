"""The port's back-end (badslam_tpu_torch.slam.direct_ba.DirectBA) against
the JAX package's DirectBA: the alternating bundle adjustment on the
reference's single-chip BA scene (``benchmarks/run_configs.py`` config1: six
keyframes of one plane-scene image, five of them perturbed), with capacity
growth, from a state carried over with ``from_numpy``, and on an empty map.

Tolerances: both converge in the same number of iterations; keyframe poses
within 1e-5 per entry; relative (gauge-free) pose error < 1e-4 as config1
gates it; surfel masks and watermark exact; surfel positions 1e-5 m (plus
1e-6 of the value) and descriptors 1e-2 after a whole BA.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.models.keyframes import ACTIVE
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.slam.direct_ba import DirectBA
from tests.test_torch_ba_fixtures import (
    add_keyframe_both, assert_stores, cameras, configs, make_pair,
    perturbed_pose, plane_keyframe, port_from_jax)

AFTER_BA = dict(pos=1e-5, normal=1e-5, radius_sq=1e-9, color=1e-5, desc=1e-2)
POSES = dict(global_T_frame=1e-5)


def _config1_pair(n=6, **overrides):
  """config1's scene in both back-ends: keyframe 0 at the identity, the
  others perturbed by up to 3 mm and 0.8 mrad."""
  jba, pba = make_pair(**overrides)
  kf, _ = plane_keyframe(seed=3)
  rng = np.random.default_rng(0)
  for i in range(n):
    T = np.eye(4, dtype=np.float32) if i == 0 else perturbed_pose(rng)
    add_keyframe_both(jba, pba, kf, T, 10 * i)
  return jba, pba


def _relative_pose_error(T, n):
  """config1's gate: the spread of the keyframes' pose errors, which a
  common gauge drift leaves alone."""
  errs = [float(se3.log(se3.inverse(T[i])).abs().max()) for i in range(n)]
  return max(errs) - min(errs)


def _assert_same_map(jba, pba):
  assert_stores(jba.kf, pba.kf, POSES)
  assert_stores(jba.surfels, pba.surfels, AFTER_BA, rtol=1e-6)
  assert pba.surfel_count == jba.surfel_count
  assert pba.ba_iteration_count == jba.ba_iteration_count
  np.testing.assert_array_equal(pba.last_active_in_ba_iteration,
                                jba.last_active_in_ba_iteration)
  pba.debug_verify_counts()


def test_bundle_adjustment_matches_jax_on_config1():
  jba, pba = _config1_pair(initial_keyframe_capacity=8)
  j_iters, j_conv = jba.bundle_adjustment(max_iterations=10)
  p_iters, p_conv = pba.bundle_adjustment(max_iterations=10)
  assert j_conv and p_conv
  assert p_iters == j_iters and 1 < p_iters < 10
  assert pba.surfel_count > 1000
  _assert_same_map(jba, pba)
  assert _relative_pose_error(pba.kf.global_T_frame, 6) < 1e-4
  # Converged keyframes are inactive; the next scheme re-activates from the
  # state, and a second BA changes nothing much in either package.
  assert int((pba.kf.activation == ACTIVE).sum()) == 0
  assert jba.bundle_adjustment(max_iterations=3) == \
      pba.bundle_adjustment(max_iterations=3)
  _assert_same_map(jba, pba)


def test_bundle_adjustment_with_capacity_growth_matches_jax():
  """Keyframe capacity 2 and surfel capacity 1 << 10: both stores grow
  while keyframes are added and surfels created, mid-BA included."""
  jba, pba = _config1_pair(n=3, initial_keyframe_capacity=2,
                           initial_surfel_capacity=1 << 10,
                           use_active_kf_window=False)
  assert pba.kf.capacity == jba.kf.capacity == 4
  assert jba.bundle_adjustment(max_iterations=6) == \
      pba.bundle_adjustment(max_iterations=6)
  assert pba.surfels.capacity == jba.surfels.capacity > 1 << 10
  _assert_same_map(jba, pba)
  assert _relative_pose_error(pba.kf.global_T_frame, 3) < 1e-4


def test_fixed_window_ba_from_a_carried_state_matches_jax():
  """A JAX map (three keyframes, the first one's surfels) carried into the
  port with from_numpy; then the sequential system's BA call on both: a
  fixed active window over all keyframes, --no_surfel_updates style
  creation at insertion left out."""
  jba, _ = make_pair(use_active_kf_window=False)
  kf, _ = plane_keyframe(seed=3)
  rng = np.random.default_rng(1)
  for i in range(3):
    T = np.eye(4, dtype=np.float32) if i == 0 else perturbed_pose(rng)
    jba.add_keyframe(*(jnp.asarray(x) for x in kf), jnp.asarray(T), 10 * i)
  jba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  pba = port_from_jax(jba)
  kwargs = dict(max_iterations=5, active_keyframe_window_start=0,
                active_keyframe_window_end=2)
  assert jba.bundle_adjustment(**kwargs) == pba.bundle_adjustment(**kwargs)
  _assert_same_map(jba, pba)
  assert _relative_pose_error(pba.kf.global_T_frame, 3) < 1e-4
  # Geometry only, a window that reaches past the last keyframe (the final
  # BA's windowed passes).
  kwargs = dict(optimize_poses=False, min_iterations=2, max_iterations=3,
                active_keyframe_window_start=0,
                active_keyframe_window_end=15)
  assert jba.bundle_adjustment(**kwargs) == pba.bundle_adjustment(**kwargs) \
      == (2, True)
  _assert_same_map(jba, pba)


def test_empty_map_ba_matches_jax():
  jba, pba = make_pair(use_active_kf_window=False)
  assert jba.bundle_adjustment(max_iterations=3) == \
      pba.bundle_adjustment(max_iterations=3) == (1, True)
  assert pba.surfel_count == 0 and pba.ba_iteration_count == 1
  assert_stores(jba.surfels, pba.surfels)
  pba.debug_verify_counts()
  pos, nrm, col = pba.export_point_cloud()
  assert pos.shape == nrm.shape == col.shape == (0, 3)


def _port_with_two_keyframes():
  _, pcfg = configs()
  _, pcam = cameras()
  pba = DirectBA(pcfg, pcam, pcam, device="cpu")
  kf, _ = plane_keyframe(seed=3)
  rng = np.random.default_rng(2)
  for i in range(2):
    T = np.eye(4, dtype=np.float32) if i == 0 else perturbed_pose(rng)
    pba.add_keyframe(*(torch.from_numpy(x.copy()) for x in kf),
                     torch.from_numpy(np.array(T)), 10 * i)
  return pba


def test_deadline_and_min_iterations_bound_the_scheme():
  """Real-time mode: a deadline in the past stops the scheme after its
  first iteration, or after min_iterations; without one it runs on."""
  pba = _port_with_two_keyframes()
  past = time.perf_counter() - 1.0
  assert pba.bundle_adjustment(max_iterations=5, deadline=past)[0] == 1
  assert pba.bundle_adjustment(max_iterations=5, deadline=past,
                               min_iterations=2)[0] == 2
  # increase_ba_iteration_count=False (the real-time path): the end tasks
  # run once at the start of the first call of a scheme, not at its end.
  count = pba.ba_iteration_count
  pba.bundle_adjustment(max_iterations=1, increase_ba_iteration_count=False)
  assert pba.ba_iteration_count == count
  assert pba.last_ba_iteration_count == count
  pba.debug_verify_counts()


def test_timings_stream_and_unported_options():
  pba = _port_with_two_keyframes()
  lines = []

  class Stream:
    def write(self, text):
      lines.append(text)

  pba.timings_stream = Stream()
  iterations, _ = pba.bundle_adjustment(max_iterations=4)
  assert len(lines) == iterations
  assert lines[0] == (f"BA_count 0 inner_iteration 0 keyframe_count 2 "
                      f"surfel_count {int(lines[0].split()[-1])}\n")
  for kwargs, item in ((dict(optimize_depth_intrinsics=True), "item 8"),
                       (dict(optimize_color_intrinsics=True), "item 8"),
                       (dict(transfer_free=True), "item 10")):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.*{item}"):
      pba.bundle_adjustment(max_iterations=1, **kwargs)
  pba.config.use_pcg = True
  with pytest.raises(NotImplementedError, match="ROADMAP.*item 8"):
    pba.bundle_adjustment(max_iterations=1)


def test_direct_ba_defaults_to_cuda_and_allocates_on_its_device(monkeypatch):
  _, pcfg = configs()
  _, pcam = cameras()
  if not torch.cuda.is_available():
    with pytest.raises((RuntimeError, AssertionError)):
      DirectBA(pcfg, pcam, pcam)  # no device named: cuda, never the CPU
  pba = DirectBA(pcfg, pcam, pcam, device="cpu")
  assert pba.device == torch.device("cpu")
  tensors = [pba.color_intr, pba.calibration.cfactor, pba.calibration.a,
             *pba.surfels, *pba.kf]
  assert all(t.device == torch.device("cpu") for t in tensors)
