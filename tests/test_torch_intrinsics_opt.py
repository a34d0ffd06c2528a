"""The port's self-calibration (badslam_tpu_torch.models.intrinsics_opt and
geometry_opt.reestimate_normals) against the JAX package's, on the
self-calibration tests' multi-view plane map (8 keyframes, 8 planes, cell 4,
160x120, textured), carried into the port with ``from_numpy``; then the
recovery gates of ``tests/test_intrinsics_opt.py`` met by the port alone.

Tolerances: re-estimated normals 1e-6; the accumulated blocks A, b1, cH, cb
within 1e-5 of their largest entry, B, D, b2 the same (of the block's
largest entry), observation counts exact; after one step the intrinsics
within 1e-4 px, cfactor within 1e-6 and exactly 0 where the reference
resets a cell, a within 5e-6. The limit on a was to be 1e-6: on this
fixture (a = 0.004, random cfactor) the Schur complement of the a row
cancels 532.1 to 1.37, so the float32 rounding of the blocks leaves the a
step of 4.8e-3 uncertain by about 2e-6 in either package (new a: the
reference -7.640e-4, the port -7.629e-4, a float64 solve of the port's
float32 blocks -7.652e-4).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.models import geometry_opt as jgeometry_opt
from badslam_tpu.models import intrinsics_opt as jintrinsics_opt
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.models import geometry_opt, intrinsics_opt
from badslam_tpu_torch.slam.direct_ba import DirectBA
from badslam_tpu_torch.utils import synthetic
from badslam_tpu_torch.utils.timing import Timing
from tests.test_torch_ba_fixtures import (
    H, W, jax_cameras_and_params, make_pair, multi_view_map,
    perturb_depth_intrinsics, port_from_jax)

PERTURBATION = torch.tensor([0.4, -0.3, 0.25, -0.2])


@pytest.fixture(scope="module")
def pair():
  """The textured map with both cameras perturbed and a non-zero a and
  cfactor, in both back-ends."""
  jba = multi_view_map(textured=True)
  perturb_depth_intrinsics(jba)
  jba.color_intr = jba.color_intr + jnp.asarray([-0.3, 0.2, 0.15, -0.25])
  rng = np.random.default_rng(7)
  jba.a = jnp.asarray(0.004, jnp.float32)
  jba.cfactor = jnp.asarray(
      rng.uniform(-2e-3, 2e-3, jba.cfactor.shape), jnp.float32)
  return jba, port_from_jax(jba)


def test_reestimate_normals_matches_jax(pair):
  jba, pba = pair
  depth_cam, _, dp = jax_cameras_and_params(jba)
  want = jax.jit(jgeometry_opt.reestimate_normals)(
      jba.surfels, jba.kf, depth_cam, dp)
  got = geometry_opt.reestimate_normals(
      pba.surfels, pba.kf, pba.depth_camera(), pba.calibration)
  valid = pba.surfels.valid.numpy()
  assert valid.sum() > 500
  moved = np.abs(got.normal.numpy() - pba.surfels.normal.numpy())[valid]
  assert moved.max() > 1e-4   # the averages differ from the creation normals
  np.testing.assert_allclose(got.normal.numpy(), np.asarray(want.normal),
                             rtol=0, atol=1e-6)
  # The slots the caller hands over are the ones the masks would give.
  again = geometry_opt.reestimate_normals(
      pba.surfels, pba.kf, pba.depth_camera(), pba.calibration,
      slots=list(range(pba.keyframe_count)))
  assert torch.equal(again.normal, got.normal)


@pytest.mark.parametrize("depth,color", [(True, False), (False, True),
                                         (True, True)],
                         ids=["depth", "color", "both"])
def test_accumulate_matches_jax(pair, depth, color):
  jba, pba = pair
  depth_cam, color_cam, dp = jax_cameras_and_params(jba)
  want = jax.jit(functools.partial(
      jintrinsics_opt._accumulate, optimize_depth=depth,
      optimize_color=color))(jba.surfels, jba.kf, depth_cam, color_cam, dp,
                             jba.kf.depth)
  got = intrinsics_opt._accumulate(
      pba.surfels, pba.kf, pba.depth_camera(), pba.color_camera(),
      pba.calibration, depth, color)
  names = ("A", "b1", "B", "D", "b2", "obs", "cH", "cb")
  for name, g, w in zip(names, got, want):
    g, w = g.numpy(), np.asarray(w)
    assert g.shape == w.shape and g.dtype == w.dtype, name
    if name == "obs":
      np.testing.assert_array_equal(g, w)
      assert (w.sum() > 1000) == depth
    else:
      scale = np.abs(w).max()
      assert (scale > 0) == (depth if name in ("A", "b1", "B", "D", "b2")
                             else color), name
      np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale,
                                 err_msg=name)


@pytest.mark.parametrize("depth,color", [(True, False), (False, True),
                                         (True, True)],
                         ids=["depth", "color", "both"])
def test_one_intrinsics_step_matches_jax(pair, depth, color):
  jba, pba = pair
  want = jintrinsics_opt.optimize_intrinsics(
      jba.surfels, jba.kf, jba.depth_intr, jba.color_intr, jba.a,
      jba.cfactor, jba.baseline_fx, jba.depth_size, jba.color_size,
      jba.cell_size, depth, color)
  before = (pba.calibration.depth_intr.clone(), pba.color_intr.clone(),
            pba.calibration.a.clone(), pba.calibration.cfactor.clone())
  got = intrinsics_opt.optimize_intrinsics(
      pba.surfels, pba.kf, pba.calibration, pba.color_intr, pba.color_size,
      depth, color)
  # The step returns new values and leaves the calibration alone.
  for now, was in zip((pba.calibration.depth_intr, pba.color_intr,
                       pba.calibration.a, pba.calibration.cfactor), before):
    assert torch.equal(now, was)
  for g, w, atol in zip(got, want, (1e-4, 1e-4, 5e-6, 1e-6)):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)
  d_intr, c_intr, a, cfactor = (g.numpy() for g in got)
  assert (np.abs(d_intr - before[0].numpy()).max() > 1e-3) == depth
  assert (np.abs(c_intr - before[1].numpy()).max() > 1e-3) == color
  if depth:
    # Unobserved cells are reset to exactly 0, the same cells in both.
    reset = np.asarray(want[3]) == 0.0
    assert 0 < reset.sum() < reset.size
    np.testing.assert_array_equal(cfactor == 0.0, reset)
  else:
    assert got[0] is pba.calibration.depth_intr
    assert got[3] is pba.calibration.cfactor


@pytest.mark.parametrize("kwargs", [
    dict(optimize_depth=False, optimize_color=False),
    dict(optimize_depth=True, optimize_color=True,
         use_depth_residuals=False, use_descriptor_residuals=False)],
    ids=["flags_off", "residuals_off"])
def test_intrinsics_step_is_a_noop_when_disabled(pair, kwargs):
  _, pba = pair
  out = intrinsics_opt.optimize_intrinsics(
      pba.surfels, pba.kf, pba.calibration, pba.color_intr, pba.color_size,
      **kwargs)
  assert out[0] is pba.calibration.depth_intr and out[1] is pba.color_intr
  assert out[2] is pba.calibration.a and out[3] is pba.calibration.cfactor


def test_intrinsics_step_on_an_empty_map_is_a_zero_step():
  """No observation at all: both systems are singular, the solves give
  non-finite steps, and the result is the reference's: intrinsics (to the
  rounding of their trip through the inverse parameters) and a unchanged,
  every cfactor cell reset."""
  jba, pba = make_pair(sparse_surfel_cell_size=4)
  jba.cfactor = jba.cfactor + 0.001
  pba.calibration.cfactor.add_(0.001)
  want = jintrinsics_opt.optimize_intrinsics(
      jba.surfels, jba.kf, jba.depth_intr, jba.color_intr, jba.a,
      jba.cfactor, jba.baseline_fx, jba.depth_size, jba.color_size,
      jba.cell_size, True, True)
  got = intrinsics_opt.optimize_intrinsics(
      pba.surfels, pba.kf, pba.calibration, pba.color_intr, pba.color_size,
      True, True)
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
  np.testing.assert_allclose(got[0].numpy(),
                             pba.calibration.depth_intr.numpy(), atol=1e-5)
  assert torch.equal(got[1], pba.color_intr)
  assert torch.equal(got[2], pba.calibration.a)
  assert float(got[3].abs().max()) == 0.0


# --- recovery, in the port alone ---


def _port_map(n_kf=8, use_pcg=False, **scene):
  cam = synthetic.default_test_camera(W, H)
  cfg = BadSlamConfig(
      sparse_surfel_cell_size=4,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
      initial_keyframe_capacity=n_kf, initial_surfel_capacity=1 << 14,
      max_depth=20.0, use_pcg=use_pcg)
  ba = DirectBA(cfg, cam, cam, device="cpu")
  for i, (kf, T) in enumerate(synthetic.multi_view_plane_keyframes(
      cam, n_kf=n_kf, **scene)):
    ba.add_keyframe(*kf, T, i)
  for i in range(n_kf):
    ba.create_surfels_for_keyframe(i, filter_new_surfels=True)
  return ba


def test_port_recovers_depth_intrinsics():
  """tests/test_intrinsics_opt.py::test_depth_intrinsics_recovery."""
  ba = _port_map()
  assert ba.surfel_count > 500
  calib = ba.calibration
  true_intr = calib.depth_intr.clone()
  calib.depth_intr.add_(PERTURBATION)
  for _ in range(60):
    ba._optimize_intrinsics(True, False)
  assert float((calib.depth_intr - true_intr).abs().max()) < 0.05
  assert abs(float(calib.a)) < 0.05
  assert float(calib.cfactor.abs().max()) < 0.05


def test_port_recovers_color_intrinsics():
  """tests/test_intrinsics_opt.py::test_color_intrinsics_recovery."""
  ba = _port_map(n_kf=12, textured=True, t_range=1.0, texture_freq=18.0)
  assert ba.surfel_count > 500
  true_intr = ba.color_intr.clone()
  ba.color_intr.add_(PERTURBATION)
  for _ in range(60):
    ba._optimize_intrinsics(False, True)
  assert float((ba.color_intr - true_intr).abs().max()) < 0.05


def test_port_ba_under_pcg_config_recovers_depth_intrinsics():
  """tests/test_intrinsics_opt.py::test_pcg_ba_with_intrinsics_optimization:
  with poses and geometry fixed, a use_pcg configuration runs the alternated
  step in the BA dispatcher."""
  ba = _port_map(use_pcg=True)
  true_intr = ba.calibration.depth_intr.clone()
  ba.calibration.depth_intr.add_(PERTURBATION)
  with Timing.isolated() as stats:
    for _ in range(10):
      ba.bundle_adjustment(
          optimize_depth_intrinsics=True, optimize_color_intrinsics=False,
          do_surfel_updates=False, optimize_poses=False,
          optimize_geometry=False, min_iterations=1, max_iterations=2)
  assert float((ba.calibration.depth_intr - true_intr).abs().max()) < 0.1
  assert bool(torch.isfinite(ba.kf.global_T_frame).all())
  assert "BA PCG inner iterations" not in stats
