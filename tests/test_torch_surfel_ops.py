"""The port's surfel lifecycle (badslam_tpu_torch.models.surfel_ops, through
the port's DirectBA) against the JAX package's on the fixtures of
``tests/test_surfel_lifecycle.py``: the same keyframes go into both
back-ends, the same operation runs on both, and the stores are compared.

Tolerances: every mask, the watermark and the slot order exact; created
attributes 1e-5 (plus 1e-6 of the value: the scene reaches 180 m),
descriptors 1e-4; radii after the radius update 1e-9; colors 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.models import surfel_ops as jsurfel_ops
from badslam_tpu.models import surfels as jsurfels
from badslam_tpu.models.keyframes import ACTIVE, INACTIVE
from badslam_tpu.slam import direct_ba as jdirect_ba
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import surfel_ops, surfels
from tests.test_torch_ba_fixtures import (
    H, W, add_keyframe_both, assert_stores, make_pair, plane_keyframe)

CREATED = dict(pos=1e-5, normal=1e-5, radius_sq=1e-9, color=1e-5, desc=1e-4)


def _assert_surfels(jba, pba, tolerances=CREATED):
  assert_stores(jba.surfels, pba.surfels, tolerances, rtol=1e-6)
  assert pba.surfel_count == jba.surfel_count
  pba.debug_verify_counts()


def _pair_with_keyframes(n=1, min_obs=1, seed=0, **overrides):
  jba, pba = make_pair(
      min_observation_count_while_bootstrapping_1=min_obs,
      min_observation_count_while_bootstrapping_2=min_obs,
      min_observation_count=min_obs, **overrides)
  kf, _ = plane_keyframe(seed=seed)
  for i in range(n):
    add_keyframe_both(jba, pba, kf, np.eye(4, dtype=np.float32), 10 * i)
  return jba, pba


def _both(jba, pba, method, *args, **kwargs):
  getattr(jba, method)(*args, **kwargs)
  getattr(pba, method)(*args, **kwargs)


@pytest.mark.parametrize("h,w,cell", [(12, 16, 2), (13, 17, 4), (9, 10, 3),
                                      (8, 8, 1)])
def test_first_valid_pixel_per_cell_matches_jax(h, w, cell):
  rng = np.random.default_rng(h * w + cell)
  for density in (0.05, 0.5, 1.0):
    cand = rng.random((h, w)) < density
    j = np.asarray(jsurfel_ops._first_valid_pixel_per_cell(
        jnp.asarray(cand), cell))
    p = surfel_ops._first_valid_pixel_per_cell(torch.from_numpy(cand),
                                               cell).numpy()
    np.testing.assert_array_equal(p, j)
    assert p.sum() <= -(-h // cell) * -(-w // cell) and not (p & ~cand).any()


def test_creation_matches_jax_slot_for_slot():
  jba, pba = _pair_with_keyframes()
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  assert pba.surfel_count > 1000
  _assert_surfels(jba, pba)
  # One surfel per sparsification cell at most, and a second pass from the
  # same keyframe finds every cell supported.
  assert pba.surfel_count <= (H // 2 + 1) * (W // 2 + 1)
  before = pba.surfel_count
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  assert pba.surfel_count == before
  _assert_surfels(jba, pba)


def test_candidates_and_supported_cells_match_jax():
  jba, pba = _pair_with_keyframes()
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  # Delete a third of the surfels: their cells lose their support.
  kill = np.arange(pba.surfels.capacity) % 3 == 0
  jba.surfels = jba.surfels._replace(
      valid=jba.surfels.valid & ~jnp.asarray(kill))
  pba.surfels = pba.surfels._replace(
      valid=pba.surfels.valid & ~torch.from_numpy(kill))
  w, h = jba.depth_size
  jcam = jdirect_ba.make_camera(jba.depth_intr, w, h)
  eye_j, eye_p = jnp.eye(4, dtype=jnp.float32), torch.eye(4)
  jsup = jsurfel_ops.supported_cell_mask(
      jba.surfels, eye_j, jba.kf.depth[0], jba.kf.normals[0], jcam,
      jba.depth_params())
  psup = surfel_ops.supported_cell_mask(
      pba.surfels, eye_p, pba.kf.depth[0], pba.kf.normals[0],
      pba.depth_camera(), pba.depth_params())
  np.testing.assert_array_equal(psup.numpy(), np.asarray(jsup))
  assert 0 < int(psup.sum()) < psup.numel()

  jc = jsurfel_ops.compute_new_surfel_candidates(
      jba.surfels, jba.kf.depth[0], jba.kf.normals[0], jba.kf.radius_sq[0],
      jba.kf.intensity[0], jba.kf.rgb[0], eye_j, jcam, jcam,
      jba.depth_params())
  pc = surfel_ops.compute_new_surfel_candidates(
      pba.surfels, pba.kf.depth[0], pba.kf.normals[0], pba.kf.radius_sq[0],
      pba.kf.intensity[0], pba.kf.rgb[0], eye_p, pba.depth_camera(),
      pba.color_camera(), pba.depth_params())
  mask = pc.mask.numpy()
  np.testing.assert_array_equal(mask, np.asarray(jc.mask))
  assert mask.sum() > 300
  for name, tol in CREATED.items():
    np.testing.assert_allclose(
        getattr(pc, name).numpy()[mask], np.asarray(getattr(jc, name))[mask],
        rtol=1e-6, atol=tol, err_msg=name)


def test_observation_filtering_matches_jax():
  """min_observation_count 2: with no covisible keyframe every candidate is
  dropped; with an identical second keyframe its candidates see the first."""
  jba, pba = _pair_with_keyframes(min_obs=2)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=True)
  assert pba.surfel_count == jba.surfel_count == 0
  kf, _ = plane_keyframe()
  add_keyframe_both(jba, pba, kf, np.eye(4, dtype=np.float32), 10)
  assert bool(pba.kf.covis[1, 0])
  _both(jba, pba, "create_surfels_for_keyframe", 1, filter_new_surfels=True)
  assert pba.surfel_count > 1000
  _assert_surfels(jba, pba)


def test_filtering_counts_free_space_violations_like_jax():
  """A second keyframe 4 cm nearer along z sees the first one's surface
  behind its candidates or in front of them: observations and violations
  decide, the same way in both packages."""
  jba, pba = _pair_with_keyframes(min_obs=2)
  kf, _ = plane_keyframe()
  T = np.eye(4, dtype=np.float32)
  T[2, 3] = 0.04
  add_keyframe_both(jba, pba, kf, T, 10)
  _both(jba, pba, "create_surfels_for_keyframe", 1, filter_new_surfels=True)
  _assert_surfels(jba, pba)
  # The second keyframe, as slot ints and as a mask read back: same result.
  cand = surfel_ops.compute_new_surfel_candidates(
      surfels.create(8, "cpu"), pba.kf.depth[1], pba.kf.normals[1],
      pba.kf.radius_sq[1], pba.kf.intensity[1], pba.kf.rgb[1],
      pba.kf.global_T_frame[1], pba.depth_camera(), pba.color_camera(),
      pba.depth_params())
  covis = pba.kf.covis[1] & pba.kf.valid
  args = (cand, pba.kf.depth, pba.kf.normals, pba.kf.global_T_frame, covis,
          pba.depth_camera(), pba.depth_params(), 2)
  np.testing.assert_array_equal(
      surfel_ops.filter_candidates_by_observations(*args).numpy(),
      surfel_ops.filter_candidates_by_observations(*args, slots=[0]).numpy())


def _duplicate_surfels(jba, pba, offset):
  js, ps = jba.surfels, pba.surfels
  jba.surfels = jsurfels.append(js, js.pos + offset, js.normal, js.radius_sq,
                                js.color, js.desc, js.valid)
  pba.surfels = surfels.append(ps, ps.pos + offset, ps.normal, ps.radius_sq,
                               ps.color, ps.desc, ps.valid)
  # An append behind the back-end's back: reading the watermark re-syncs
  # the host's bound on it.
  assert pba.surfel_watermark == jba.surfel_watermark


@pytest.mark.parametrize("offset", [1e-4, 3e-3])
def test_merge_matches_jax(offset):
  """Every surfel duplicated at a small offset (within the merge distance,
  or beyond it for part of them): the merge keeps the same surfels."""
  jba, pba = _pair_with_keyframes()
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  count = pba.surfel_count
  _duplicate_surfels(jba, pba, offset)
  _duplicate_surfels(jba, pba, -offset)  # up to 4 contenders per cell
  assert pba.surfel_count == 4 * count
  w, h = jba.depth_size
  jba.surfels = jdirect_ba._merge_surfels_jit(
      jba.surfels, jba.kf, jnp.asarray(0, jnp.int32), jba.depth_intr, jba.a,
      jba.cfactor, jba.baseline_fx, w, h, jba.cell_size,
      jnp.asarray(0.8, jnp.float32))
  pba._merge_surfels(0)
  assert pba.surfel_count < 4 * count
  if offset == 1e-4:
    assert pba.surfel_count <= count * 1.1
  _assert_surfels(jba, pba)


def test_delete_and_radius_update_match_jax():
  jba, pba = _pair_with_keyframes(n=2)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  count = pba.surfel_count
  # Garbage that no keyframe observes, and radii that the update shrinks.
  n_garbage = 64
  garbage = (np.tile(np.float32([[100.0, 100.0, 100.0]]), (n_garbage, 1)),
             np.tile(np.float32([[0.0, 0.0, -1.0]]), (n_garbage, 1)),
             np.full(n_garbage, 1e-4, np.float32),
             np.zeros((n_garbage, 3), np.float32),
             np.zeros((n_garbage, 2), np.float32), np.ones(n_garbage, bool))
  jba.surfels = jsurfels.append(jba.surfels,
                                *(jnp.asarray(x) for x in garbage))
  pba.surfels = surfels.append(pba.surfels,
                               *(torch.from_numpy(x) for x in garbage))
  jba.surfels = jba.surfels._replace(radius_sq=jba.surfels.radius_sq * 4.0)
  pba.surfels = pba.surfels._replace(radius_sq=pba.surfels.radius_sq * 4.0)
  assert pba.surfel_count == count + n_garbage
  _both(jba, pba, "perform_ba_scheme_end_tasks", do_surfel_updates=False)
  assert pba.surfel_count == count
  assert pba.num_surfels_deleted == jba.num_surfels_deleted == n_garbage
  _assert_surfels(jba, pba)


def test_end_tasks_merge_and_compact_like_jax():
  """The end-of-scheme tasks with surfel updates on: the keyframes active
  in this scheme merge, and a store with a quarter of dead slots compacts."""
  jba, pba = _pair_with_keyframes(initial_surfel_capacity=1 << 13)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  count = pba.surfel_count
  _duplicate_surfels(jba, pba, 1e-4)
  _duplicate_surfels(jba, pba, -1e-4)
  for ba in (jba, pba):
    ba.last_active_in_ba_iteration[0] = ba.ba_iteration_count
  _both(jba, pba, "perform_ba_scheme_end_tasks", do_surfel_updates=True)
  assert pba.surfel_watermark == pba.surfel_count <= count * 1.1
  assert pba.surfel_watermark == jba.surfel_watermark
  _assert_surfels(jba, pba)


@pytest.mark.parametrize("kf_state", [INACTIVE, ACTIVE])
def test_surfel_activation_matches_jax(kf_state):
  jba, pba = _pair_with_keyframes(n=2)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  act = np.full(pba.kf.capacity, INACTIVE, np.int32)
  act[1] = kf_state
  _both(jba, pba, "set_activation", act)
  keep = np.zeros(pba.surfels.capacity, bool)
  keep[:7] = True  # forced active, as new surfels are
  jba.surfels = jba.surfels._replace(
      active=jnp.zeros_like(jba.surfels.active))
  pba.surfels = pba.surfels._replace(
      active=torch.zeros_like(pba.surfels.active))
  w, h = jba.depth_size
  jba.surfels = jdirect_ba._surfel_activation_jit(
      jba.surfels, jba.kf, jba.depth_intr, jba.a, jba.cfactor,
      jba.baseline_fx, jnp.asarray(keep), w, h, jba.cell_size)
  pba.surfels = surfel_ops.update_surfel_activation(
      pba.surfels, pba.kf, pba.depth_camera(), pba.depth_params(),
      torch.from_numpy(keep))
  active = int(pba.surfels.active.sum())
  if kf_state == INACTIVE:
    assert active == int(pba.surfels.valid[:7].sum())
  else:
    assert active > 0.9 * pba.surfel_count
  _assert_surfels(jba, pba)


def test_assign_colors_matches_jax():
  jba, pba = _pair_with_keyframes(n=2)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  jba.surfels = jba.surfels._replace(color=jnp.zeros_like(jba.surfels.color))
  pba.surfels = pba.surfels._replace(
      color=torch.zeros_like(pba.surfels.color))
  _both(jba, pba, "assign_colors")
  col = pba.surfels.color[pba.surfels.valid].numpy()
  assert (col > 0.05).any()
  np.testing.assert_allclose(col[:, 0], col[:, 1], atol=1e-5)  # grey input
  _assert_surfels(jba, pba)
  jp, jn, jc = jba.export_point_cloud()
  pp, pn, pc = pba.export_point_cloud()
  assert pp.shape == jp.shape == (pba.surfel_count, 3) and pc.dtype == np.uint8
  np.testing.assert_allclose(pp, jp, rtol=1e-6, atol=1e-5)
  np.testing.assert_allclose(pn, jn, rtol=0, atol=1e-5)
  assert np.abs(pc.astype(int) - jc.astype(int)).max() <= 1


def test_surfel_store_grows_before_a_creation_pass_like_jax():
  """Surfel capacity 1 << 10 against ~2,000 candidates: both stores double
  until one image's worth of headroom fits above the watermark."""
  jba, pba = _pair_with_keyframes(initial_surfel_capacity=1 << 10)
  _both(jba, pba, "create_surfels_for_keyframe", 0, filter_new_surfels=False)
  assert pba.surfels.capacity == jba.surfels.capacity > 1 << 10
  _assert_surfels(jba, pba)


def test_inverse_pose_feeds_the_merge_like_jax():
  """The merge takes frame_T_global: a keyframe away from the origin."""
  jba, pba = _pair_with_keyframes()
  T = se3.exp(torch.tensor([0.05, -0.02, 0.03, 0.01, -0.02, 0.015])).numpy()
  kf, _ = plane_keyframe()
  add_keyframe_both(jba, pba, kf, T, 10)
  _both(jba, pba, "create_surfels_for_keyframe", 1, filter_new_surfels=False)
  _duplicate_surfels(jba, pba, 1e-4)
  w, h = jba.depth_size
  jba.surfels = jdirect_ba._merge_surfels_jit(
      jba.surfels, jba.kf, jnp.asarray(1, jnp.int32), jba.depth_intr, jba.a,
      jba.cfactor, jba.baseline_fx, w, h, jba.cell_size,
      jnp.asarray(0.8, jnp.float32))
  pba._merge_surfels(1)
  _assert_surfels(jba, pba)
