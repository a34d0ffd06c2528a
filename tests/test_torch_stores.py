"""The port's map stores (badslam_tpu_torch.models.surfels, .keyframes)
against the JAX package's on the same numpy inputs, and the state carried
between the two packages.

Tolerances: none. Every field of every store is compared exactly (values,
dtypes, shapes), because the stores only move data.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.models import keyframes as jkeyframes
from badslam_tpu.models import surfels as jsurfels
from badslam_tpu_torch.models import keyframes, surfels
from tests.test_torch_ba_fixtures import (
    H, W, add_keyframe_both, assert_stores, jax_state, make_pair,
    plane_keyframe, port_from_jax, port_store)


def _block(rng, n, offset=0.0):
  """One append block as numpy: (pos, normal, radius_sq, color, desc)."""
  return (
      (offset + rng.normal(size=(n, 3))).astype(np.float32),
      np.tile(np.float32([[0, 0, -1.0]]), (n, 1)),
      rng.uniform(1e-5, 1e-4, n).astype(np.float32),
      rng.uniform(0, 1, (n, 3)).astype(np.float32),
      rng.uniform(-50, 50, (n, 2)).astype(np.float32))


def _append_both(js, ps, block, mask):
  js = jsurfels.append(js, *(jnp.asarray(x) for x in block),
                       jnp.asarray(mask))
  ps = surfels.append(ps, *(torch.from_numpy(x) for x in block),
                      torch.from_numpy(mask))
  return js, ps


def test_append_after_delete_matches_jax():
  """Deletion clears ``valid`` without lowering the watermark, and a later
  append lands in fresh slots: the reference's regression test, on both
  stores."""
  rng = np.random.default_rng(0)
  js, ps = jsurfels.create(64), surfels.create(64, "cpu")
  assert_stores(js, ps)
  mask = rng.random(40) < 0.8
  js, ps = _append_both(js, ps, _block(rng, 40), mask)
  assert int(ps.count) == int(mask.sum())
  assert_stores(js, ps)

  kill = (np.arange(64) % 2 == 0)
  js = js._replace(valid=js.valid & ~jnp.asarray(kill),
                   active=js.active & ~jnp.asarray(kill))
  ps = ps._replace(valid=ps.valid & ~torch.from_numpy(kill),
                   active=ps.active & ~torch.from_numpy(kill))
  survivors = ps.pos[ps.valid].numpy().copy()
  js, ps = _append_both(js, ps, _block(rng, 8, offset=100.0),
                        np.ones(8, bool))
  assert int(ps.count) == int(mask.sum()) + 8
  assert_stores(js, ps)
  np.testing.assert_array_equal(ps.pos.numpy()[:int(mask.sum())][
      ps.valid.numpy()[:int(mask.sum())]], survivors)


def test_append_drops_what_overflows_the_capacity():
  rng = np.random.default_rng(1)
  js, ps = jsurfels.create(16), surfels.create(16, "cpu")
  js, ps = _append_both(js, ps, _block(rng, 12), np.ones(12, bool))
  js, ps = _append_both(js, ps, _block(rng, 12), rng.random(12) < 0.9)
  assert int(ps.count) == 16 and int(ps.valid.sum()) == 16
  assert_stores(js, ps)


def test_append_leaves_the_old_store_as_it_was():
  """BA keeps ``surfels.valid`` across a creation pass to find the new
  surfels, so append must not write into the store it was given."""
  rng = np.random.default_rng(2)
  ps = surfels.create(32, "cpu")
  before = {k: v.copy() for k, v in port_store(ps).items()}
  new = surfels.append(ps, *(torch.from_numpy(x) for x in _block(rng, 8)),
                       torch.ones(8, dtype=torch.bool))
  for name, value in port_store(ps).items():
    np.testing.assert_array_equal(value, before[name], err_msg=name)
  assert int((new.valid & ~ps.valid).sum()) == 8
  assert new.valid is not ps.valid


def test_grow_and_compact_match_jax():
  rng = np.random.default_rng(3)
  js, ps = jsurfels.create(32), surfels.create(32, "cpu")
  js, ps = _append_both(js, ps, _block(rng, 24), rng.random(24) < 0.7)
  dead = rng.random(32) < 0.4
  js = js._replace(valid=js.valid & ~jnp.asarray(dead))
  ps = ps._replace(valid=ps.valid & ~torch.from_numpy(dead))
  jg, pg = jsurfels.grow(js, 80), surfels.grow(ps, 80)
  assert pg.capacity == 80
  assert_stores(jg, pg)
  jc, pc = jsurfels.compact(jg), surfels.compact(pg)
  assert int(pc.count) == int(pc.valid.sum()) == int(jc.count)
  assert_stores(jc, pc)
  assert int(surfels.used_size(pc)) == int(jsurfels.used_size(jc))


def _three_keyframes(jba, pba):
  """The reference's covisibility fixture: a keyframe at the origin, one
  100 m away (no frustum intersection) and one 5 cm away."""
  kf0, _ = plane_keyframe(seed=0)
  kf1, _ = plane_keyframe(seed=1, textured=False)
  poses = [np.eye(4, dtype=np.float32) for _ in range(3)]
  poses[1][0, 3] = 100.0
  poses[2][0, 3] = 0.05
  for i, (kf, T) in enumerate(zip((kf0, kf1, kf1), poses)):
    add_keyframe_both(jba, pba, kf, T, 10 * i)


def test_add_keyframe_and_covisibility_match_jax():
  jba, pba = make_pair()
  _three_keyframes(jba, pba)
  assert_stores(jba.kf, pba.kf)
  covis = pba.kf.covis.numpy()
  assert not covis[0, 1] and covis[0, 2] and covis[2, 0]
  assert pba.keyframe_count == 3
  pba.debug_verify_counts()


def test_keyframe_store_grows_like_jax():
  """Initial capacity 2, three keyframes: one doubling, mirrors included."""
  jba, pba = make_pair(initial_keyframe_capacity=2)
  _three_keyframes(jba, pba)
  assert pba.kf.capacity == jba.kf.capacity == 4
  assert_stores(jba.kf, pba.kf)
  np.testing.assert_array_equal(pba._kf_valid_host, jba._kf_valid_host)
  np.testing.assert_array_equal(pba.last_active_in_ba_iteration,
                                jba.last_active_in_ba_iteration)
  jg, pg = jkeyframes.grow(jba.kf, 7), keyframes.grow(pba.kf, 7)
  assert_stores(jg, pg)


def test_add_keyframe_fills_the_image_stacks_in_place():
  """The (K, H, W) stacks are not copied per keyframe; the small vectors
  are replaced, so a caller's old poses stay as they were."""
  _, pba = make_pair()
  kf, _ = plane_keyframe()
  stacks = [pba.kf.depth, pba.kf.normals, pba.kf.radius_sq, pba.kf.intensity,
            pba.kf.rgb]
  old_poses = pba.kf.global_T_frame
  T = np.eye(4, dtype=np.float32)
  T[2, 3] = 0.25
  pba.add_keyframe(*(torch.from_numpy(x.copy()) for x in kf),
                   torch.from_numpy(T), 0)
  for before, after in zip(stacks, [pba.kf.depth, pba.kf.normals,
                                    pba.kf.radius_sq, pba.kf.intensity,
                                    pba.kf.rgb]):
    assert after.data_ptr() == before.data_ptr()
  assert float(old_poses[0, 2, 3]) == 0.0
  assert float(pba.kf.global_T_frame[0, 2, 3]) == 0.25
  np.testing.assert_array_equal(pba.kf.depth[0].numpy(), kf[0])


def test_delete_keyframe_and_merge_keyframes_match_jax():
  jba, pba = make_pair()
  kf, _ = plane_keyframe()
  for i in range(4):
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = [0.0, 0.02, 0.30, 0.33][i]
    add_keyframe_both(jba, pba, kf, T, 10 * i)
  assert pba.merge_keyframes() == jba.merge_keyframes() == 1
  assert_stores(jba.kf, pba.kf)
  np.testing.assert_array_equal(pba._kf_valid_host, jba._kf_valid_host)
  pba.debug_verify_counts()


def test_state_round_trip_between_the_packages():
  """JAX state -> from_numpy -> to_numpy gives the same arrays back, dtypes
  kept (bool masks, int32 activation/frame_index/count, uint8 rgb), and the
  host mirrors with them."""
  jba, _ = make_pair()
  kf, _ = plane_keyframe()
  jba.add_keyframe(*(jnp.asarray(x) for x in kf),
                   jnp.eye(4, dtype=jnp.float32), 0)
  jba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  pba = port_from_jax(jba)
  assert pba.device == torch.device("cpu")
  assert_stores(jba.surfels, pba.surfels)
  assert_stores(jba.kf, pba.kf)
  assert pba.surfel_count == jba.surfel_count > 100
  assert pba.surfel_watermark == jba.surfel_watermark
  pba.debug_verify_counts()

  surfels_np, kf_np, host = pba.to_numpy()
  jsurfels_np, jkf_np, jhost = jax_state(jba)
  for got, want in ((surfels_np, jsurfels_np), (kf_np, jkf_np)):
    assert set(got) == set(want)
    for name in want:
      assert got[name].dtype == want[name].dtype, name
      np.testing.assert_array_equal(got[name], want[name], err_msg=name)
  assert set(host) == set(jhost)
  for name in jhost:
    np.testing.assert_array_equal(host[name], jhost[name], err_msg=name)
  assert kf_np["rgb"].dtype == np.uint8
  assert kf_np["activation"].dtype == kf_np["count"].dtype == np.int32
  assert surfels_np["valid"].dtype == np.bool_


@pytest.mark.parametrize("field,bad", [
    ("valid", np.zeros(8, np.int32)), ("pos", np.zeros((8, 2), np.float32))])
def test_from_numpy_refuses_a_wrong_dtype_or_shape(field, bad):
  arrays = port_store(surfels.create(8, "cpu"))
  arrays[field] = bad
  with pytest.raises(ValueError, match=field):
    surfels.from_numpy(arrays, "cpu")


def test_stores_are_allocated_on_the_named_device():
  _, pba = make_pair()
  for store in (pba.surfels, pba.kf):
    for name, value in store._asdict().items():
      assert value.device == torch.device("cpu"), name
  assert pba.kf.image_shape == (H, W)
