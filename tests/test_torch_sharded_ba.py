"""The port's distribution (badslam_tpu_torch.parallel) on virtual CPU
meshes: the ``spmd`` primitives against numpy, every function of
``parallel/sharded_ba.py`` against the JAX package's own sharded function on
its 8-device virtual CPU mesh (``tests/conftest.py``), and ``DirectBA``'s
mesh mode against the port's single-device ``DirectBA`` and JAX's mesh
``DirectBA``.

The maps are the JAX tests' (``tests/test_sharded_ba.py``: ``build_map``,
160x120, 3 keyframes, cell 2; ``build_mesh_map``, 64x48, 4 keyframes), made
by the JAX package from seeded numpy inputs and carried into the port with
``from_numpy``. The port runs each mesh position in its own thread (8
shards, or 2 x 4 on the 2-D mesh).

Each sharded result is held to the port's single-device result at the JAX
tests' tolerances, which is what the JAX tests hold JAX's sharded functions
to: the 1-D iteration's surfel positions 1e-5 and poses 1e-4; the PCG
step's poses 2e-4 and positions 2e-3; the 2-D iteration's positions 1e-4
and poses 2e-4; the 2-D growth and insertion exact; the full scheme's poses
1e-4, depth intrinsics 1e-3 px and positions 1e-3, with equal surfel
counts; the joint PCG scheme's poses 2e-4, depth intrinsics 1e-3 px and
positions 2e-3, with equal surfel counts. Against JAX's sharded result the
same tolerances hold where the port's single-device step meets them; where
it does not, the comparison is held to the measured single-device gap (P5,
P11 and P15 of ROADMAP queue 3, the constants below): positions within 10 m
of the origin, and looser bounds for the geometry step of this map and the
joint step with the intrinsics unknowns.
"""

import dataclasses
import random
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from badslam_tpu.parallel import sharded_ba as jsharded
from badslam_tpu_torch.config import BadSlamConfig as PortConfig
from badslam_tpu_torch.models import pcg, pose_opt, surfels as surfels_mod
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.parallel import sharded_ba, spmd
from badslam_tpu_torch.parallel.spmd import Mesh, P
from badslam_tpu_torch.slam.direct_ba import DirectBA as PortDirectBA
from badslam_tpu_torch.utils import synthetic
from tests import test_sharded_ba as jax_tests
from tests.test_torch_ba_fixtures import jax_state, port_from_jax


@pytest.fixture(scope="module", autouse=True)
def one_thread():
  """One torch thread per mesh position's thread."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def mesh_1d(n=8):
  return Mesh(["cpu"] * n, (sharded_ba.SURFEL_AXIS,))


def mesh_2d():
  return Mesh(np.array(["cpu"] * 8, dtype=object).reshape(2, 4),
              (sharded_ba.KF_AXIS, sharded_ba.SURFEL_AXIS))


def jax_mesh_1d():
  return JaxMesh(np.asarray(jax.devices()[:8]), (jsharded.SURFEL_AXIS,))


def jax_mesh_2d():
  return JaxMesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                 (jsharded.KF_AXIS, jsharded.SURFEL_AXIS))


# --- the primitives ---


def test_collectives_on_a_1d_mesh_match_numpy():
  rng = np.random.default_rng(0)
  x = rng.standard_normal((64, 3)).astype(np.float32)
  counts = rng.integers(0, 100, 64).astype(np.int32)

  def fn(xl, cl):
    i = spmd.axis_index("surfels")
    return (spmd.psum(xl.sum(dim=0), "surfels"),
            spmd.psum(cl.sum().to(torch.int32), "surfels"),
            spmd.pmax(xl.max(), "surfels"),
            spmd.psum(i, "surfels"), i * torch.ones_like(cl), xl * 2)

  total, count, biggest, index_sum, index, doubled = spmd.shard_map(
      fn, mesh_1d(), (P("surfels"), P("surfels")),
      (P(), P(), P(), P(), P("surfels"), P("surfels")))(
          torch.from_numpy(x), torch.from_numpy(counts))
  np.testing.assert_allclose(total.numpy(), x.sum(axis=0), rtol=1e-6)
  assert count.dtype == torch.int32 and int(count) == counts.sum()
  assert float(biggest) == x.max()
  assert index_sum == sum(range(8))
  np.testing.assert_array_equal(np.asarray(index), np.repeat(np.arange(8), 8))
  np.testing.assert_array_equal(np.asarray(doubled), 2 * x)


def test_collectives_on_a_2d_mesh_match_numpy():
  rng = np.random.default_rng(1)
  a = rng.standard_normal(8).astype(np.float32)    # along surfels (4)
  b = rng.standard_normal(6).astype(np.float32)    # along kf (2)

  def fn(al, bl):
    return (spmd.psum(al.sum(), "surfels"), spmd.psum(bl.sum(), "kf"),
            spmd.psum(al.sum(), ("kf", "surfels")),
            (spmd.axis_index("kf"), spmd.axis_index("surfels")))

  outs = {}

  def record(al, bl):
    out = fn(al, bl)
    outs[(spmd.axis_index("kf"), spmd.axis_index("surfels"))] = out
    return out[0]

  spmd.shard_map(record, mesh_2d(), (P("surfels"), P("kf")), P())(
      torch.from_numpy(a), torch.from_numpy(b))
  assert sorted(outs) == [(i, j) for i in range(2) for j in range(4)]
  for (i, j), (s_sum, k_sum, both, pos) in outs.items():
    assert pos == (i, j)
    np.testing.assert_allclose(float(s_sum), a.sum(), rtol=1e-6)
    np.testing.assert_allclose(float(k_sum), b.sum(), rtol=1e-6)
    np.testing.assert_allclose(float(both), 2 * a.sum(), rtol=1e-6)


def test_collectives_do_not_depend_on_arrival_order():
  """Seeded sleeps reorder the workers' arrival; the sums keep their bits."""
  x = torch.from_numpy(np.random.default_rng(2).standard_normal(
      (8 * 1000,)).astype(np.float32))
  results = []
  for seed in range(3):
    delays = random.Random(seed).sample(range(8), 8)

    def fn(xl, delays=delays):
      time.sleep(0.002 * delays[spmd.axis_index("surfels")])
      return spmd.psum(xl * xl, "surfels")
    results.append(spmd.shard_map(fn, mesh_1d(), (P("surfels"),), P())(x))
  for r in results[1:]:
    assert torch.equal(r, results[0])


def test_a_failing_worker_is_raised_on_the_caller():
  """One position raises before its collective: the others leave the
  barrier at once (aborted, not timed out) and the caller gets the error."""
  def fn(xl):
    if spmd.axis_index("surfels") == 5:
      raise ValueError("shard 5 failed")
    return spmd.psum(xl.sum(), "surfels")

  start = time.perf_counter()
  with pytest.raises(ValueError, match="shard 5 failed"):
    spmd.shard_map(fn, mesh_1d(), (P("surfels"),), P())(torch.zeros(16))
  assert time.perf_counter() - start < 10.0
  assert not [t for t in threading.enumerate() if t.name.startswith("shard")]


def test_replicas_take_only_the_rows_written():
  """A replica on another device is made once; after ``rows_written`` it
  takes that row and not the tensor; a write that is not reported makes it
  again. The meta device stands in for a second card: the bytes are
  counted, no values move (``tests/test_torch_mesh_cards.py`` checks the
  values across cards)."""
  meta = torch.device("meta")
  x = torch.zeros(4, 3, 2)
  row = x[0].nbytes
  spmd.reset_collective_stats()
  replica = spmd.replicate(x, meta)
  assert replica.device == meta and spmd.replicate(x, meta) is replica
  assert spmd.collective_stats()["replica_bytes"] == x.nbytes
  x[2] = 1.0
  spmd.rows_written(x, 2)
  assert spmd.replicate(x, meta) is replica
  assert spmd.collective_stats()["replica_bytes"] == x.nbytes + row
  x[1] = 2.0
  again = spmd.replicate(x, meta)
  assert again is not replica
  assert spmd.collective_stats()["replica_bytes"] == 2 * x.nbytes + row
  assert spmd.replicate(x, torch.device("cpu")) is x


def test_shards_of_a_one_device_mesh_are_views():
  x = torch.arange(32, dtype=torch.float32)
  sh = spmd.shard(x, mesh_1d(), "surfels")
  base = x.data_ptr()
  assert [b.data_ptr() for b in sh.blocks()] == [base + 16 * i
                                                 for i in range(8)]
  assert torch.equal(sh.gather(), x) and tuple(sh.shape) == (32,)
  with pytest.raises(ValueError, match="does not divide"):
    spmd.shard(torch.zeros(12), mesh_1d(), "surfels")


# --- the library functions against JAX's ---


@pytest.fixture(scope="module")
def jax_map():
  """The JAX tests' three-keyframe map, in JAX, and its state."""
  jba, _ = jax_tests.build_map()
  return jba


def _port_inputs(jba):
  pba = port_from_jax(jba)
  c = pba.calibration
  return pba, (c.a, c.cfactor, c.baseline_fx)


def _cams():
  return (synthetic.default_test_camera(160, 120),) * 2


# Where the port's single-device steps already lie from JAX's on these maps
# (ROADMAP queue 3), measured with both packages on one device: P15, the
# geometry step of build_map within 10 m (9.8e-5 and 1.1e-4 m of steps up to
# 2.2e-3 m) and the pose GN on its surfels (3.2e-4 and 2.5e-4); P11, the
# joint step with the intrinsics unknowns after 15 inner iterations (poses
# 4.7e-4, positions within 10 m 2.6e-3 m, depth intrinsics 1.3e-3 px, color
# intrinsics 0.158 px, cfactor 3.1e-4).
P15_POSITIONS = 2e-4
P15_POSES = 5e-4
P11_LIMITS = dict(poses=1e-3, positions=5e-3, depth_intr=3e-3,
                  color_intr=0.3, a=1e-4, cfactor=1e-3)


def _near(jpos):
  """The surfels within 10 m: the plane scene's steep planes reach 180 m,
  where a float32 ulp of a position is 1.5e-5 m, and the two packages'
  positions differ there by rounding (ROADMAP queue 3, P5)."""
  return np.linalg.norm(np.asarray(jpos), axis=1) < 10.0


def _single_iteration(pba, max_pose_iterations=30):
  """The port's single-device counterpart of one sharded iteration."""
  from badslam_tpu_torch.models import geometry_opt
  cams = _cams()
  s = geometry_opt.optimize_geometry_iteration(pba.surfels, pba.kf, *cams,
                                               pba.calibration)
  optimize = pba.kf.valid & (pba.kf.activation != 0)
  T, _ = pose_opt.estimate_frame_poses_batched(
      pba.kf.global_T_frame, optimize, s, pba.kf.depth, pba.kf.normals,
      pba.kf.intensity, *cams, pba.calibration,
      max_iterations=max_pose_iterations)
  return s.pos.numpy(), T.numpy()


def _hold(port, single, jax_value, tol, jax_tol, mask=None, what=""):
  """The sharded port result against the port's single-device one at the
  JAX tests' tolerance, and against JAX's sharded one at ``jax_tol``
  (within ``mask``)."""
  port, jax_value = np.asarray(port), np.asarray(jax_value)
  np.testing.assert_allclose(port, single, rtol=0, atol=tol,
                             err_msg=f"{what} against one device")
  if mask is not None:
    port, jax_value = port[mask], jax_value[mask]
  np.testing.assert_allclose(port, jax_value, rtol=0, atol=jax_tol,
                             err_msg=f"{what} against JAX")


def test_sharded_ba_iteration_matches_jax(jax_map):
  jba = jax_map
  jmesh = jax_mesh_1d()
  jstep = jsharded.make_sharded_ba_iteration(jmesh, *jax_tests_cams(),
                                             cell_size=jba.cell_size)
  js, jkf, jconv = jstep(jsharded.shard_surfels(jba.surfels, jmesh), jba.kf,
                         jba.a, jba.cfactor, jba.baseline_fx)

  pba, params = _port_inputs(jba)
  mesh = mesh_1d()
  step = sharded_ba.make_sharded_ba_iteration(mesh, *_cams(), cell_size=2)
  ps, pkf, pconv = step(sharded_ba.shard_surfels(pba.surfels, mesh), pba.kf,
                        *params)
  assert isinstance(ps.pos, spmd.Sharded)
  pos, T = _single_iteration(pba)
  _hold(ps.pos, pos, js.pos, 1e-5, P15_POSITIONS, _near(js.pos),
        "positions")
  _hold(pkf.global_T_frame, T, jkf.global_T_frame, 1e-4, P15_POSES, None,
        "poses")
  np.testing.assert_array_equal(pkf.activation.numpy(),
                                np.asarray(jkf.activation))
  assert int(pconv) == int(jconv)


def jax_tests_cams():
  from badslam_tpu.utils import synthetic as jsynthetic
  return (jsynthetic.default_test_camera(160, 120),) * 2


def test_sharded_ba_improves_poses(jax_map):
  """The counterpart of the JAX test of the same name, on the port alone:
  three sharded iterations shrink the spread of the keyframes' errors."""
  pba, params = _port_inputs(jax_map)
  mesh = mesh_1d()
  step = sharded_ba.make_sharded_ba_iteration(mesh, *_cams(), cell_size=2)
  surfels, kf = sharded_ba.shard_surfels(pba.surfels, mesh), pba.kf

  def errors(T):
    from badslam_tpu_torch.geometry import se3
    return [float(se3.log(se3.inverse(T[i])).abs().max()) for i in range(3)]
  err0 = errors(kf.global_T_frame)
  for _ in range(3):
    surfels, kf, _ = step(surfels, kf, *params)
  err1 = errors(kf.global_T_frame)
  assert np.ptp(err1) < np.ptp(err0) or max(err1) < 1e-4


def _single_pcg(pba, gauge, intrinsics):
  cams = _cams()
  c = pba.calibration
  delta = pcg.pcg_solve(pba.surfels, pba.kf, *cams, c, gauge, 15,
                        opt_dintr=intrinsics, opt_cintr=intrinsics)
  s, kf = pcg.apply_pcg_delta(pba.surfels, pba.kf, delta)
  intr = pcg.apply_pcg_delta_intrinsics(
      c.depth_intr, pba.color_intr, c.a, c.cfactor, delta, intrinsics,
      intrinsics)
  return s.pos.numpy(), kf.global_T_frame.numpy(), [x.numpy() for x in intr]


@pytest.mark.parametrize("intrinsics", [False, True],
                         ids=["poses_and_surfels", "with_intrinsics"])
def test_sharded_pcg_step_matches_jax(jax_map, intrinsics):
  jba = jax_map
  jmesh = jax_mesh_1d()
  flags = dict(opt_dintr=intrinsics, opt_cintr=intrinsics)
  jstep = jsharded.make_sharded_pcg_step(
      jmesh, *jax_tests_cams(), cell_size=jba.cell_size,
      max_inner_iterations=15, **flags)
  jout = jstep(jsharded.shard_surfels(jba.surfels, jmesh), jba.kf, jba.a,
               jba.cfactor, jba.baseline_fx, jnp.asarray(0, jnp.int32))

  pba, params = _port_inputs(jba)
  mesh = mesh_1d()
  step = sharded_ba.make_sharded_pcg_step(mesh, *_cams(), cell_size=2,
                                          max_inner_iterations=15, **flags)
  pout = step(sharded_ba.shard_surfels(pba.surfels, mesh), pba.kf, *params,
              0)
  assert len(pout) == len(jout) == (7 if intrinsics else 3)
  pos, T, intr = _single_pcg(pba, 0, intrinsics)
  if not intrinsics:
    _hold(pout[1].global_T_frame, T, jout[1].global_T_frame, 2e-4, 2e-4,
          None, "poses")
    _hold(pout[0].pos, pos, jout[0].pos, 2e-3, 2e-3, None, "positions")
    return
  _hold(pout[1].global_T_frame, T, jout[1].global_T_frame, 2e-4,
        P11_LIMITS["poses"], None, "poses")
  _hold(pout[0].pos, pos, jout[0].pos, 2e-3, P11_LIMITS["positions"],
        _near(jout[0].pos), "positions")
  # The depth and color intrinsics in pixels, a and cfactor.
  for name, p, single, j in zip(("depth_intr", "color_intr", "a", "cfactor"),
                                pout[2:6], intr, jout[2:6]):
    _hold(p, single, j, 1e-3 if "intr" in name else 1e-4, P11_LIMITS[name],
          None, name)


def _four_keyframe_map():
  """build_map with a fourth keyframe, all active, as the JAX 2-D tests
  make it."""
  from badslam_tpu.geometry import se3 as jse3
  from badslam_tpu.utils import synthetic as jsynthetic
  jba, cam = jax_tests.build_map()
  depth, _ = jsynthetic.make_plane_scene(cam, seed=3)
  kfim = jsynthetic.preprocess_like_test_keyframe(
      depth, cam, intensity=jsynthetic.intensity_function_image(cam), cell=2)
  noise = jnp.asarray([1e-3, -1e-3, 5e-4, 2e-4, -1e-4, 3e-4], jnp.float32)
  jba.add_keyframe(kfim.depth, kfim.normals, kfim.radius_sq, kfim.intensity,
                   kfim.rgb, jse3.exp(noise), 30)
  jba.kf = jba.kf._replace(
      activation=jnp.where(jba.kf.valid, 2, 0).astype(jnp.int32))
  jba.surfels = jba.surfels._replace(active=jba.surfels.valid)
  return jba, kfim


@pytest.fixture(scope="module")
def four_keyframes():
  return _four_keyframe_map()


def test_sharded_ba_iteration_2d_matches_jax(four_keyframes):
  jba, _ = four_keyframes
  jmesh = jax_mesh_2d()
  jstep = jsharded.make_sharded_ba_iteration_2d(
      jmesh, *jax_tests_cams(), cell_size=jba.cell_size,
      max_pose_iterations=10)
  js, jkf, jconv = jstep(jsharded.shard_surfels_2d(jba.surfels, jmesh),
                         jsharded.shard_keyframes_2d(jba.kf, jmesh), jba.a,
                         jba.cfactor, jba.baseline_fx)

  pba, params = _port_inputs(jba)
  mesh = mesh_2d()
  step = sharded_ba.make_sharded_ba_iteration_2d(
      mesh, *_cams(), cell_size=2, max_pose_iterations=10)
  ps, pkf, pconv = step(sharded_ba.shard_surfels_2d(pba.surfels, mesh),
                        sharded_ba.shard_keyframes_2d(pba.kf, mesh), *params)
  pos, T = _single_iteration(pba, max_pose_iterations=10)
  _hold(ps.pos, pos, js.pos, 1e-4, P15_POSITIONS, _near(js.pos),
        "positions")
  _hold(pkf.global_T_frame, T, jkf.global_T_frame, 2e-4, P15_POSES, None,
        "poses")
  assert int(pconv) == int(jconv)


def test_sharded_pcg_step_2d_matches_jax(four_keyframes):
  """The gauge on keyframe 2, which lives on the second kf shard."""
  jba, _ = four_keyframes
  jmesh = jax_mesh_2d()
  jstep = jsharded.make_sharded_pcg_step_2d(
      jmesh, *jax_tests_cams(), cell_size=jba.cell_size,
      max_inner_iterations=15)
  js, jkf, jupd = jstep(jsharded.shard_surfels_2d(jba.surfels, jmesh),
                        jsharded.shard_keyframes_2d(jba.kf, jmesh), jba.a,
                        jba.cfactor, jba.baseline_fx,
                        jnp.asarray(2, jnp.int32))

  pba, params = _port_inputs(jba)
  mesh = mesh_2d()
  step = sharded_ba.make_sharded_pcg_step_2d(mesh, *_cams(), cell_size=2,
                                             max_inner_iterations=15)
  ps, pkf, pupd = step(sharded_ba.shard_surfels_2d(pba.surfels, mesh),
                       sharded_ba.shard_keyframes_2d(pba.kf, mesh), *params,
                       torch.tensor(2, dtype=torch.int32))
  pos, T, _ = _single_pcg(pba, 2, False)
  _hold(pkf.global_T_frame, T, jkf.global_T_frame, 2e-4, 2e-4, None, "poses")
  _hold(ps.pos, pos, js.pos, 2e-3, 2e-3, None, "positions")
  np.testing.assert_allclose(float(pupd), float(jupd), atol=2e-4)


def test_keyframe_growth_and_insertion_2d_match_jax():
  """Grow the kf-sharded store from 4 to 8 slots, insert a keyframe into
  slot 5 (the second kf shard): every field equals JAX's. (JAX's insertion
  donates the store, so the map is this test's own.)"""
  from badslam_tpu.geometry import se3 as jse3
  from badslam_tpu.utils import synthetic as jsynthetic
  jba, _ = jax_tests.build_map()
  pba, _ = _port_inputs(jba)
  jmesh = jax_mesh_2d()
  cam = jax_tests_cams()[0]
  depth, _ = jsynthetic.make_plane_scene(cam, seed=3)
  kfim = jsynthetic.preprocess_like_test_keyframe(
      depth, cam, intensity=jsynthetic.intensity_function_image(cam), cell=2)
  noise = jnp.asarray([8e-4, -6e-4, 4e-4, 1e-4, -2e-4, 1e-4], jnp.float32)
  T = jse3.exp(noise)
  covis_row = np.zeros((8,), bool)
  covis_row[0] = True
  jkf = jsharded.grow_keyframes_2d(
      jsharded.shard_keyframes_2d(jba.kf, jmesh), jmesh, 8)
  jkf = jsharded.make_add_keyframe_2d(jmesh)(
      jkf, jnp.asarray(5, jnp.int32), kfim.depth, kfim.normals,
      kfim.radius_sq, kfim.intensity, kfim.rgb, T, jnp.asarray(50, jnp.int32),
      jnp.asarray(0.5, jnp.float32), jnp.asarray(5.0, jnp.float32),
      jnp.asarray(covis_row))

  mesh = mesh_2d()
  pkf = sharded_ba.grow_keyframes_2d(
      sharded_ba.shard_keyframes_2d(pba.kf, mesh), mesh, 8)
  assert pkf.capacity == 8
  t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
  pkf = sharded_ba.make_add_keyframe_2d(mesh)(
      pkf, 5, t(kfim.depth), t(kfim.normals), t(kfim.radius_sq),
      t(kfim.intensity), t(kfim.rgb), t(T), 50, 0.5, 5.0, t(covis_row))
  for name in pkf._fields:
    p = np.asarray(getattr(pkf, name))
    j = np.asarray(getattr(jkf, name))
    assert p.dtype == j.dtype and p.shape == j.shape, name
    np.testing.assert_array_equal(p, j, err_msg=name)
  assert int(pkf.count) == 6 and np.asarray(pkf.valid).sum() == 4


# --- DirectBA's mesh mode ---


def _port_ba(jba, mesh, width=64, height=48):
  """The port's DirectBA continuing from a JAX DirectBA's state, over
  ``mesh`` (or on one device)."""
  cam = synthetic.default_test_camera(width, height)
  surfels, kf, host = jax_state(jba)
  calib = DepthCalibration.from_numpy(
      np.asarray(jba.depth_intr), np.asarray(jba.a), np.asarray(jba.cfactor),
      np.asarray(jba.baseline_fx), jba.cell_size, jba.depth_size, "cpu")
  pba = PortDirectBA.from_numpy(
      PortConfig(**dataclasses.asdict(jba.config)), cam, cam, surfels, kf,
      calib, host, "cpu", mesh=mesh)
  pba.color_intr.copy_(torch.from_numpy(np.array(jba.color_intr)))
  return pba


def test_directba_mesh_full_scheme_matches_single_device_and_jax():
  """The full alternation (creation, activation, geometry, merge, pose,
  intrinsics, the end tasks) over 4 shards, against the port's
  single-device scheme and JAX's mesh DirectBA (8 devices), 3 iterations
  with optimize_depth_intrinsics."""
  jstart = jax_tests.build_mesh_map(None)
  pm = _port_ba(jstart, mesh_1d(4))
  ps = _port_ba(jstart, None)
  jm = jax_tests.build_mesh_map(jax_mesh_1d())
  for ba in (pm, ps, jm):
    ba.bundle_adjustment(max_iterations=3, optimize_depth_intrinsics=True)
  for other, intr in ((ps, ps.calibration.depth_intr.numpy()),
                      (jm, np.asarray(jm.depth_intr))):
    assert pm.surfel_count == other.surfel_count
    np.testing.assert_allclose(pm.kf.global_T_frame.numpy(),
                               np.asarray(other.kf.global_T_frame),
                               atol=1e-4)
    np.testing.assert_allclose(pm.calibration.depth_intr.numpy(), intr,
                               atol=1e-3)
    np.testing.assert_allclose(pm.surfels.pos.numpy(),
                               np.asarray(other.surfels.pos), atol=1e-3)
  assert pm.mesh_gathers > 0 and pm.mesh_gather_bytes > 0


@pytest.mark.parametrize("transfer_free", [False, True],
                         ids=["host", "transfer_free"])
def test_directba_mesh_pcg_scheme_matches_single_device_and_jax(
    transfer_free):
  """The joint PCG scheme (``use_pcg``, the depth-intrinsics unknowns in
  the solve) over 4 shards, on the host path and transfer-free (the
  pipelined front-end's: a fixed window, done flags polled on the device),
  against the port's single-device scheme and JAX's mesh DirectBA (8
  devices), 3 iterations, at the PCG tolerances: poses 2e-4, positions
  2e-3, depth intrinsics 1e-3 px, equal surfel counts. A second mesh run
  from the same state gives the same bits."""
  jstart = jax_tests.build_mesh_map(None)
  window = (dict(active_keyframe_window_start=0,
                 active_keyframe_window_end=jstart.keyframe_count - 1)
            if transfer_free else {})
  pm, pm2 = _port_ba(jstart, mesh_1d(4)), _port_ba(jstart, mesh_1d(4))
  ps = _port_ba(jstart, None)
  jm = jax_tests.build_mesh_map(jax_mesh_1d())
  for ba in (pm, pm2, ps, jm):
    ba.config = dataclasses.replace(ba.config, use_pcg=True)
    ba.bundle_adjustment(max_iterations=3, optimize_depth_intrinsics=True,
                         transfer_free=transfer_free, **window)
  for other, intr in ((ps, ps.calibration.depth_intr.numpy()),
                      (jm, np.asarray(jm.depth_intr))):
    assert pm.surfel_count == other.surfel_count
    np.testing.assert_allclose(pm.kf.global_T_frame.numpy(),
                               np.asarray(other.kf.global_T_frame),
                               atol=2e-4)
    np.testing.assert_allclose(pm.calibration.depth_intr.numpy(), intr,
                               atol=1e-3)
    np.testing.assert_allclose(pm.surfels.pos.numpy(),
                               np.asarray(other.surfels.pos), atol=2e-3)
  np.testing.assert_array_equal(pm.kf.global_T_frame.numpy(),
                                pm2.kf.global_T_frame.numpy())
  for name, value in pm.to_numpy()[0].items():
    np.testing.assert_array_equal(value, pm2.to_numpy()[0][name],
                                  err_msg=name)


def test_directba_mesh_capacity_growth():
  """Growth under the mesh keeps the shards even (a capacity that is not a
  multiple of 8 is rounded up), appends at the watermark across shard
  boundaries, and the state reads back in the single-device slot order."""
  jstart = jax_tests.build_mesh_map(None, surfel_capacity=256)
  surfels, kf, host = jax_state(jstart)
  watermark = int(surfels["count"])
  cap = watermark + 3 if (watermark + 3) % 8 else watermark + 5
  cut = {k: (np.concatenate([v[:cap], np.zeros(
      (max(0, cap - len(v)),) + v.shape[1:], v.dtype)])
             if k != "count" else v) for k, v in surfels.items()}
  cam = synthetic.default_test_camera(64, 48)
  calib = DepthCalibration.from_numpy(
      np.asarray(jstart.depth_intr), np.asarray(jstart.a),
      np.asarray(jstart.cfactor), np.asarray(jstart.baseline_fx),
      jstart.cell_size, jstart.depth_size, "cpu")
  cfg = PortConfig(**dataclasses.asdict(jstart.config))
  pm = PortDirectBA.from_numpy(cfg, cam, cam, cut, kf, calib, host, "cpu",
                               mesh=mesh_1d())
  assert pm.surfel_capacity == -(-cap // 8) * 8 > cap
  ps = PortDirectBA.from_numpy(cfg, cam, cam, cut, kf, calib.clone(), host,
                               "cpu")
  for ba in (pm, ps):
    ba.create_surfels_for_keyframe(1, filter_new_surfels=True)
    ba.perform_ba_scheme_end_tasks()
  assert pm.surfel_capacity % 8 == 0 and pm.surfel_capacity >= 2 * cap
  assert pm.surfel_count == ps.surfel_count > 0
  assert pm.surfel_watermark == ps.surfel_watermark
  m_surfels, _, _ = pm.to_numpy()
  s_surfels, _, _ = ps.to_numpy()
  n = ps.surfel_capacity
  for name in ("pos", "valid", "radius_sq", "desc"):
    np.testing.assert_allclose(m_surfels[name][:n], s_surfels[name],
                               atol=1e-6, err_msg=name)
  assert not m_surfels["valid"][n:].any()


def test_mesh_ba_is_bitwise_repeatable():
  """Two mesh BA runs (4 shards) from one state give the same poses and
  stores, bit for bit: the cross-shard sums are in mesh order."""
  jstart = jax_tests.build_mesh_map(None)
  runs = []
  for _ in range(2):
    ba = _port_ba(jstart, mesh_1d(4))
    ba.bundle_adjustment(max_iterations=2)
    runs.append((ba.kf.global_T_frame.numpy(), ba.to_numpy()[0]))
  np.testing.assert_array_equal(runs[0][0], runs[1][0])
  for name, value in runs[0][1].items():
    np.testing.assert_array_equal(value, runs[1][1][name], err_msg=name)


def test_pose_intrinsics_and_pcg_sums_over_shards_match_one_device():
  """The psum'd pose GN, intrinsics step and PCG self-check on 4 shards
  against the same calls on the whole store."""
  from badslam_tpu_torch.models import intrinsics_opt
  jstart = jax_tests.build_mesh_map(None)
  ba = _port_ba(jstart, None)
  ba.surfels = ba.surfels._replace(active=ba.surfels.valid)
  ba.kf = ba.kf._replace(activation=torch.where(ba.kf.valid, 2, 0).to(
      torch.int32))
  v = ba._view(None)
  mesh = mesh_1d(4)
  optimize = v.kf.valid

  def calls(surfels, axis):
    T, _ = pose_opt.estimate_frame_poses_batched(
        v.kf.global_T_frame, optimize, surfels, v.kf.depth, v.kf.normals,
        v.kf.intensity, v.depth_cam, v.color_cam, v.calibration,
        max_iterations=5, axis=axis)
    intr = intrinsics_opt.optimize_intrinsics(
        surfels, v.kf, v.calibration, v.color_intr, ba.color_size, True,
        True, axis=axis)
    delta = pcg.pcg_solve(surfels, v.kf, v.depth_cam, v.color_cam,
                          v.calibration, 0, 5, axis_name=axis)
    check = pcg.debug_verify_result(delta, surfels, v.kf, v.depth_cam,
                                    v.color_cam, v.calibration, 0,
                                    axis_name=axis)
    return T, intr, delta.poses, check

  whole = calls(ba.surfels, None)
  sharded = spmd.shard_map(lambda s: calls(s, "surfels"), mesh,
                           (sharded_ba.surfel_specs(),), P())(
      sharded_ba.shard_surfels(ba.surfels, mesh))
  np.testing.assert_allclose(sharded[0].numpy(), whole[0].numpy(), atol=1e-5)
  for p, w in zip(sharded[1], whole[1]):
    np.testing.assert_allclose(p.numpy(), w.numpy(), rtol=1e-4, atol=1e-5)
  np.testing.assert_allclose(sharded[2].numpy(), whole[2].numpy(),
                             atol=1e-5)
  for p, w in zip(sharded[3], whole[3]):
    np.testing.assert_allclose(float(p), float(w), rtol=1e-3)


def test_shard_surfels_needs_an_even_capacity():
  with pytest.raises(ValueError, match="does not divide"):
    sharded_ba.shard_surfels(surfels_mod.create(100, "cpu"), mesh_1d())
