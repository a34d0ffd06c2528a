"""The port's BA models (association, cost, pose_opt, geometry_opt of
badslam_tpu_torch.models) against the JAX package on one map state, and the
analytic Jacobians against torch.autograd.

The state: three keyframes of the plane scene (identical images, the first
at the identity, the others at perturbed poses) and the surfels the first
one creates, made by the JAX package and carried over with ``from_numpy``.

Tolerances: association masks equal but for at most 2 of N lanes, each
within 1e-5 (relative) of a threshold, float fields 1e-5 on lanes both
sides associate; H and b within 1e-5 of max|H| and max|b|, residual counts
equal; batched pose GN poses 1e-5, ``moved`` equal; geometry accumulators
1e-5 of each one's largest value; ``solve_and_update`` positions 1e-6 m and
descriptors 1e-3 on the surfels within 10 m of the origin; Jacobians
against autograd 2e-3 (absolute and relative), as the reference's test
against JAX autodiff.

Two limits of the fixture, not of the port (ROADMAP queue 3 has the
numbers). The plane scene's steep planes reach 180 m, where one float32 ulp
of a position is 1.5e-5 m, so positions are held to 1e-6 m within 10 m only
(1,321 of 1,687 surfels). And with descriptor residuals alone the 3x3
system of a surfel that all keyframes see from nearly one pose is singular
(an offset along the normal and a descriptor change explain the same
residual), so its solution is rounding noise in both packages: that mode
compares the accumulators only. The pose GN test runs on the state without
the added noise, where GN converges; on the noisy state the robust weights
make it oscillate at the 1e-3 convergence threshold in both packages, and an
oscillation amplifies rounding.

The BA pose phase's shared loop (``estimate_frame_poses_batched``) is held
on the CPU, with the kernels' plain versions, to each lane's own
``estimate_frame_pose`` bit for bit. The ``pose_h_b`` kernels are held on
the card (``cuda``-marked cases, on a map the port builds there, since that
machine has no JAX) against the plain version on the card: residual counts
equal; H and b within 5e-5 of the magnitude of their summands, on the
surfels whose descriptor sample points lie off the edges of their bilinear
tap cells (where the gradient jumps); the whole pose GN's poses within
1e-5 and ``moved`` equal.
"""

import numpy as np
import pytest
import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import association, cost, geometry_opt, pose_opt
from badslam_tpu_torch.ops import pose_h_b
from badslam_tpu_torch.utils import synthetic
from badslam_tpu_torch.utils.timing import Timing

try:
  import jax
  import jax.numpy as jnp
  from badslam_tpu.geometry import se3 as jse3
  from badslam_tpu.models import association as jassociation
  from badslam_tpu.models import cost as jcost
  from badslam_tpu.models import geometry_opt as jgeometry_opt
  from badslam_tpu.models import pose_opt as jpose_opt
  from badslam_tpu.slam import direct_ba as jdirect_ba
  from tests.test_torch_ba_fixtures import (
      cameras, make_pair, perturbed_pose, plane_keyframe, port_from_jax)
except ImportError:  # the card's machine: only the cuda-marked cases run
  jax = None


def _make_state(noisy):
  jba, _ = make_pair()
  kf, _ = plane_keyframe(seed=3)
  rng = np.random.default_rng(0)
  poses = [np.eye(4, dtype=np.float32), perturbed_pose(rng),
           perturbed_pose(rng)]
  for i, T in enumerate(poses):
    jba.add_keyframe(*(jnp.asarray(x) for x in kf), jnp.asarray(T), 10 * i)
  jba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  n = jba.surfels.capacity
  s = jba.surfels._replace(active=jba.surfels.valid)
  if noisy:
    s = s._replace(
        pos=s.pos + jnp.asarray(rng.normal(0, 5e-4, (n, 3)), jnp.float32),
        desc=s.desc + jnp.asarray(rng.normal(0, 2.0, (n, 2)), jnp.float32))
  jba.surfels = s
  pba = port_from_jax(jba)
  assert pba.surfel_count == jba.surfel_count > 1000
  return jba, pba


@pytest.fixture(scope="module")
def state():
  """Descriptors and positions a little off, so that every residual and
  every accumulator is non-zero."""
  return _make_state(noisy=True)


@pytest.fixture(scope="module")
def clean_state():
  return _make_state(noisy=False)


def _near(pba):
  """Valid surfels within 10 m of the origin."""
  return (pba.surfels.valid
          & (pba.surfels.pos.norm(dim=-1) < 10.0)).numpy()


def _jax_args(jba):
  """Cameras as the reference's DirectBA passes them to its phases:
  intrinsics as arrays. (With a camera of Python floats its batched pose GN
  moves a lane that is converged from the start by 1e-3; ROADMAP queue 3.)"""
  w, h = jba.depth_size
  return (jdirect_ba.make_camera(jba.depth_intr, w, h),
          jdirect_ba.make_camera(jba.color_intr, w, h), jba.depth_params())


def _port_args(pba):
  return (pba.depth_camera(), pba.color_camera(), pba.depth_params())


def _associate_both(jba, pba, k):
  jcam, _, jdp = _jax_args(jba)
  pcam, _, pdp = _port_args(pba)
  js, ps = jba.surfels, pba.surfels
  ja = jassociation.associate_surfels(
      js.pos, js.normal, js.valid, jse3.inverse(jba.kf.global_T_frame[k]),
      jba.kf.depth[k], jba.kf.normals[k], jcam, jdp)
  pa = association.associate_surfels(
      ps.pos, ps.normal, ps.valid, se3.inverse(pba.kf.global_T_frame[k]),
      pba.kf.depth[k], pba.kf.normals[k], pcam, pdp)
  return ja, pa


@pytest.mark.parametrize("k", [0, 1, 2])
def test_associate_surfels_matches_jax(state, k):
  jba, pba = state
  ja, pa = _associate_both(jba, pba, k)
  n = pba.surfels.capacity
  assert int(pa.mask.sum()) > 1000
  for name in ("mask", "free_space_violation", "observed"):
    j, p = np.asarray(getattr(ja, name)), getattr(pa, name).numpy()
    off = np.flatnonzero(j != p)
    assert len(off) <= 2, (name, len(off), n)
    # A lane may only differ where a comparison sits on its threshold.
    depth_diff = np.abs(np.asarray(ja.calibrated_depth)
                        - np.asarray(ja.local_pos)[:, 2])[off]
    threshold = 10.0 / np.asarray(ja.inv_stddev)[off]
    assert np.all(np.abs(depth_diff - threshold) <= 1e-5 * threshold), name
  both = np.asarray(ja.mask) & pa.mask.numpy()
  for name in ("local_pos", "local_normal", "pxy", "calibrated_depth"):
    np.testing.assert_allclose(
        getattr(pa, name).numpy()[both], np.asarray(getattr(ja, name))[both],
        rtol=0, atol=1e-5, err_msg=name)
  np.testing.assert_allclose(pa.inv_stddev.numpy()[both],
                             np.asarray(ja.inv_stddev)[both], rtol=1e-5)
  for name in ("px", "py"):
    np.testing.assert_array_equal(getattr(pa, name).numpy()[both],
                                  np.asarray(getattr(ja, name))[both])


def test_association_keeps_non_finite_lanes_out():
  """Invalid slots (all zeros) and surfels behind or beside the camera give
  inf or NaN further down; none may reach an integer cast or a mask."""
  _, pba = make_pair(initial_surfel_capacity=8)
  kf, _ = plane_keyframe(seed=3)
  pba.add_keyframe(*(torch.from_numpy(x.copy()) for x in kf),
                   torch.eye(4), 0)
  pba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  pos = torch.tensor([[0, 0, 0], [0, 0, -1], [1e30, 0, 1e-30],
                      [float("nan"), 0, 1], [0, 0, 0], [0, 0, float("inf")],
                      [0, 0, 1e-38], [5.0, 0, 1e-20]])
  normal = torch.tensor([[0.0, 0, -1]]).repeat(8, 1)
  pos[4], normal[4] = pba.surfels.pos[0], pba.surfels.normal[0]  # a real one
  a = association.associate_surfels(
      pos, normal, torch.ones(8, dtype=torch.bool), torch.eye(4),
      pba.kf.depth[0], pba.kf.normals[0], pba.depth_camera(),
      pba.depth_params())
  assert a.mask.tolist() == [False] * 4 + [True] + [False] * 3, a
  assert not a.free_space_violation[:4].any()
  assert int(a.px.min()) >= 0 and int(a.px.max()) < 160
  assert int(a.py.min()) >= 0 and int(a.py.max()) < 120


def test_cost_helpers_match_jax(state):
  jba, pba = state
  jcam, jcolor, _ = _jax_args(jba)
  pcam, pcolor, _ = _port_args(pba)
  js, ps = jba.surfels, pba.surfels
  valid = ps.valid.numpy()
  jT = jse3.inverse(jba.kf.global_T_frame[1])
  pT = se3.inverse(pba.kf.global_T_frame[1])
  jt = jcost.tangent_projections(js.pos, js.normal, js.radius_sq,
                                 jT[0:3, 0:3], jT[0:3, 3], jcolor)
  pt = cost.tangent_projections(ps.pos, ps.normal, ps.radius_sq,
                                pT[0:3, 0:3], pT[0:3, 3], pcolor)
  for j, p in zip(jt, pt):
    np.testing.assert_allclose(p.numpy()[valid], np.asarray(j)[valid],
                               rtol=0, atol=2e-4)  # pixels, at |px| ~ 100
  ja, pa = _associate_both(jba, pba, 1)
  # The same sample positions on both sides, so that only the samplers and
  # the residual arithmetic are compared.
  pxy, t1, t2 = (np.asarray(ja.pxy), np.asarray(jt[0]), np.asarray(jt[1]))
  inten = np.asarray(jba.kf.intensity[1])
  jr = jcost.raw_descriptor_residual(
      jnp.asarray(inten), jnp.asarray(pxy), jnp.asarray(t1), jnp.asarray(t2),
      js.desc)
  pr = cost.raw_descriptor_residual(
      torch.from_numpy(inten.copy()), torch.from_numpy(pxy.copy()),
      torch.from_numpy(t1.copy()), torch.from_numpy(t2.copy()), ps.desc)
  jg = jcost.descriptor_grads(jnp.asarray(inten), jnp.asarray(pxy),
                              jnp.asarray(t1), jnp.asarray(t2))
  pg = cost.descriptor_grads(
      torch.from_numpy(inten.copy()), torch.from_numpy(pxy.copy()),
      torch.from_numpy(t1.copy()), torch.from_numpy(t2.copy()))
  jf = jcost.descriptor_terms_fused(jnp.asarray(inten), jnp.asarray(pxy),
                                    jnp.asarray(t1), jnp.asarray(t2), js.desc)
  pf = cost.descriptor_terms_fused(
      torch.from_numpy(inten.copy()), torch.from_numpy(pxy.copy()),
      torch.from_numpy(t1.copy()), torch.from_numpy(t2.copy()), ps.desc)
  for j, p in zip(jr + jg + jf, pr + pg + pf):
    np.testing.assert_allclose(p.numpy()[valid], np.asarray(j)[valid],
                               rtol=0, atol=1e-4)  # residuals up to 180


@pytest.mark.parametrize("use_depth,use_desc", [
    (True, False), (False, True), (True, True)],
    ids=["depth", "descriptors", "both"])
def test_accumulate_pose_h_b_matches_jax(state, use_depth, use_desc):
  jba, pba = state
  k = 1
  jH, jb, jcost_, jn = jpose_opt.accumulate_pose_h_b(
      jba.kf.global_T_frame[k], jba.surfels, jba.kf.depth[k],
      jba.kf.normals[k], jba.kf.intensity[k], *_jax_args(jba),
      use_depth, use_desc, compute_cost=True)
  pH, pb, pcost, pn = pose_opt.accumulate_pose_h_b(
      pba.kf.global_T_frame[k], pba.surfels, pba.kf.depth[k],
      pba.kf.normals[k], pba.kf.intensity[k], *_port_args(pba),
      use_depth, use_desc, compute_cost=True)
  jH, jb = np.asarray(jH), np.asarray(jb)
  assert np.abs(jH).max() > 0 and np.abs(jb).max() > 0
  np.testing.assert_allclose(pH.numpy(), jH, rtol=0,
                             atol=1e-5 * np.abs(jH).max())
  np.testing.assert_allclose(pb.numpy(), jb, rtol=0,
                             atol=1e-5 * np.abs(jb).max())
  assert int(pn) == int(jn) > 1000
  np.testing.assert_allclose(float(pcost), float(jcost_), rtol=1e-5)


def test_estimate_frame_poses_batched_matches_jax(clean_state):
  """Three keyframes, two of them perturbed; slot 3 of the store is empty
  and stays out. The port's shared loop (the kernels' plain versions on
  the CPU) against the reference's shared loop with per-keyframe lanes."""
  jba, pba = clean_state
  optimize = np.array([True, True, True, False])
  # The reference's function as its DirectBA runs it: inside the jitted
  # pose phase, which optimizes every valid keyframe that is not inactive
  # and sets the activation from ``moved``.
  w, h = jba.depth_size
  jkf, _ = jdirect_ba._pose_optimization_jit(
      jba.surfels, jba.kf, jba.depth_intr, jba.color_intr, jba.a,
      jba.cfactor, jba.baseline_fx, w, h, w, h, jba.cell_size, True, True, 30)
  jT = jkf.global_T_frame
  jmoved = jkf.activation == 2
  np.testing.assert_array_equal(
      np.asarray(jba.kf.valid & (jba.kf.activation != 0)), optimize)
  pT, pmoved = pose_opt.estimate_frame_poses_batched(
      pba.kf.global_T_frame, torch.from_numpy(optimize), pba.surfels,
      pba.kf.depth, pba.kf.normals, pba.kf.intensity, *_port_args(pba))
  np.testing.assert_allclose(pT.numpy(), np.asarray(jT), rtol=0, atol=1e-5)
  np.testing.assert_array_equal(pmoved.numpy(), np.asarray(jmoved))
  assert pmoved.tolist() == [False, True, True, False]
  np.testing.assert_array_equal(pT[3].numpy(), np.eye(4, dtype=np.float32))
  # The perturbed keyframes came back onto the first one.
  rel = se3.log(se3.inverse(pT[0]) @ pT[1:3]).abs().max()
  assert float(rel) < 2e-4
  # With the slots given as host ints no mask is read back; same result.
  pT2, _ = pose_opt.estimate_frame_poses_batched(
      pba.kf.global_T_frame, torch.from_numpy(optimize), pba.surfels,
      pba.kf.depth, pba.kf.normals, pba.kf.intensity, *_port_args(pba),
      slots=[0, 1, 2])
  np.testing.assert_array_equal(pT2.numpy(), pT.numpy())


def _count_h_b_calls(monkeypatch):
  """A list that gains one entry per call of accumulate_pose_h_b."""
  calls = []
  real = pose_opt.accumulate_pose_h_b

  def counted(*args, **kwargs):
    calls.append(1)
    return real(*args, **kwargs)

  monkeypatch.setattr(pose_opt, "accumulate_pose_h_b", counted)
  return calls


@pytest.mark.parametrize("noisy,max_iterations,transfer_free", [
    (False, 30, False), (False, 2, False), (True, 5, False),
    (False, 30, True)],
    ids=["clean", "clean-cap2", "noisy-cap5", "clean-transfer-free"])
def test_shared_loop_freezes_lanes_like_estimate_frame_pose(
    state, clean_state, monkeypatch, noisy, max_iterations, transfer_free):
  """The shared loop on the CPU (the kernels' plain versions) gives each
  lane the pose of its own ``estimate_frame_pose`` loop bit for bit: a lane
  takes the step that converges it and then holds still, and the loop runs
  as long as its slowest lane. The counters record the shared steps and the
  lanes open at each, summed; with ``transfer_free`` no count is read, so
  only the steps are recorded."""
  _, pba = state if noisy else clean_state
  kf = pba.kf
  optimize = torch.tensor([True, True, True, False])
  calls = _count_h_b_calls(monkeypatch)
  want, steps = [], []
  for k in range(3):
    before = len(calls)
    T, _ = pose_opt.estimate_frame_pose(
        kf.global_T_frame[k], pba.surfels, kf.depth[k], kf.normals[k],
        kf.intensity[k], *_port_args(pba), max_iterations=max_iterations)
    want.append(T)
    steps.append(len(calls) - before)
  assert len(set(steps)) > 1  # the lanes converge at different steps
  del calls[:]
  with Timing.isolated() as stats:
    got, _ = pose_opt.estimate_frame_poses_batched(
        kf.global_T_frame, optimize, pba.surfels, kf.depth, kf.normals,
        kf.intensity, *_port_args(pba), max_iterations=max_iterations,
        transfer_free=transfer_free)
  for k in range(3):
    assert torch.equal(got[k], want[k]), k
  assert torch.equal(got[3], kf.global_T_frame[3])
  # Under either ending every lane is computed at every step, and a done
  # lane's result dropped: the host never reads which lanes are open.
  assert len(calls) == 3 * max(steps)
  assert stats["BA pose GN steps"].samples == [max(steps)]
  assert stats["BA pose GN steps"].counter
  if transfer_free:
    assert "BA pose lane steps" not in stats
  else:
    assert stats["BA pose lane steps"].samples == [sum(steps)]


def test_pose_h_b_launchers_refuse_non_cuda_tensors(clean_state):
  """The kernels' launchers take CUDA tensors only: a CPU or meta tensor
  raises and launches nothing (the shared loop takes the plain versions
  for CPU tensors)."""
  _, pba = clean_state
  kf = pba.kf
  k = kf.capacity
  done = torch.zeros((k,), dtype=torch.bool)
  out = (torch.zeros((k, 6, 6)), torch.zeros((k, 6)),
         torch.zeros((k,), dtype=torch.int32))
  state_ = torch.zeros((2,), dtype=torch.int32)
  flag = torch.zeros((), dtype=torch.bool)
  before = (pose_h_b.accumulate.launches, pose_h_b.step.launches)
  intr = torch.zeros((4,))
  for T in (kf.global_T_frame, kf.global_T_frame.to("meta")):
    with pytest.raises(ValueError, match="no pose_h_b kernel"):
      pose_h_b.accumulate(
          T, done, pba.surfels, kf.depth, kf.normals, kf.intensity, intr,
          intr, (160, 120), pba.depth_params(), True, True, out,
          torch.zeros((1, k, pose_h_b.SUMS)),
          torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="no pose_h_b kernel"):
      pose_h_b.step(T, done, out[0], out[1], state_, flag)
  assert (pose_h_b.accumulate.launches, pose_h_b.step.launches) == before


@pytest.mark.parametrize("use_depth,use_desc", [
    (True, False), (False, True), (True, True)],
    ids=["depth", "descriptors", "both"])
def test_geometry_accumulators_and_update_match_jax(state, use_depth,
                                                    use_desc):
  jba, pba = state
  n = pba.surfels.capacity
  jacc = jgeometry_opt._zero_accum(n)
  pacc = geometry_opt._zero_accum(n, "cpu")
  for k in range(3):
    jacc = jgeometry_opt.accumulate_one_keyframe(
        jacc, jba.surfels, jba.kf.depth[k], jba.kf.normals[k],
        jba.kf.intensity[k], jba.kf.global_T_frame[k], jnp.asarray(True),
        *_jax_args(jba), use_depth, use_desc)
    pacc = geometry_opt.accumulate_one_keyframe(
        pacc, pba.surfels, pba.kf.depth[k], pba.kf.normals[k],
        pba.kf.intensity[k], pba.kf.global_T_frame[k], True,
        *_port_args(pba), use_depth, use_desc)
  valid = pba.surfels.valid.numpy()
  for name in pacc._fields:
    j = np.asarray(getattr(jacc, name))[valid]
    p = getattr(pacc, name).numpy()[valid]
    np.testing.assert_allclose(p, j, rtol=0,
                               atol=1e-5 * max(np.abs(j).max(), 1e-30),
                               err_msg=name)
  assert np.abs(np.asarray(jacc.h00)[valid]).max() > 0

  if not use_depth:
    return  # a singular system in this fixture, see the module docstring
  # The same accumulators into both updates, so that only the solve and the
  # update are compared.
  near = _near(pba)
  assert near.sum() > 1000
  jnew = jgeometry_opt.solve_and_update(jba.surfels, jacc)
  pnew = geometry_opt.solve_and_update(
      pba.surfels, geometry_opt.GeometryAccum(
          *(torch.from_numpy(np.array(x)) for x in jacc)))
  np.testing.assert_allclose(pnew.pos.numpy()[near],
                             np.asarray(jnew.pos)[near], rtol=0, atol=1e-6)
  np.testing.assert_allclose(pnew.desc.numpy()[near],
                             np.asarray(jnew.desc)[near], rtol=0, atol=1e-3)
  moved = np.abs(pnew.pos.numpy() - pba.surfels.pos.numpy())[valid].max()
  assert moved > 1e-5  # the step did something
  assert pnew.valid is pba.surfels.valid  # untouched fields are shared


def test_optimize_geometry_iteration_matches_jax(state):
  """The keyframe loop against the reference's scan over the whole stack:
  slot 2 made inactive and slot 3 empty contribute nothing to either."""
  jba, pba = state
  act = np.array([2, 1, 0, 0], np.int32)
  jkf = jba.kf._replace(activation=jnp.asarray(act))
  pkf = pba.kf._replace(activation=torch.from_numpy(act))
  jnew = jax.jit(lambda s, kf: jgeometry_opt.optimize_geometry_iteration(
      s, kf, *_jax_args(jba)))(jba.surfels, jkf)
  pnew = geometry_opt.optimize_geometry_iteration(pba.surfels, pkf,
                                                  *_port_args(pba))
  near = _near(pba)
  np.testing.assert_allclose(pnew.pos.numpy()[near],
                             np.asarray(jnew.pos)[near], rtol=0, atol=1e-6)
  np.testing.assert_allclose(pnew.desc.numpy()[near],
                             np.asarray(jnew.desc)[near], rtol=0, atol=1e-3)
  assert np.abs(pnew.pos.numpy() - pba.surfels.pos.numpy())[near].max() > 1e-5
  with_slots = geometry_opt.optimize_geometry_iteration(
      pba.surfels, pkf, *_port_args(pba), slots=[0, 1])
  np.testing.assert_array_equal(with_slots.pos.numpy(), pnew.pos.numpy())


# --- Analytic Jacobians against torch.autograd ---


@pytest.fixture
def random_surfels():
  rng = np.random.default_rng(0)
  n = 64
  pos = np.stack([rng.uniform(-0.8, 0.8, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(1.5, 3.0, n)], axis=-1).astype(np.float32)
  nrm = rng.normal(size=(n, 3)).astype(np.float32)
  nrm[:, 2] = -np.abs(nrm[:, 2]) - 0.5
  nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
  T = se3.exp(torch.tensor([0.01, -0.02, 0.03, 0.004, 0.005, -0.006]))
  return (synthetic.default_test_camera(160, 120), torch.from_numpy(pos),
          torch.from_numpy(nrm), T, rng)


def _jacobian(fn, n_in):
  return torch.autograd.functional.jacobian(fn, torch.zeros(n_in))


def _exp_at_zero(eps):
  """I + hat(eps): the SE(3) exponential to first order, which has the
  exponential's derivative at eps = 0 (``se3.exp`` selects its small-angle
  series with ``torch.where``, whose unused branch is 0/0 at eps = 0 and
  would turn the gradient into NaN)."""
  return torch.eye(4) + torch.cat(
      [torch.cat([se3.hat_so3(eps[3:6]), eps[0:3, None]], dim=1),
       torch.zeros(1, 4)], dim=0)


def test_depth_residual_pose_jacobian_matches_autograd(random_surfels):
  """d r / d eps of r(T * exp(eps)) at eps = 0."""
  cam, pos, nrm, T_gf, rng = random_surfels
  n = pos.shape[0]
  inv_stddev = torch.from_numpy(rng.uniform(50, 200, n).astype(np.float32))
  unproj = pos + torch.from_numpy(rng.normal(0, 0.005, (n, 3))
                                  .astype(np.float32))

  def residuals(eps):
    fTg = torch.linalg.inv(T_gf @ _exp_at_zero(eps))
    return cost.raw_depth_residual(
        unproj, se3.transform_points(fTg, pos), se3.rotate(fTg, nrm),
        inv_stddev)

  fTg = se3.inverse(T_gf)
  analytic = cost.depth_residual_pose_jacobian(
      unproj, se3.rotate(fTg, nrm), inv_stddev)
  np.testing.assert_allclose(_jacobian(residuals, 6).numpy(),
                             analytic.numpy(), atol=2e-3, rtol=2e-3)


def test_projected_position_pose_jacobian_matches_autograd(random_surfels):
  """The descriptor residual's chain rule through the projection, on an
  "intensity" that is linear in the pixel position."""
  cam, pos, nrm, T_gf, rng = random_surfels
  n = pos.shape[0]
  gx = torch.from_numpy(rng.normal(size=n).astype(np.float32))
  gy = torch.from_numpy(rng.normal(size=n).astype(np.float32))

  def residuals(eps):
    fTg = torch.linalg.inv(T_gf @ _exp_at_zero(eps))
    pxy = cam.project_corner(se3.transform_points(fTg, pos))
    return gx * pxy[..., 0] + gy * pxy[..., 1]

  local = se3.transform_points(se3.inverse(T_gf), pos)
  analytic = cost.projected_position_pose_jacobian(gx * cam.fx, gy * cam.fy,
                                                   local)
  np.testing.assert_allclose(_jacobian(residuals, 6).numpy(),
                             analytic.numpy(), atol=2e-3, rtol=2e-3)


def test_geometry_offset_jacobians_match_autograd(random_surfels):
  """d r / d (position offset along the normal): -inv_stddev for the depth
  residual, and the projected-position chain for the descriptor residual
  (the jp terms of accumulate_one_keyframe)."""
  cam, pos, nrm, T_gf, rng = random_surfels
  n = pos.shape[0]
  inv_stddev = torch.from_numpy(rng.uniform(50, 200, n).astype(np.float32))
  unproj = pos + torch.from_numpy(rng.normal(0, 0.005, (n, 3))
                                  .astype(np.float32))
  gx = torch.from_numpy(rng.normal(size=n).astype(np.float32))
  gy = torch.from_numpy(rng.normal(size=n).astype(np.float32))
  fTg = se3.inverse(T_gf)
  rn = se3.rotate(fTg, nrm)

  def depth_residuals(t):
    return cost.raw_depth_residual(
        unproj, se3.transform_points(fTg, pos + t[:, None] * nrm), rn,
        inv_stddev)

  # The surfel moves against the offset: pos - x * normal.
  def descriptor_residuals(t):
    pxy = cam.project_corner(
        se3.transform_points(fTg, pos + t[:, None] * nrm))
    return gx * pxy[..., 0] + gy * pxy[..., 1]

  auto = torch.diagonal(_jacobian(depth_residuals, n))
  np.testing.assert_allclose(auto.numpy(), -inv_stddev.numpy(), atol=1e-2,
                             rtol=1e-3)
  ls = se3.transform_points(fTg, pos)
  term1 = -cam.fx * (rn[..., 0] * ls[..., 2] - rn[..., 2] * ls[..., 0])
  term2 = -cam.fy * (rn[..., 1] * ls[..., 2] - rn[..., 2] * ls[..., 1])
  jp = -(gx * term1 + gy * term2) / (ls[..., 2] * ls[..., 2])
  auto = torch.diagonal(_jacobian(descriptor_residuals, n))
  np.testing.assert_allclose(auto.numpy(), jp.numpy(), atol=2e-3, rtol=2e-3)


# ---- The pose_h_b kernels on the card (no JAX there) ----

NEEDS_CUDA = "needs CUDA: the pose_h_b kernels run on the card only"
_CARD_STATES = {}


def _card_state(kind):
  """A map built by the port's DirectBA on the card: 6 keyframes of the
  multi-view plane world at 320x240 (textured, sparsification 4), every
  keyframe's surfels, the keyframe poses perturbed by a seeded 2 mm /
  1 mrad. Slot 6 is optimized but holds no image, so no surfel associates
  with it; slot 7 is not optimized. Every 7th live surfel slot is made
  invalid and, with every slot past the watermark, carries NaN and inf.
  "random" adds seeded noise to the surfels' positions, normals, radii
  and descriptors. Returns (poses, optimize mask, surfels, DirectBA)."""
  if kind in _CARD_STATES:
    return _CARD_STATES[kind]
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.slam.direct_ba import DirectBA
  cam = synthetic.default_test_camera(320, 240)
  config = BadSlamConfig(
      sparse_surfel_cell_size=4,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1, initial_keyframe_capacity=8, max_depth=20.0)
  ba = DirectBA(config, cam, cam, device="cuda")
  for i, (keyframe, T) in enumerate(synthetic.multi_view_plane_keyframes(
      cam, n_kf=6, n_planes=8, textured=True)):
    ba.add_keyframe(*keyframe, T, i)
  for i in range(6):
    ba.create_surfels_for_keyframe(i, filter_new_surfels=True)
  rng = np.random.default_rng(11 if kind == "random" else 5)
  s = ba.surfels
  n, count = s.capacity, int(s.count)
  assert ba.keyframe_count == 6 and count > 2000
  dev = s.pos.device
  T = ba.kf.global_T_frame.clone()
  for k in range(1, 6):
    noise = np.concatenate([rng.uniform(-2e-3, 2e-3, 3),
                            rng.uniform(-1e-3, 1e-3, 3)]).astype(np.float32)
    T[k] = T[k] @ se3.exp(torch.from_numpy(noise).to(dev))
  T[6] = T[0]
  pos, normal, desc, radius_sq = s.pos, s.normal, s.desc, s.radius_sq
  if kind == "random":
    def noise(shape, scale):
      return torch.from_numpy(
          rng.normal(0, scale, shape).astype(np.float32)).to(dev)
    pos = pos + noise((n, 3), 5e-4)
    normal = normal + noise((n, 3), 0.05)
    normal = normal / normal.norm(dim=-1, keepdim=True)
    desc = desc + noise((n, 2), 2.0)
    radius_sq = radius_sq * torch.from_numpy(
        rng.uniform(0.5, 1.5, n).astype(np.float32)).to(dev)
  slot = torch.arange(n, device=dev)
  bad = (slot % 7 == 0) | (slot >= count)
  nan, inf = float("nan"), float("inf")
  s = s._replace(
      pos=torch.where(bad[:, None], nan, pos),
      normal=torch.where(bad[:, None], inf, normal),
      desc=torch.where(bad[:, None], nan, desc),
      radius_sq=torch.where(bad, inf, radius_sq),
      valid=s.valid & ~bad)
  optimize = torch.tensor([True] * 7 + [False], device=dev)
  _CARD_STATES[kind] = (T, optimize, s, ba)
  return _CARD_STATES[kind]


def _card_args(ba):
  return (ba.depth_camera(), ba.color_camera(), ba.depth_params())


def _launch_accumulate(ba, T, done, s, use_depth, use_desc, out):
  depth_cam, color_cam, dp = _card_args(ba)
  kf, dev = ba.kf, T.device
  partials = torch.empty((pose_h_b.blocks(s.capacity, dev), T.shape[0],
                          pose_h_b.SUMS), device=dev)
  ticket = torch.zeros((), dtype=torch.int32, device=dev)
  pose_h_b.accumulate(
      T, done, s, kf.depth, kf.normals, kf.intensity,
      pose_opt._intrinsics(depth_cam, dev),
      pose_opt._intrinsics(color_cam, dev),
      (color_cam.width, color_cam.height), dp, use_depth, use_desc, out,
      partials, ticket)
  torch.cuda.synchronize()
  assert int(ticket) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("use_depth,use_desc", [
    (True, False), (False, True), (True, True)],
    ids=["depth", "descriptors", "both"])
@pytest.mark.parametrize("kind", ["random", "session"])
def test_cuda_lane_h_b_matches_accumulate_pose_h_b(kind, use_depth,
                                                   use_desc):
  """The accumulate kernel against ``accumulate_pose_h_b`` per lane on the
  card. One launch over every lane: residual counts equal; the lane with
  no image all zeros; the lane that is not optimized not written. Then one
  launch per lane over the surfels off their tap cells' edges
  (``pose_h_b.off_tap_cell_edges``): H and b within 5e-5 of the magnitude
  of their summands (``pose_h_b.h_b_scales``). Measured on an H100 up to 1.1e-5 against
  the float64 sum of the plain version's summands, where the plain version
  comes within 7e-7: a residual cancels inside itself (n . (u - p) of two
  nearly equal points, the difference of two intensity samples), so an
  ulp of its factors, which the kernel and the plain version's reductions
  round in their own order, is large beside the summand."""
  if not torch.cuda.is_available():
    pytest.skip(NEEDS_CUDA)
  T, optimize, s, ba = _card_state(kind)
  kf = ba.kf
  k = T.shape[0]
  dev = T.device
  args = _card_args(ba)

  def outputs():
    out = (torch.full((k, 6, 6), 7.0, device=dev),
           torch.full((k, 6), 7.0, device=dev),
           torch.full((k,), 7, dtype=torch.int32, device=dev))
    out[0][:7], out[1][:7], out[2][:7] = 0.0, 0.0, 0
    return out

  out = outputs()
  before = pose_h_b.accumulate.launches
  _launch_accumulate(ba, T, ~optimize, s, use_depth, use_desc, out)
  assert pose_h_b.accumulate.launches == before + 1
  H, b, n_all = (x.cpu() for x in out)
  assert not H[6].any() and not b[6].any() and int(n_all[6]) == 0
  assert (H[7] == 7.0).all() and (b[7] == 7.0).all() and int(n_all[7]) == 7
  for lane in range(6):
    _, _, _, want_n = pose_opt.accumulate_pose_h_b(
        T[lane], s, kf.depth[lane], kf.normals[lane], kf.intensity[lane],
        *args, use_depth, use_desc, compute_cost=True)
    assert int(n_all[lane]) == int(want_n) > 500, lane

    off = pose_h_b.off_tap_cell_edges(
        T[lane], s, kf.depth[lane], kf.normals[lane], *args)
    s_off = s._replace(valid=s.valid & off)
    out = outputs()
    done = torch.ones((k,), dtype=torch.bool, device=dev)
    done[lane] = False
    _launch_accumulate(ba, T, done, s_off, use_depth, use_desc, out)
    wH, wb, _, wn = pose_opt.accumulate_pose_h_b(
        T[lane], s_off, kf.depth[lane], kf.normals[lane],
        kf.intensity[lane], *args, use_depth, use_desc, compute_cost=True)
    H, b, n = (x[lane].cpu() for x in out)
    scale_H, scale_b = pose_h_b.h_b_scales(
        T[lane], s_off, kf.depth[lane], kf.normals[lane],
        kf.intensity[lane], *args, use_depth, use_desc)
    err_H = float(((H - wH.cpu()).abs() / scale_H).max())
    err_b = float(((b - wb.cpu()).abs() / scale_b).max())
    print(f"{kind} lane {lane}: {int(wn)} of {int(want_n)} residuals off "
          f"the edges, H {err_H:.3g}, b {err_b:.3g} of the summands' "
          f"magnitude")
    assert int(n) == int(wn) > 200
    assert err_H <= 5e-5 and err_b <= 5e-5, lane


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "session"])
def test_cuda_shared_loop_matches_per_keyframe_loop(kind):
  """``estimate_frame_poses_batched`` on the card (the shared loop, two
  launches a step) against the plain per-keyframe loop on the card: poses
  within 1e-5, ``moved`` equal; the lane with no associations converges at
  its first step unmoved; the counters and launch counts add up."""
  if not torch.cuda.is_available():
    pytest.skip(NEEDS_CUDA)
  T, optimize, s, ba = _card_state(kind)
  kf = ba.kf
  args = _card_args(ba)
  launches = (pose_h_b.accumulate.launches, pose_h_b.step.launches)
  with Timing.isolated() as stats:
    got, moved = pose_opt.estimate_frame_poses_batched(
        T, optimize, s, kf.depth, kf.normals, kf.intensity, *args)
  steps = stats["BA pose GN steps"].samples
  lane_steps = stats["BA pose lane steps"].samples
  assert len(steps) == 1 and 2 <= steps[0] <= 30
  assert steps[0] < lane_steps[0] <= 7 * steps[0]
  assert (pose_h_b.accumulate.launches - launches[0]
          == pose_h_b.step.launches - launches[1] == steps[0])
  want = T.clone()
  for lane in range(7):
    want[lane], _ = pose_opt.estimate_frame_pose(
        T[lane], s, kf.depth[lane], kf.normals[lane], kf.intensity[lane],
        *args)
  want_moved = optimize & ~pose_opt.is_scale1_converged(
      se3.log(se3.inverse(T) @ want))
  err = float((got - want).abs().max())
  print(f"{kind}: poses {err:.3g} apart; {steps[0]} steps, "
        f"{lane_steps[0]} lane steps; moved {moved.tolist()}")
  assert err <= 1e-5
  assert torch.equal(moved, want_moved)
  assert torch.equal(got[6], T[6]) and torch.equal(got[7], T[7])
  assert moved[1:6].all() and not moved[6]


@pytest.mark.cuda
def test_cuda_launchers_check_their_tensors():
  """On the card a launcher raises on a dtype or shape it does not take,
  and launches nothing."""
  if not torch.cuda.is_available():
    pytest.skip(NEEDS_CUDA)
  k = 4
  f = dict(device="cuda")
  T = torch.eye(4, **f).repeat(k, 1, 1)
  done = torch.zeros((k,), dtype=torch.bool, **f)
  H, b = torch.zeros((k, 6, 6), **f), torch.zeros((k, 6), **f)
  state = torch.zeros((2,), dtype=torch.int32, **f)
  flag = torch.zeros((), dtype=torch.bool, **f)
  before = pose_h_b.step.launches
  with pytest.raises(TypeError):
    pose_h_b.step(T.double(), done, H, b, state, flag)
  with pytest.raises(ValueError):
    pose_h_b.step(T, done[:3], H, b, state, flag)
  assert pose_h_b.step.launches == before
  pose_h_b.step(T, done, H, b, state, flag)
  torch.cuda.synchronize()
  assert pose_h_b.step.launches == before + 1
  # Every lane's H is zero: the finite guard zeroes the step, every lane
  # converges unmoved.
  assert torch.equal(T, torch.eye(4, **f).repeat(k, 1, 1))
  assert done.all() and bool(flag) and state.tolist() == [0, k]
