"""The port's joint solver (badslam_tpu_torch.models.pcg) against the JAX
package's, on the two-keyframe plane fixture of ``tests/test_pcg.py`` (cell
2, 160x120; one image at two poses, the second perturbed), carried into the
port with ``from_numpy``; then the gates of ``tests/test_pcg.py`` met by the
port alone.

Tolerances: every block of pcg_init's r and M and of one Hessian-vector
product on a seeded random vector within 1e-5 of the block's largest entry,
with and without the intrinsics blocks, except r's per-surfel and per-cell
blocks at 3e-4 and its depth-intrinsics rows at 3e-5; the port's product
symmetric to 1e-3; the solved delta
within 2e-3 of its largest entry per block on the geometric-only fixture,
where CG ends before its 30th iteration, and within 1e-5 of the exact step.

Two limits were to be tighter. r.spos is, lane by lane, w J r with r the
difference of two nearly equal depths times up to 1e3 (the inverse depth
stddev), so float32 leaves each package about 2e-3 of absolute rounding
there, 3.3e-5 of the block's largest entry (147 of 1,662 lanes are past
1e-5); r.sdesc is w r with r = 180 (I(t) - I(c)) - d, a difference of
numbers near 100 sampled at coordinates that carry 1e-5 px of rounding,
which leaves 1.8e-6 of 8.3e-3 (2.2e-4); a cell of r.cfac sums one or two
such lanes (4.3e-5). The blocks that sum over all surfels (poses,
intrinsics) average that out and hold 1e-5, but for
r's depth-intrinsics rows, whose Jacobians (pixel coordinate x depth x
inverse stddev) weigh the noisiest lanes most: 1.6e-5, held to 3e-5. The
solve carries that rounding of r into the step: both packages
converge in 17 iterations and end 2e-6 to 5e-6 from the exact pose step of
3e-3 on different sides, 5.2e-6 (1.7e-3) from each other, so 1e-3 is past
what float32 holds there. The same step's position offsets are themselves
rounding (at most 7e-6 m: the map already fits keyframe 0), so they are held
to 1e-5 m, the limit on positions after a BA, not to a share of their size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.models import pcg as jpcg
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import pcg
from badslam_tpu_torch.utils.timing import Timing
from tests import test_pcg as jax_pcg_tests
from tests.test_torch_ba_fixtures import (jax_cameras_and_params,
                                          port_from_jax)

BLOCKS = pcg.PCGVector._fields
FLAGS = {
    "plain": dict(use_depth=True, use_desc=True),
    "intrinsics": dict(use_depth=True, use_desc=True, opt_dintr=True,
                       opt_cintr=True),
}


# The fixture's surfels come from the pixel centers of keyframe 0, whose
# pose is the identity: every one of its descriptor samples then sits on a
# texel boundary, where the bilinear gradient jumps and the last bit of the
# projection decides the side (the reference itself gives other values there
# run eagerly than compiled). Moving keyframe 0 by 1 mm and 0.4 mrad takes
# the samples ~0.03 px off the boundaries.
OFF_THE_TEXEL_BOUNDARY = [0.001, -0.0015, 0.0005, 0.0004, -0.0003, 0.0002]


def _move_first_keyframe(jba):
  T = jba.kf.global_T_frame
  jba.kf = jba.kf._replace(global_T_frame=T.at[0].set(
      T[0] @ jse3.exp(jnp.asarray(OFF_THE_TEXEL_BOUNDARY, jnp.float32))))


@pytest.fixture(scope="module")
def pair():
  """Textured, second keyframe off by 2 mm and 0.5 mrad, a non-zero a and
  cfactor; both keyframes and every surfel active."""
  jba, _, _ = jax_pcg_tests.build([0.002, 0, 0, 0.0005, 0, 0], use_desc=True)
  _move_first_keyframe(jba)
  rng = np.random.default_rng(3)
  jba.a = jnp.asarray(0.002, jnp.float32)
  jba.cfactor = jnp.asarray(
      rng.uniform(-1e-3, 1e-3, jba.cfactor.shape), jnp.float32)
  return jba, port_from_jax(jba)


@pytest.fixture(scope="module")
def geometric_pair():
  """tests/test_pcg.py::test_pcg_debug_verify_result's state: untextured,
  second keyframe off by up to 3 mm and 0.5 mrad."""
  jba, _, _ = jax_pcg_tests.build([0.003, -0.002, 0.001, 0.0005, 0, -0.0004],
                                  use_desc=False)
  return jba, port_from_jax(jba)


def _port_args(pba):
  return (pba.surfels, pba.kf, pba.depth_camera(), pba.color_camera(),
          pba.calibration)


def _random_vectors(jba, seed):
  rng = np.random.default_rng(seed)
  k, n = jba.kf.capacity, jba.surfels.capacity
  shapes = ((k, 6), (n,), (n, 2), (pcg.N_DINTR,), (jba.cfactor.size,),
            (pcg.N_CINTR,))
  arrays = [rng.normal(size=s).astype(np.float32) for s in shapes]
  return (jpcg.PCGVector(*(jnp.asarray(a) for a in arrays)),
          pcg.PCGVector(*(torch.from_numpy(a) for a in arrays)))


def _assert_blocks(got, want, rel, what):
  for name, g, w in zip(BLOCKS, got, want):
    g, w = g.numpy(), np.asarray(w)
    assert g.shape == w.shape, (what, name)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * np.abs(w).max(),
                               err_msg=f"{what}.{name}")


@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS)
def test_pcg_init_matches_jax(pair, flags):
  jba, pba = pair
  depth_cam, color_cam, dp = jax_cameras_and_params(jba)
  r_j, M_j = jax.jit(functools.partial(jpcg.pcg_init, **flags))(
      jba.surfels, jba.kf, depth_cam, color_cam, dp, jnp.asarray(0))
  r_p, M_p = pcg.pcg_init(*_port_args(pba), 0, **flags)
  assert float(np.abs(np.asarray(r_j.poses)).max()) > 1.0
  for name, rel in (("poses", 1e-5), ("spos", 3e-4), ("sdesc", 3e-4),
                    ("dintr", 3e-5), ("cfac", 3e-4), ("cintr", 1e-5)):
    _assert_blocks((getattr(r_p, name),), (getattr(r_j, name),), rel,
                   f"r.{name}: ")
  _assert_blocks(M_p, M_j, 1e-5, "M")
  # The gauge row: zero residual, unit preconditioner.
  assert float(r_p.poses[0].abs().max()) == 0.0
  assert torch.equal(M_p.poses[0], torch.ones(6))
  if "opt_dintr" in flags:
    assert float(r_p.cfac.abs().max()) > 0 and float(r_p.cintr.abs().max()) > 0
  else:
    assert float(r_p.cfac.abs().max()) == 0
    assert torch.equal(M_p.cintr, torch.ones(4))


@pytest.mark.parametrize("flags", FLAGS.values(), ids=FLAGS)
def test_apply_hessian_matches_jax_and_is_symmetric(pair, flags):
  jba, pba = pair
  depth_cam, color_cam, dp = jax_cameras_and_params(jba)
  hvp_j = jax.jit(functools.partial(jpcg.apply_hessian, **flags))
  terms = pcg.KeyframeTerms(*_port_args(pba), **flags)
  products = []
  for seed in (0, 1):
    p_j, p_p = _random_vectors(jba, seed)
    h_j = hvp_j(p_j, jba.surfels, jba.kf, depth_cam, color_cam, dp,
                jnp.asarray(1))
    h_p = pcg.apply_hessian(p_p, *_port_args(pba), 1, **flags, terms=terms)
    _assert_blocks(h_p, h_j, 1e-5, f"H p{seed}")
    products.append((p_p, h_p))
  # One set of terms served both products, and without it they are the same.
  assert (terms.passes, terms.computed) == (2, 2)
  again = pcg.apply_hessian(products[1][0], *_port_args(pba), 1, **flags)
  for a, b in zip(again, products[1][1]):
    assert torch.equal(a, b)
  # p2 . H p1 == p1 . H p2
  (p1, h1), (p2, h2) = products
  assert float(p2.dot(h1)) == pytest.approx(float(p1.dot(h2)), rel=1e-3)
  # alpha_d > 0 on the preconditioned initial direction.
  r0, M = pcg.pcg_init(*_port_args(pba), 1, **flags, terms=terms)
  g0 = pcg.PCGVector(*(r / m for r, m in zip(r0, M)))
  assert float(g0.dot(pcg.apply_hessian(g0, *_port_args(pba), 1, **flags,
                                        terms=terms))) > 0


def test_gauge_keyframe_outside_the_pass_keeps_its_rows(pair):
  """The gauge slot is drawn from the valid keyframes, the pass visits the
  ones that take part: a gauge keyframe that the pass leaves out still has
  a zero residual row and a unit preconditioner row."""
  _, pba = pair
  r, M = pcg.pcg_init(*_port_args(pba), 0, slots=[1])
  assert float(r.poses[0].abs().max()) == 0.0
  assert torch.equal(M.poses[0], torch.ones(6))
  assert float(r.poses[1].abs().max()) > 0.0
  p = pcg.PCGVector(*(torch.ones_like(b) for b in r))
  h = pcg.apply_hessian(p, *_port_args(pba), 0, slots=[1])
  assert float(h.poses[0].abs().max()) == 0.0


def _solve_counted(monkeypatch, pba, flags, transfer_free):
  """pcg_solve's delta, its ``Timing`` counters (one sample each) and the
  keyframe terms it computed (read from the ``KeyframeTerms`` it made)."""
  made = []
  real = pcg.KeyframeTerms

  def making(*args, **kwargs):
    made.append(real(*args, **kwargs))
    return made[-1]

  monkeypatch.setattr(pcg, "KeyframeTerms", making)
  with Timing.isolated() as stats:
    delta = pcg.pcg_solve(*_port_args(pba), 0, **flags,
                          transfer_free=transfer_free)
  monkeypatch.setattr(pcg, "KeyframeTerms", real)
  counts = {tag: s.samples for tag, s in stats.items() if s.counter}
  (terms,) = made
  return delta, {tag: n for tag, (n,) in counts.items()}, terms.computed


@pytest.mark.parametrize("transfer_free", [False, True],
                         ids=["host_read", "transfer_free"])
def test_pcg_solve_matches_jax(geometric_pair, monkeypatch, transfer_free):
  """The solve against JAX's, under either ending of its loop; the poll
  ending gives the host ending's delta bit for bit."""
  jba, pba = geometric_pair
  depth_cam, color_cam, dp = jax_cameras_and_params(jba)
  flags = dict(max_inner_iterations=30, use_depth=True, use_desc=False)
  want = jax.jit(functools.partial(jpcg.pcg_solve, **flags))(
      jba.surfels, jba.kf, depth_cam, color_cam, dp, jnp.asarray(0))
  got, counts, computed = _solve_counted(monkeypatch, pba, flags,
                                         transfer_free)
  iterations = counts["BA PCG inner iterations"]
  assert 1 < iterations < 30   # CG converged, the cap did not end it
  assert counts["BA PCG terms recomputed"] == 0 and computed == 2
  assert counts["BA PCG keyframe passes"] == iterations + 1
  assert float(np.abs(np.asarray(want.poses)).max()) > 1e-3
  _assert_blocks(got._replace(spos=got.spos * 0), want._replace(
      spos=want.spos * 0), 2e-3, "delta")
  np.testing.assert_allclose(got.spos.numpy(), np.asarray(want.spos), rtol=0,
                             atol=1e-5)
  # The exact step takes the second keyframe back onto the first.
  np.testing.assert_allclose(
      got.poses[1].numpy(), [-0.003, 0.002, -0.001, -0.0005, 0, 0.0004],
      rtol=0, atol=1e-5)
  err, scale = pcg.debug_verify_result(got, *_port_args(pba), 0,
                                       use_depth=True, use_desc=False)
  assert float(err) < 1e-2 * float(scale), (float(err), float(scale))
  if transfer_free:
    host = pcg.pcg_solve(*_port_args(pba), 0, **flags)
    for block in BLOCKS:
      assert torch.equal(getattr(got, block), getattr(host, block)), block

  # Where the terms do not fit they are computed again in every pass: the
  # same bits.
  monkeypatch.setattr(pcg, "CPU_TERM_BUDGET_BYTES", 0)
  again, counts, computed = _solve_counted(monkeypatch, pba, flags,
                                           transfer_free)
  passes = counts["BA PCG keyframe passes"]
  assert counts["BA PCG terms recomputed"] == passes
  assert computed == 2 * passes
  for a, b in zip(again, got):
    assert torch.equal(a, b)


# --- the gates of tests/test_pcg.py, in the port alone ---


@pytest.mark.parametrize("use_desc", [False, True],
                         ids=["geometric", "with_photometric"])
def test_port_pcg_recovers_perturbed_pose(use_desc):
  perturb = [0.004, -0.003, 0.002, 0.0008, -0.0005, 0.0008]
  jba, _, _ = jax_pcg_tests.build(perturb, use_desc)
  pba = port_from_jax(jba)
  errs = []
  for _ in range(8):
    delta = pcg.pcg_solve(*_port_args(pba), 0, 30, True, use_desc)
    pba.surfels, pba.kf = pcg.apply_pcg_delta(pba.surfels, pba.kf, delta)
    errs.append(float(se3.log(
        se3.inverse(pba.kf.global_T_frame[1])).abs().max()))
  assert float(se3.log(se3.inverse(pba.kf.global_T_frame[0])).abs().max()) \
      < 1e-6
  if not use_desc:
    assert errs[-1] < 2e-4, errs
  else:
    assert min(errs) < 5e-4 and errs[-1] < 3e-3, errs
  assert bool(torch.isfinite(pba.surfels.pos[pba.surfels.valid]).all())


def test_port_pcg_joint_intrinsics_recovery():
  jba, _, _ = jax_pcg_tests.build([0.0] * 6, use_desc=True)
  pba = port_from_jax(jba)
  calib = pba.calibration
  calib.a.fill_(0.02)
  delta = pcg.pcg_solve(*_port_args(pba), 0, 40, True, True, True, True)
  d_intr, c_intr, a, cfactor = pcg.apply_pcg_delta_intrinsics(
      calib.depth_intr, pba.color_intr, calib.a, calib.cfactor, delta,
      True, True)
  assert abs(float(a)) < 0.02   # toward the truth (0), not away
  for t in (d_intr, c_intr, cfactor):
    assert bool(torch.isfinite(t).all())
  assert float(calib.a) == pytest.approx(0.02)  # the inputs are left alone
