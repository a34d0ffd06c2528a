"""The port's geometry, ops and GN helpers against the JAX package, on the
same numpy inputs (badslam_tpu_torch.geometry / ops / models.pose_opt /
models.cost vs their badslam_tpu counterparts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.geometry.camera import PinholeCamera as JaxCamera
from badslam_tpu.models import cost as jcost
from badslam_tpu.models import pose_opt as jpose_opt
from badslam_tpu.ops import depth_model as jdepth_model
from badslam_tpu.ops import interp as jinterp
from badslam_tpu.ops import pyramid as jpyramid
from badslam_tpu.ops import robust as jrobust
from badslam_tpu_torch.geometry import se3, se3_np
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models import cost, pose_opt
from badslam_tpu_torch.ops import depth_model, interp, pyramid, robust

torch.set_num_threads(2)


def _t(a):
  return torch.from_numpy(np.array(a))


def _tangents(seed, n=64):
  """Random tangents with rotation angles from ~0 through the series
  switch (0.1) to 2.8 rad (below pi, where log wraps)."""
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(n, 6)).astype(np.float32)
  scales = np.logspace(-7, 0.45, n).astype(np.float32)
  x[:, 3:] *= scales[:, None] / np.linalg.norm(x[:, 3:], axis=1,
                                               keepdims=True)
  return x


def test_se3_exp_log_inverse_match_jax():
  x = _tangents(0)
  T_j = np.asarray(jse3.exp(jnp.asarray(x)))
  T_t = se3.exp(_t(x))
  np.testing.assert_allclose(T_t.numpy(), T_j, atol=2e-6, rtol=0)
  np.testing.assert_allclose(se3.log(T_t).numpy(),
                             np.asarray(jse3.log(jnp.asarray(T_j))),
                             atol=2e-5, rtol=0)
  np.testing.assert_allclose(se3.log(T_t).numpy(), x, atol=3e-5, rtol=0)
  np.testing.assert_allclose(se3.inverse(T_t).numpy(),
                             np.asarray(jse3.inverse(jnp.asarray(T_j))),
                             atol=1e-6, rtol=0)
  eye = (se3.inverse(T_t) @ T_t).numpy()
  np.testing.assert_allclose(eye, np.broadcast_to(np.eye(4), eye.shape),
                             atol=2e-6)


def test_quaternions_match_jax_and_host_helpers():
  T = np.asarray(jse3.exp(jnp.asarray(_tangents(1))))
  R = T[:, :3, :3]
  q_j = np.asarray(jse3.matrix_to_quaternion(jnp.asarray(R)))
  q_t = se3.matrix_to_quaternion(_t(R)).numpy()
  np.testing.assert_allclose(q_t, q_j, atol=1e-6, rtol=0)
  np.testing.assert_allclose(se3.quaternion_to_matrix(_t(q_j)).numpy(),
                             np.asarray(jse3.quaternion_to_matrix(
                                 jnp.asarray(q_j))), atol=1e-6, rtol=0)
  for Ri, qi in zip(R, q_j):
    # Same quaternion up to sign (the host helper runs in float64).
    qh = se3_np.matrix_to_quaternion(Ri)
    assert min(np.abs(qh - qi).max(), np.abs(qh + qi).max()) < 1e-6
    np.testing.assert_allclose(se3_np.quaternion_to_matrix(qh), Ri,
                               atol=1e-6)


def test_host_orthonormalize_restores_rotation():
  T = np.asarray(jse3.exp(jnp.asarray(_tangents(2)[5])))
  bad = T.copy()
  bad[:3, :3] *= 1.05
  fixed = se3_np.orthonormalize(bad)
  R = fixed[:3, :3].astype(np.float64)
  np.testing.assert_allclose(R.T @ R, np.eye(3), atol=1e-6)
  np.testing.assert_allclose(fixed[:3, :3], T[:3, :3], atol=1e-5)
  np.testing.assert_array_equal(fixed[:3, 3], T[:3, 3])


def test_camera_conventions_match_jax():
  args = dict(width=160, height=120, fx=60.0, fy=61.5, cx=80.25, cy=59.5)
  cj, ct = JaxCamera(**args), PinholeCamera(**args)
  rng = np.random.default_rng(3)
  p = np.concatenate([rng.uniform(-1, 1, (50, 2)), rng.uniform(0.5, 3, (50, 1))],
                     axis=1).astype(np.float32)
  np.testing.assert_allclose(ct.project_corner(_t(p)).numpy(),
                             np.asarray(cj.project_corner(jnp.asarray(p))),
                             atol=1e-5, rtol=0)
  px = rng.integers(0, 160, 50).astype(np.float32)
  py = rng.integers(0, 120, 50).astype(np.float32)
  d = rng.uniform(0.5, 3, 50).astype(np.float32)
  np.testing.assert_allclose(
      ct.unproject_center(_t(px), _t(py), _t(d)).numpy(),
      np.asarray(cj.unproject_center(jnp.asarray(px), jnp.asarray(py),
                                     jnp.asarray(d))), atol=1e-6, rtol=0)
  # A pixel-center point projects to the middle of its pixel (corner
  # convention) and back.
  pc = ct.unproject_center(_t(px), _t(py), _t(d))
  np.testing.assert_allclose(ct.project_corner(pc).numpy(),
                             np.stack([px + 0.5, py + 0.5], -1), atol=1e-4)
  for factor in (0.5, 0.25, 2.0):
    sj, st = cj.scaled(factor), ct.scaled(factor)
    assert (st.width, st.height) == (sj.width, sj.height)
    np.testing.assert_allclose([st.fx, st.fy, st.cx, st.cy],
                               [sj.fx, sj.fy, sj.cx, sj.cy])
  edges = np.asarray([[0.0, 0.0], [159.99, 119.99], [160.0, 5.0],
                      [-1e-4, 5.0], [5.0, 120.0], [3.5, 7.25]], np.float32)
  np.testing.assert_array_equal(ct.in_image(_t(edges)).numpy(),
                                np.asarray(cj.in_image(jnp.asarray(edges))))
  # Non-finite projections are outside the image.
  bad = _t(np.asarray([[np.inf, 1.0], [1.0, np.nan], [-np.inf, 1.0]],
                      np.float32))
  assert not ct.in_image(bad).any()


@pytest.mark.parametrize("h,w,cell", [(120, 160, 4), (37, 53, 3), (8, 8, 8)])
def test_calibrate_depth_image_matches_jax_matmul_form(h, w, cell):
  rng = np.random.default_rng(h)
  hc, wc = jdepth_model.cfactor_shape(h, w, cell)
  assert depth_model.cfactor_shape(h, w, cell) == (hc, wc)
  cfactor = rng.uniform(-0.01, 0.01, (hc, wc)).astype(np.float32)
  depth = rng.uniform(0.3, 4.0, (h, w)).astype(np.float32)
  depth[rng.random((h, w)) < 0.1] = 0.0
  a = np.float32(0.02)
  want = np.asarray(jdepth_model.calibrate_depth_image(
      jnp.asarray(a), jnp.asarray(cfactor), jnp.asarray(depth), cell))
  got = depth_model.calibrate_depth_image(_t(a), _t(cfactor), _t(depth),
                                          cell).numpy()
  np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
  assert (got[depth == 0] == 0).all()


def _u8_image(h, w, seed):
  rng = np.random.default_rng(seed)
  return rng.integers(0, 256, (h, w)).astype(np.float32) * np.float32(
      1.0 / 255.0)


def test_bilinear_value_and_gradient_match_jax_at_edges():
  img = _u8_image(12, 17, 7)
  # Interior, exact pixel centers, and coordinates past every edge.
  x = np.asarray([0.0, 0.3, 0.5, 1.7, 8.5, 16.2, 16.5, 16.9, 17.0, 25.0,
                  -3.0, 4.4], np.float32)
  y = np.asarray([0.0, 11.9, 0.5, 3.3, 6.5, 11.5, 0.2, 12.0, 5.5, -2.0,
                  30.0, 11.6], np.float32)
  vj, dxj, dyj = (np.asarray(v) for v in jinterp.sample_bilinear_with_grad(
      jnp.asarray(img), jnp.asarray(x), jnp.asarray(y)))
  vt, dxt, dyt = (v.numpy() for v in interp.sample_bilinear_with_grad(
      _t(img), _t(x), _t(y)))
  np.testing.assert_array_equal(vt, vj)
  np.testing.assert_array_equal(dxt, dxj)
  np.testing.assert_array_equal(dyt, dyj)
  np.testing.assert_array_equal(
      interp.sample_bilinear(_t(img), _t(x), _t(y)).numpy(), vj)
  gx, gy = interp.sample_bilinear_grad(_t(img), _t(x), _t(y))
  np.testing.assert_array_equal(gx.numpy(), dxj)
  np.testing.assert_array_equal(gy.numpy(), dyj)


def test_descriptor_terms_plain_taps_match_jax_packed_sampling():
  """The port samples 4 taps; the reference unpacks them from one u32.
  On u8-step intensity the two are the same numbers."""
  img = _u8_image(40, 56, 8)
  rng = np.random.default_rng(9)
  n = 500
  pxy = rng.uniform(-2, 58, (n, 2)).astype(np.float32)
  t1 = (pxy + rng.normal(size=(n, 2)) * 2).astype(np.float32)
  t2 = (pxy + rng.normal(size=(n, 2)) * 2).astype(np.float32)
  desc = rng.normal(size=(n, 2)).astype(np.float32) * 20
  want = jcost.descriptor_terms_fused(jnp.asarray(img), jnp.asarray(pxy),
                                      jnp.asarray(t1), jnp.asarray(t2),
                                      jnp.asarray(desc))
  got = cost.descriptor_terms_fused(_t(img), _t(pxy), _t(t1), _t(t2),
                                    _t(desc))
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("fn", ["tukey_residual", "tukey_weight",
                                "huber_residual", "huber_weight"])
def test_robust_losses_match_jax(fn):
  r = np.linspace(-25, 25, 101).astype(np.float32)
  np.testing.assert_allclose(getattr(robust, fn)(_t(r), 10.0).numpy(),
                             np.asarray(getattr(jrobust, fn)(jnp.asarray(r),
                                                             10.0)),
                             rtol=1e-6, atol=1e-6)


def _pyramid_inputs(h, w, seed):
  rng = np.random.default_rng(seed)
  depth = rng.uniform(0.5, 3.0, (h, w)).astype(np.float32)
  depth[rng.random((h, w)) < 0.2] = 0.0
  # Tie cases: quads whose valid samples sit symmetric around their mean,
  # all-equal quads, and all-invalid quads.
  depth[0:2, 0:2] = [[1.0, 3.0], [0.0, 0.0]]
  depth[0:2, 2:4] = [[2.0, 2.0], [2.0, 2.0]]
  depth[2:4, 0:2] = 0.0
  depth[2:4, 2:4] = [[1.0, 2.0], [3.0, 2.0]]
  normals = rng.uniform(-0.6, 0.6, (h, w, 2)).astype(np.float32)
  intensity = _u8_image(h, w, seed + 1)
  return depth, normals, intensity


def test_build_pyramid_matches_jax_including_ties():
  depth, normals, intensity = _pyramid_inputs(48, 66, 11)
  want = jpyramid.build_pyramid(jnp.asarray(depth), jnp.asarray(normals),
                                jnp.asarray(intensity), 5)
  got = pyramid.build_pyramid(_t(depth), _t(normals), _t(intensity), 5)
  assert len(got) == 5
  for level_t, level_j in zip(got, want):
    for a, b in zip(level_t, level_j):
      assert a.shape == b.shape
      np.testing.assert_array_equal(a.numpy(), np.asarray(b))
  # Ties take the first of the closest samples: the (1, 3) quad picks 1,
  # the equal quad 2, the empty quad 0.
  assert got[1].depth[0, 0] == 1.0 and got[1].depth[0, 1] == 2.0
  assert got[1].depth[1, 0] == 0.0


def test_is_scale1_converged_matches_jax():
  for x in ([1e-4, 0, 0, 0, 0, 0], [0, 0, 0, 9e-5, 0, 0],
            [0, 0, 0, 1.1e-4, 0, 0], [5e-4, 5e-4, 5e-4, 0, 0, 0]):
    x = np.asarray(x, np.float32)
    assert bool(pose_opt.is_scale1_converged(_t(x))) == bool(
        jpose_opt.is_scale1_converged(jnp.asarray(x)))


def test_solve_6x6_on_ill_conditioned_h():
  """Columns scaled like translation vs rotation at scene scale (cond(H)
  ~ 1e9): the equilibrated, refined f32 solve stays close to float64."""
  rng = np.random.default_rng(12)
  J = rng.normal(size=(400, 6))
  J[:, 3:] *= 3e-4
  H = (J.T @ J).astype(np.float32)
  b = rng.normal(size=6).astype(np.float32)
  x64 = np.linalg.solve(H.astype(np.float64), b.astype(np.float64))
  assert np.linalg.cond(H.astype(np.float64)) > 1e7
  got = pose_opt.solve_6x6(_t(H), _t(b)).numpy()
  want = np.asarray(jpose_opt.solve_6x6(jnp.asarray(H), jnp.asarray(b)))
  rel = lambda v: np.linalg.norm(v - x64) / np.linalg.norm(x64)
  assert rel(got) < 1e-2
  assert rel(got) <= 2 * rel(want) + 1e-6
  # A singular system gives a non-finite solve instead of raising.
  zero = pose_opt.solve_6x6(torch.zeros(6, 6), torch.zeros(6))
  assert zero.shape == (6,)


def test_accumulate_h_b_matches_jax_and_ignores_masked_nan():
  rng = np.random.default_rng(13)
  J = rng.normal(size=(300, 6)).astype(np.float32)
  r = rng.normal(size=300).astype(np.float32)
  w = rng.uniform(0, 1, 300).astype(np.float32)
  mask = rng.random(300) < 0.7
  J[~mask] = np.nan
  r[~mask] = np.inf
  Hj, bj = jcost.accumulate_h_b(jnp.asarray(J), jnp.asarray(r),
                                jnp.asarray(w), jnp.asarray(mask))
  Ht, bt = cost.accumulate_h_b(_t(J), _t(r), _t(w), _t(mask))
  scale = np.abs(np.asarray(Hj)).max()
  np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-5 * scale)
  np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-5 * scale)
