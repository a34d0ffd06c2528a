"""The port's side modules against the JAX package's on the CPU, the same
numpy inputs through both: the distorted camera models
(``geometry/distortion.py``), the LM optimizer, the convergence analysis,
trajectory evaluation (``eval.py``), the TUM dataset writer
(``utils/tum_synth.py``) and the synthetic generators.

Tolerances (absolute): distortion, its inverse and the projections 2e-6
(normalized coordinates below 1 and pixels below 200 in float32; the fixed
point iterations amplify rounding), the round trip 1e-5 as in
``tests/test_jacobians.py``; the pinhole fitted to a distorted camera 1e-3
px; undistortion maps 2e-4 px and the remapped image 1e-5. LM: the same
iteration count, parameters within 1e-5. Convergence samples: equal
residual counts; the first iteration's cost within a relative 5e-5 and its
squared update within 5e-4 (measured 2.3e-5 and 1.8e-4: float32 sums of
~1,700 depth residuals in another order, through an ill-conditioned 6x6
solve); the scene converges in one step in both packages, so the rest is
rounding noise; the analysis report's decisions equal. Evaluation, the
dataset writer and the generators are numpy in both packages: equal, bit
for bit or byte for byte, except the RPE from trajectory files, within
1e-8: the two packages' readers round the rotation differently (the JAX
package in float32, the port in float64, then float32).
"""

import contextlib
import io
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu import eval as jeval
from badslam_tpu.geometry import distortion as jdistortion
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.io.dataset import save_tum_trajectory
from badslam_tpu.slam.direct_ba import DirectBA as JaxDirectBA
from badslam_tpu.utils import convergence as jconvergence
from badslam_tpu.utils import lm_optimizer as jlm
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu.utils import tum_synth as jtum_synth
from badslam_tpu_torch import eval as peval
from badslam_tpu_torch.geometry import distortion
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.utils import convergence, lm_optimizer, synthetic
from badslam_tpu_torch.utils import tum_synth
from tests.test_torch_ba_fixtures import configs, port_from_jax

torch.set_num_threads(2)

# (kind, parameters after width, height, fx, fy, cx, cy)
CAMERAS = {
    "radtan8": ("RadTanCamera", (-0.2, 0.05, 1e-3, -5e-4, 0.0)),
    "radtan9": ("RadTanCamera", (-0.15, 0.03, -8e-4, 6e-4, 0.01)),
    "fisheye": ("ThinPrismFisheyeCamera",
                (0.05, -0.01, 0.002, -5e-4, 1e-3, -5e-4, 2e-3, -1e-3)),
}


def _cameras(name):
  """(JAX camera, port camera) of one model at 160x120."""
  kind, extra = CAMERAS[name]
  params = (90.0, 88.0, 80.5, 60.25) + extra
  jcam = getattr(jdistortion, kind)(160, 120,
                                    *(jnp.float32(v) for v in params))
  pcam = getattr(distortion, kind)(
      160, 120, *(torch.tensor(v, dtype=torch.float32) for v in params))
  return jcam, pcam


def _close(port, ref, atol):
  np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=0,
                             atol=atol)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_distortion_and_its_inverse_match_jax(name):
  jcam, pcam = _cameras(name)
  rng = np.random.default_rng(2)
  nxy = rng.uniform(-0.45, 0.45, (256, 2)).astype(np.float32)
  d_j = jcam.distort(jnp.asarray(nxy))
  d_p = pcam.distort(torch.from_numpy(nxy))
  _close(d_p, d_j, 2e-6)
  u_j = jcam.undistort(d_j)
  u_p = pcam.undistort(d_p)
  _close(u_p, u_j, 2e-6)
  _close(u_p, nxy, 1e-5)
  pts = np.concatenate([nxy * 2.0, np.full((256, 1), 2.0, np.float32)], -1)
  _close(pcam.project_corner(torch.from_numpy(pts)),
         jcam.project_corner(jnp.asarray(pts)), 2e-4)
  px, py = (rng.uniform(0, 160, 64).astype(np.float32),
            rng.uniform(0, 120, 64).astype(np.float32))
  depth = rng.uniform(0.5, 3.0, 64).astype(np.float32)
  _close(pcam.unproject_center(*(torch.from_numpy(v)
                                 for v in (px, py, depth))),
         jcam.unproject_center(*(jnp.asarray(v) for v in (px, py, depth))),
         2e-6 * 3.0)


@pytest.mark.parametrize("avoid_invalid", [True, False])
@pytest.mark.parametrize("name", list(CAMERAS))
def test_pinhole_from_distorted_matches_jax(name, avoid_invalid):
  jcam, pcam = _cameras(name)
  j = jdistortion.pinhole_from_distorted(jcam, avoid_invalid)
  p = distortion.pinhole_from_distorted(pcam, avoid_invalid)
  assert (p.width, p.height) == (j.width, j.height)
  np.testing.assert_allclose([p.fx, p.fy, p.cx, p.cy],
                             [float(j.fx), float(j.fy), float(j.cx),
                              float(j.cy)], rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", list(CAMERAS))
def test_undistortion_maps_and_remap_match_jax(name):
  jcam, pcam = _cameras(name)
  pin = distortion.pinhole_from_distorted(pcam)
  jpin = jdistortion.pinhole_from_distorted(jcam)
  mx_j, my_j = jdistortion.build_undistortion_maps(jcam, jpin)
  mx_p, my_p = distortion.build_undistortion_maps(pcam, pin)
  _close(mx_p, mx_j, 2e-4)
  _close(my_p, my_j, 2e-4)
  img = synthetic.intensity_function_image(synthetic.default_test_camera(
      160, 120))
  _close(distortion.undistort_image(torch.from_numpy(img), mx_p, my_p),
         jdistortion.undistort_image(jnp.asarray(img), mx_j, my_j), 1e-5)
  # The maps' definition, checked inside the port: the ray of a pinhole
  # pixel, projected through the distorted model, is the map's value.
  rng = np.random.default_rng(3)
  px = torch.from_numpy(rng.uniform(40, 120, 64).astype(np.float32))
  py = torch.from_numpy(rng.uniform(30, 90, 64).astype(np.float32))
  expected = pcam.project_corner(pin.unproject_center(px, py,
                                                      torch.ones(64)))
  from badslam_tpu_torch.ops.interp import sample_bilinear
  _close(sample_bilinear(mx_p, px + 0.5, py + 0.5), expected[:, 0], 0.1)
  _close(sample_bilinear(my_p, px + 0.5, py + 0.5), expected[:, 1], 0.1)


def test_lm_curve_fit_matches_jax():
  """tests/test_jacobians.py's fit of y = a exp(b x) to noisy samples."""
  rng = np.random.default_rng(1)
  xs = np.linspace(0, 3, 40).astype(np.float32)
  ys = (2.0 * np.exp(-0.7 * xs) + rng.normal(0, 1e-3, 40)).astype(np.float32)
  j = jlm.lm_minimize(
      lambda p: p[0] * jnp.exp(p[1] * jnp.asarray(xs)) - jnp.asarray(ys),
      jnp.asarray([1.0, 0.0]), max_iterations=100)
  xs_t, ys_t = torch.from_numpy(xs), torch.from_numpy(ys)
  p = lm_optimizer.lm_minimize(
      lambda q: q[0] * torch.exp(q[1] * xs_t) - ys_t,
      torch.tensor([1.0, 0.0]), max_iterations=100)
  assert p.iterations == int(j.iterations)
  assert p.converged == bool(j.converged)
  _close(p.params, j.params, 1e-5)
  _close(p.cost, j.cost, 1e-9)
  assert abs(float(p.params[0]) - 2.0) < 5e-3
  assert abs(float(p.params[1]) + 0.7) < 5e-3


def test_convergence_samples_and_analysis_match_jax():
  """tests/test_convergence_analysis.py's scene: one plane-scene keyframe
  and its surfels, 30 pose GN iterations from a perturbed pose, depth
  residuals only."""
  jcfg, _ = configs(initial_keyframe_capacity=2,
                    initial_surfel_capacity=1 << 13)
  cam = jsynthetic.default_test_camera(160, 120)
  jba = JaxDirectBA(jcfg, cam, cam)
  depth, _ = jsynthetic.make_plane_scene(cam, seed=3)
  kf = jsynthetic.preprocess_like_test_keyframe(depth, cam, cell=2)
  jba.add_keyframe(kf.depth, kf.normals, kf.radius_sq, kf.intensity, kf.rgb,
                   jnp.eye(4), 0)
  jba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  pba = port_from_jax(jba)

  T_init = jse3.exp(jnp.asarray([0.004, -0.002, 0.001, 0.0005, 0, 0]))
  j = jconvergence.gather_pose_samples(
      T_init, jba.surfels, kf.depth, kf.normals, kf.intensity, cam, cam,
      jba.depth_params(), num_iterations=30, use_descriptor_residuals=False)
  p = convergence.gather_pose_samples(
      torch.from_numpy(np.array(T_init)), pba.surfels, pba.kf.depth[0],
      pba.kf.normals[0], pba.kf.intensity[0], pba.depth_camera(),
      pba.color_camera(), pba.depth_params(), num_iterations=30,
      use_descriptor_residuals=False)
  assert p.cost.shape == p.update_norm_sq.shape == (30,)
  np.testing.assert_array_equal(p.residual_count, j.residual_count)
  # The exact scene converges in one step in both packages; what follows is
  # rounding noise (updates below 1e-10, costs 0).
  np.testing.assert_allclose(p.cost[0], j.cost[0], rtol=5e-5)
  np.testing.assert_array_equal(p.cost[1:], j.cost[1:])
  np.testing.assert_allclose(p.update_norm_sq[0], j.update_norm_sq[0],
                             rtol=5e-4)
  assert (p.update_norm_sq[1:] < 1e-10).all()
  assert (j.update_norm_sq[1:] < 1e-10).all()
  jr = jconvergence.analyze_samples(j)
  pr = convergence.analyze_samples(p)
  assert pr["converged_at_iteration"] == jr["converged_at_iteration"] == 1
  assert pr["iterations"] == jr["iterations"] == 30
  assert pr["final_cost"] == jr["final_cost"]
  np.testing.assert_allclose(pr["recommended_update_threshold_sq"],
                             jr["recommended_update_threshold_sq"],
                             rtol=5e-4)
  # The analysis alone, on the same samples: equal.
  assert convergence.analyze_samples(j) == jr


def _trajectory_files(tmp_path, n=20, noise=0.005, drift=0.0):
  """(estimate, ground truth) TUM files made from a seed, the estimate
  with positional noise and a per-frame drift along x, its timestamps
  jittered by under 5 ms."""
  rng = np.random.default_rng(2)
  poses = [np.asarray(jse3.exp(jnp.asarray(
      [0.1 * i, 0.01 * i, 0, 0, 0.01 * i, 0.02 * i], jnp.float32)),
      np.float64) for i in range(n)]
  ts = [i / 30.0 for i in range(n)]
  gt, est = str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")
  save_tum_trajectory(gt, ts, poses)
  noisy = []
  for i, T in enumerate(poses):
    T = T.copy()
    T[:3, 3] += rng.normal(0, noise, 3) + [drift * i, 0, 0]
    noisy.append(T)
  save_tum_trajectory(est, [t + rng.uniform(-5e-3, 5e-3) for t in ts], noisy)
  return est, gt


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_matches_jax(tmp_path, with_scale):
  rng = np.random.default_rng(1)
  gt = rng.uniform(-1, 1, (40, 3))
  T = np.asarray(jse3.exp(jnp.asarray([0.5, -0.2, 0.1, 0.3, 0.2, -0.4])),
                 np.float64)
  est = (1.3 if with_scale else 1.0) * gt @ T[:3, :3].T + T[:3, 3]
  est += rng.normal(0, 0.01, est.shape)
  rmse_p, aligned_p = peval.ate_rmse(est, gt, with_scale)
  rmse_j, aligned_j = jeval.ate_rmse(est, gt, with_scale)
  assert rmse_p == rmse_j and 0.005 < rmse_p < 0.03
  np.testing.assert_array_equal(aligned_p, aligned_j)
  est_path, gt_path = _trajectory_files(tmp_path)
  assert (peval.evaluate_ate(est_path, gt_path, with_scale=with_scale)
          == jeval.evaluate_ate(est_path, gt_path, with_scale=with_scale))


def test_ate_equals_the_closed_form_it_replaced():
  """``eval.ate_rmse`` against the plain Horn alignment that chip_smoke.py
  carried before it used ``eval``: equal within 1e-12 m on a seeded
  drifting trajectory."""
  rng = np.random.default_rng(8)
  gt = np.cumsum(rng.normal(0, 0.01, (51, 3)), axis=0)
  est = gt + rng.normal(0, 1e-4, gt.shape) + np.linspace(0, 1e-3, 51)[:, None]
  mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
  u, _, vt = np.linalg.svd((gt - mu_g).T @ (est - mu_e))
  R = u @ np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
  aligned = (est - mu_e) @ R.T + mu_g
  plain = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
  assert abs(peval.ate_rmse(est, gt)[0] - plain) <= 1e-12


def test_associate_and_rpe_match_jax(tmp_path):
  rng = np.random.default_rng(6)
  ts_a = np.sort(rng.uniform(0, 2, 50))
  ts_b = np.sort(rng.uniform(0, 2, 45))
  for max_diff in (0.005, 0.02, 0.1):
    for a, b in zip(peval.associate(ts_a, ts_b, max_diff),
                    jeval.associate(ts_a, ts_b, max_diff)):
      np.testing.assert_array_equal(a, b)
  est_path, gt_path = _trajectory_files(tmp_path, n=15, noise=0.0,
                                        drift=0.002)
  _, poses_e = read_tum_trajectory(est_path)
  _, poses_g = read_tum_trajectory(gt_path)
  for delta in (1, 3):
    for a, b in zip(peval.rpe(poses_e, poses_g, delta),
                    jeval.rpe(poses_e, poses_g, delta)):
      np.testing.assert_array_equal(a, b)
    p = peval.evaluate_rpe(est_path, gt_path, delta=delta)
    j = jeval.evaluate_rpe(est_path, gt_path, delta=delta)
    assert p.keys() == j.keys()
    np.testing.assert_allclose([p[k] for k in p], [j[k] for k in p],
                               rtol=0, atol=1e-8)
  r = peval.evaluate_rpe(est_path, gt_path)
  assert r["rpe_trans_rmse"] == pytest.approx(0.002, rel=0.05)


@pytest.mark.parametrize("flags", [[], ["--sim3", "--rpe", "--rpe_delta",
                                        "2", "--max_diff", "0.01"]])
def test_eval_cli_prints_what_jax_prints(tmp_path, flags):
  est_path, gt_path = _trajectory_files(tmp_path, drift=0.001)
  printed = []
  for main in (peval.main, jeval.main):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      assert main([est_path, gt_path, *flags]) == 0
    printed.append(out.getvalue())
  assert printed[0] == printed[1]
  assert printed[0].startswith("ate_rmse: ")


def _files(root):
  """{relative path: bytes} of every file under ``root``."""
  out = {}
  for dirpath, _, names in os.walk(root):
    for name in names:
      path = os.path.join(dirpath, name)
      with open(path, "rb") as f:
        out[os.path.relpath(path, root)] = f.read()
  return out


def test_tum_dataset_matches_jax_byte_for_byte(tmp_path):
  """64x48, 6 frames of the closed loop, with sensor noise, occluder boxes,
  a repeating texture and one blackout window: every file equal."""
  for name in ("write_tum_dataset", "straight_trajectory", "write_tum_video"):
    assert getattr(synthetic, name) is getattr(tum_synth, name)  # one writer
  traj = tum_synth.loop_trajectory(6)
  for a, b in zip(traj, jtum_synth.loop_trajectory(6)):
    np.testing.assert_array_equal(a, b)
  kwargs = dict(width=64, height=48, sensor_noise=True, occlusions=True,
                texture_period=0.3, blackout_windows=[(2, 4)], quiet=True)
  port = tum_synth.write_tum_dataset(str(tmp_path / "port"), traj, **kwargs)
  ref = jtum_synth.write_tum_dataset(str(tmp_path / "jax"), traj, **kwargs)
  files = _files(port)
  assert files == _files(ref)
  assert len(files) == 16   # 3 text files, the stamp, 6 + 6 PNGs
  assert "noise occlusions period=0.3 blackout=[(2, 4)]" in (
      files[".generator_stamp"].decode())
  # The straight trajectory: the port's SE(3) exponential against JAX's.
  for a, b in zip(tum_synth.straight_trajectory(8),
                  jtum_synth.straight_trajectory(8)):
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


def test_tum_synth_cli_matches_jax(tmp_path, monkeypatch):
  argv = ["--frames", "3", "--size", "40x30", "--noise", "--occlusions",
          "--seed", "9"]
  for name, main in (("port", lambda: tum_synth.main([str(tmp_path / "port"),
                                                     *argv])),
                     ("jax", jtum_synth.main)):
    monkeypatch.setattr(sys, "argv", ["tum_synth", str(tmp_path / name),
                                      *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
      main()
    assert out.getvalue() == f"wrote 3 frames to {tmp_path / name}\n"
  assert _files(tmp_path / "port") == _files(tmp_path / "jax")


@pytest.mark.parametrize("seed", [0, 3])
def test_plane_scene_matches_jax(seed):
  jcam = jsynthetic.default_test_camera(160, 120)
  pcam = synthetic.default_test_camera(160, 120)
  for a, b in zip(synthetic.make_plane_scene(pcam, seed=seed),
                  jsynthetic.make_plane_scene(jcam, seed=seed)):
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["sine", "ramp"])
def test_intensity_function_image_matches_jax(kind):
  a = synthetic.intensity_function_image(
      synthetic.default_test_camera(96, 72), kind)
  b = jsynthetic.intensity_function_image(
      jsynthetic.default_test_camera(96, 72), kind)
  assert a.dtype == b.dtype == np.float32
  np.testing.assert_array_equal(a, b)


def test_occlusion_world_matches_jax():
  """The boxes, the heightmap rendered with them and with a repeating
  texture, and the map metric with the boxes; the rendering without the
  new arguments is the one it always was."""
  boxes = synthetic.occlusion_boxes(5)
  np.testing.assert_array_equal(boxes, jsynthetic.occlusion_boxes(5))
  pcam = synthetic.default_test_camera(64, 48)
  jcam = jsynthetic.default_test_camera(64, 48)
  T = tum_synth.loop_trajectory(8)[3]
  for kwargs in (dict(boxes=boxes), dict(texture_period=0.25),
                 dict(boxes=boxes, texture_period=0.25), {}):
    for a, b in zip(synthetic.render_heightmap(pcam, T, **kwargs),
                    jsynthetic.render_heightmap(jcam, T, **kwargs)):
      np.testing.assert_array_equal(a, b)
  depth, _ = synthetic.render_heightmap(pcam, T, boxes=boxes)
  plain, _ = synthetic.render_heightmap(pcam, T)
  assert (depth < plain - 0.1).any()   # some pixels see a box
  rng = np.random.default_rng(0)
  pos = np.concatenate([boxes[:, 0] + rng.uniform(0, 0.02, (7, 3)),
                        rng.uniform(-0.5, 0.5, (30, 3)) + [0, 0, 1.0]])
  assert (synthetic.surfel_map_error(pos, boxes=boxes)
          == jsynthetic.surfel_map_error(pos, boxes=boxes))


def test_new_modules_import_nothing_of_jax_or_the_jax_package():
  modules = ("render", "snapshot_inspector", "eval", "utils.tum_synth",
             "utils.convergence", "utils.lm_optimizer", "geometry.distortion",
             "utils.synthetic")
  code = ("import sys; "
          + "; ".join(f"import badslam_tpu_torch.{m}" for m in modules)
          + "; bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'badslam_tpu')); assert not bad, bad")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
  subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, check=True,
                 timeout=120)
