"""The port's odometry (badslam_tpu_torch.models.odometry) and the carried
depth calibration against the JAX package, on a heightmap frame pair made
with numpy.

Tolerances: H and b within 1e-4 of max|H| and the residual count exact at
one pyramid level; the tracked pose within 1e-5 per entry after 4-scale
coarse-to-fine GN at 160x120.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from badslam_tpu.models import odometry as jodometry
from badslam_tpu.ops import depth_model as jdepth_model
from badslam_tpu.ops import depth_proc as jdepth_proc
from badslam_tpu.ops import pyramid as jpyramid
from badslam_tpu.slam import system as jsystem
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io.dataset import Frame, RGBDVideo
from badslam_tpu_torch.models import odometry
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import depth_model, pyramid
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic, tum_synth

torch.set_num_threads(2)

W, H = 160, 120
CELL = 4
A = np.float32(0.01)
BASELINE_FX = np.float32(40.0)
PREPROCESS = dict(sigma_xy=1.5, sigma_inv_depth=0.005, radius_factor=2.0,
                  max_depth=5.0)


def _t(a):
  return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def pair():
  """Base and tracked frames of the heightmap world along the
  constant-twist trajectory (frame 0 and 2), the reference's preprocess,
  and a random cfactor with a = 0.01."""
  cam = jsynthetic.default_test_camera(W, H)
  traj = tum_synth.straight_trajectory(3)
  rng = np.random.default_rng(21)
  hc, wc = jdepth_model.cfactor_shape(H, W, CELL)
  cfactor = rng.uniform(-2e-3, 2e-3, (hc, wc)).astype(np.float32)
  intr = np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
  frames = []
  for T in (traj[0], traj[2]):
    depth, intensity = jsynthetic.render_heightmap(cam, T)
    filt = jdepth_proc.bilateral_filter_and_cutoff(jnp.asarray(depth),
                                                   **PREPROCESS)
    fb, normals = jdepth_proc.compute_normals(filt, cam, jnp.asarray(A),
                                              jnp.asarray(cfactor), CELL)
    _, fa = jdepth_proc.compute_radii_and_remove_isolated(fb, cam)
    frames.append(dict(raw=depth, filtered=np.asarray(fa),
                       normals=np.asarray(normals), intensity=intensity))
  base_T_tracked = (np.linalg.inv(traj[0]) @ traj[2]).astype(np.float32)
  return dict(cam=cam, intr=intr, cfactor=cfactor, frames=frames,
              base_T_tracked=base_T_tracked)


def _pyramids(pair, num_scales):
  """Both packages' pyramids of the pair: base = filtered depth, tracked =
  raw depth, both calibrated, as RunOdometry builds them."""
  base, tracked = pair["frames"]
  out = []
  for depth_key, f in (("filtered", base), ("raw", tracked)):
    jd = jdepth_model.calibrate_depth_image(
        jnp.asarray(A), jnp.asarray(pair["cfactor"]),
        jnp.asarray(f[depth_key]), CELL)
    td = depth_model.calibrate_depth_image(
        _t(A), _t(pair["cfactor"]), _t(f[depth_key]), CELL)
    out.append((
        jpyramid.build_pyramid(jd, jnp.asarray(f["normals"]),
                               jnp.asarray(f["intensity"]), num_scales),
        pyramid.build_pyramid(td, _t(f["normals"]), _t(f["intensity"]),
                              num_scales)))
  return out


@pytest.mark.parametrize("level,residual_type,use_desc", [
    (0, "gradient_xy", True),
    (1, "gradient_xy", True),
    (1, "gradmag", True),       # Sobel-magnitude photometric residual
    (1, "gradient_xy", False),  # depth residuals only
])
def test_frame_to_frame_h_b_and_cost_match_jax(pair, level, residual_type,
                                               use_desc):
  (jbase, tbase), (jtracked, ttracked) = _pyramids(pair, 2)
  jb, jt, tb, tt = jbase[level], jtracked[level], tbase[level], ttracked[level]
  if residual_type == "gradmag":
    from badslam_tpu.ops.image_proc import sobel_gradient_magnitude as jsobel
    from badslam_tpu_torch.ops.image_proc import sobel_gradient_magnitude
    jb, jt = (l._replace(intensity=jsobel(l.intensity)) for l in (jb, jt))
    tb, tt = (l._replace(intensity=sobel_gradient_magnitude(l.intensity))
              for l in (tb, tt))
  scaling = float(2 ** level)
  jcam = pair["cam"].scaled(1.0 / scaling)
  calib = DepthCalibration.from_numpy(pair["intr"], A, pair["cfactor"],
                                      BASELINE_FX, CELL, (W, H), "cpu")
  tcam = calib.camera().scaled(1.0 / scaling)
  # A pose near the truth, so most pixels associate.
  tracked_T_base = np.linalg.inv(pair["base_T_tracked"]).astype(np.float32)
  tracked_T_base[:3, 3] += [1e-3, -5e-4, 2e-4]
  flags = (True, use_desc, residual_type)
  args_j = (jnp.asarray(tracked_T_base), jb, jt, jcam,
            jnp.asarray(BASELINE_FX), scaling, *flags)
  args_t = (_t(tracked_T_base), tb, tt, tcam, calib.baseline_fx, scaling,
            *flags)
  Hj, bj, nj = jodometry.frame_to_frame_h_b(*args_j)
  Ht, bt, nt = odometry.frame_to_frame_h_b(*args_t)
  assert int(nt) == int(nj) > (W * H) // (4 ** level) // 4
  scale = float(np.abs(np.asarray(Hj)).max())
  np.testing.assert_allclose(Ht.numpy(), np.asarray(Hj), atol=1e-4 * scale,
                             rtol=0)
  np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=1e-4 * scale,
                             rtol=0)
  cj, mj = jodometry.frame_to_frame_cost(*args_j)
  ct, mt = odometry.frame_to_frame_cost(*args_t)
  terms = 1 + (0 if not use_desc else 2 if residual_type == "gradient_xy"
               else 1)
  assert int(mt) == int(mj) == terms * int(nj)
  np.testing.assert_allclose(float(ct), float(cj), rtol=1e-4)


def test_track_frame_pairwise_matches_jax(pair):
  (jbase, tbase), (jtracked, ttracked) = _pyramids(pair, 4)
  calib = DepthCalibration.from_numpy(pair["intr"], A, pair["cfactor"],
                                      BASELINE_FX, CELL, (W, H), "cpu")
  # Hypotheses as the motion model makes them: one good, one poor.
  init_1 = pair["base_T_tracked"].copy()
  init_1[:3, 3] += [2e-3, 1e-3, -1e-3]
  init_2 = np.eye(4, dtype=np.float32)
  Tj, nj = jodometry.track_frame_pairwise(
      jbase, jtracked, pair["cam"], jnp.asarray(BASELINE_FX),
      jnp.asarray(init_1), jnp.asarray(init_2), use_pyramid_level_0=True)
  Tt, nt = odometry.track_frame_pairwise(
      tbase, ttracked, calib.camera(), calib.baseline_fx, _t(init_1),
      _t(init_2), use_pyramid_level_0=True)
  np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-5, rtol=0)
  assert abs(int(nt) - int(nj)) <= 2
  # And both found the true relative pose.
  err = se3.log(_t(np.linalg.inv(pair["base_T_tracked"]) @ Tt.numpy()))
  assert float(err.abs().max()) < 1e-3


def test_calibration_carries_over_from_the_reference_state(pair):
  """DepthCalibration.from_numpy takes the reference's DirectBA arrays; the
  system's preprocess and odometry then match the reference's jitted
  system functions run on the same arrays (a != 0, random cfactor)."""
  cam = pair["cam"]
  calib = DepthCalibration.from_numpy(pair["intr"], A, pair["cfactor"],
                                      BASELINE_FX, CELL, (W, H), "cpu")
  np.testing.assert_array_equal(calib.depth_intr.numpy(), pair["intr"])
  np.testing.assert_array_equal(calib.cfactor.numpy(), pair["cfactor"])
  assert float(calib.a) == A and float(calib.baseline_fx) == BASELINE_FX
  assert calib.cell_size == CELL and calib.depth_size == (W, H)
  jcam = jsystem.make_camera(jnp.asarray(pair["intr"]), W, H)
  tcam = calib.camera()
  for f in ("fx", "fy", "cx", "cy", "width", "height"):
    assert float(getattr(tcam, f)) == float(getattr(jcam, f))

  traj = tum_synth.straight_trajectory(3)
  raw_to_float = 1.0 / 5000.0
  frames = []
  raws = []
  for i, T in enumerate((traj[0], traj[2])):
    depth, intensity = jsynthetic.render_heightmap(cam, T)
    u8 = np.clip(np.floor(intensity * 255.0 + 0.5), 0, 255).astype(np.uint8)
    raw = np.floor(depth / raw_to_float + 0.5).astype(np.uint16)
    frame = Frame("", "", i / 30.0, i / 30.0)
    frame._rgb = np.stack([u8] * 3, axis=-1)
    frame._depth = raw
    frames.append(frame)
    raws.append((raw, frame._rgb))
  video = RGBDVideo(frames, cam, cam, raw_to_float)
  from badslam_tpu_torch.config import BadSlamConfig
  cfg = BadSlamConfig(max_num_ba_iterations_per_keyframe=0,
                      enable_loop_detection=False, parallel_ba=False,
                      num_scales=4, max_depth=5.0,
                      sparse_surfel_cell_size=CELL)
  slam = BadSlam(cfg, video, device="cpu")
  slam.calibration = calib

  jproc = [jsystem._preprocess_jit(
      jnp.asarray(raw), jnp.asarray(rgb), jnp.asarray(pair["intr"]),
      jnp.asarray(A), jnp.asarray(pair["cfactor"]), W, H, CELL, 1.5, 0.005,
      2.0, 5.0, use_pallas=False, raw_scale=raw_to_float)
      for raw, rgb in raws]
  tproc = [slam.preprocess_frame(i) for i in range(2)]
  for jp, tp in zip(jproc, tproc):
    np.testing.assert_array_equal(tp.raw_depth.numpy(),
                                  np.asarray(jp.raw_depth))
    np.testing.assert_array_equal(tp.intensity.numpy(),
                                  np.asarray(jp.intensity))
    np.testing.assert_allclose(tp.depth.numpy(), np.asarray(jp.depth),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(tp.normals.numpy(), np.asarray(jp.normals),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(tp.radius_sq.numpy(),
                               np.asarray(jp.radius_sq), atol=1e-6, rtol=0)

  est = pair["base_T_tracked"].copy()
  est[:3, 3] += [1e-3, 0.0, -1e-3]
  Tj, nj = jsystem._odometry_jit(
      jproc[0].depth, jproc[0].normals, jproc[0].intensity,
      jproc[1].raw_depth, jproc[1].normals, jproc[1].intensity,
      jnp.asarray(pair["intr"]), jnp.asarray(A), jnp.asarray(pair["cfactor"]),
      jnp.asarray(BASELINE_FX), jnp.asarray(est), jnp.asarray(est),
      W, H, CELL, 4, True, True, True)
  slam.base_kf_images = tproc[0]
  slam.base_kf_tr_frame = [est]
  slam.frame_tr_base_kf = [np.linalg.inv(est).astype(np.float32)]
  slam.run_odometry(1, tproc[1])
  np.testing.assert_allclose(frames[1].global_T_frame, np.asarray(Tj),
                             atol=1e-5, rtol=0)
