"""The port's depth preprocess (badslam_tpu_torch.ops.fused_preprocess and
depth_proc) against the JAX package, on the same numpy inputs.

On the CPU the port's wrapper runs its plain chain; it is held against the
JAX Pallas kernel (interpret mode, as tests/test_pallas_preprocess.py runs
it) and against the JAX XLA chain, at the JAX test's tolerances: depth
1e-5, normals 1e-4, radius 1e-6 (absolute). The CUDA kernel itself is
compared with the plain chain only where a GPU is present; a GPU machine
without JAX runs that case alone (README, "PyTorch/CUDA port").
"""

import numpy as np
import pytest
import torch

from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import fused_preprocess, image_proc
from badslam_tpu_torch.ops.depth_model import cfactor_shape
from badslam_tpu_torch.utils import synthetic

try:
  import jax.numpy as jnp
  from badslam_tpu.ops import depth_proc as jax_depth_proc
  from badslam_tpu.ops import image_proc as jax_image_proc
  from badslam_tpu.ops import pallas_preprocess
  from badslam_tpu.utils import synthetic as jax_synthetic
except ImportError:  # only the cuda-marked case can run there
  jnp = None

torch.set_num_threads(2)

TOL = {"filtered": 1e-5, "normals": 1e-4, "radius_sq": 1e-6}
KW = dict(sigma_xy=1.5, sigma_inv_depth=0.005, radius_factor=2.0,
          max_depth=5.0)
# sigma_xy = 1.0 gives bilateral radius int(2.0 * 1.0 + 0.5) = 2, which the
# CUDA kernel serves with its generic (not unrolled) instantiation.
KW_RADIUS_2 = dict(KW, sigma_xy=1.0)
CELL = 4
NEEDS_CUDA = "needs CUDA: the kernel is checked on the H100 by chip_smoke.py"


def _inputs(width, height, cfactor_kind):
  """Plane-scene depth with 2% holes and 1% beyond max_depth, as
  tests/test_pallas_preprocess.py makes it; a = 0.01."""
  cam = jax_synthetic.default_test_camera(width, height)
  depth, _ = jax_synthetic.make_plane_scene(cam, seed=3)
  rng = np.random.default_rng(0)
  d = np.asarray(depth).copy()
  d[rng.random(d.shape) < 0.02] = 0.0
  d[rng.random(d.shape) < 0.01] = 9.0
  hc, wc = cfactor_shape(height, width, CELL)
  if cfactor_kind == "const":
    cfactor = np.full((hc, wc), 0.001, np.float32)
  else:
    cfactor = rng.uniform(-0.01, 0.01, (hc, wc)).astype(np.float32)
  intr = np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)
  return cam, d, intr, np.float32(0.01), cfactor


def _assert_plain_chain_matches_jax(width, height, cfactor_kind, kw):
  cam, d, intr, a, cfactor = _inputs(width, height, cfactor_kind)
  jax_kernel = pallas_preprocess.fused_depth_preprocess(
      jnp.asarray(d), jnp.asarray(intr), jnp.asarray(a), jnp.asarray(cfactor),
      width=width, height=height, cell_size=CELL, interpret=True, **kw)
  filt = jax_depth_proc.bilateral_filter_and_cutoff(jnp.asarray(d), **kw)
  fb, nn = jax_depth_proc.compute_normals(filt, cam, jnp.asarray(a),
                                          jnp.asarray(cfactor), CELL)
  rr, fa = jax_depth_proc.compute_radii_and_remove_isolated(fb, cam)
  jax_chain = (fa, nn, rr)

  calib = DepthCalibration.from_numpy(intr, a, cfactor, 40.0, CELL,
                                      (width, height), "cpu")
  port = fused_preprocess.fused_depth_preprocess(torch.from_numpy(d), calib,
                                                 **kw)
  assert port[0].shape == (height, width)
  assert port[1].shape == (height, width, 2)
  assert (port[0] > 0).sum() > width * height // 10
  for ref in (jax_kernel, jax_chain):
    for name, got, want in zip(TOL, port, ref):
      np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                 atol=TOL[name], rtol=0, err_msg=name)


@pytest.mark.parametrize("cfactor_kind", ["const", "random"])
@pytest.mark.parametrize("size", [(256, 128), (160, 120)])
def test_plain_chain_matches_jax_kernel_and_xla_chain(size, cfactor_kind):
  _assert_plain_chain_matches_jax(*size, cfactor_kind, KW)


@pytest.mark.parametrize("cfactor_kind", ["const", "random"])
def test_plain_chain_matches_jax_at_bilateral_radius_2(cfactor_kind):
  assert int(KW_RADIUS_2["radius_factor"] * KW_RADIUS_2["sigma_xy"] + 0.5) == 2
  _assert_plain_chain_matches_jax(160, 120, cfactor_kind, KW_RADIUS_2)


def test_wrapper_runs_plain_chain_on_cpu_and_refuses_other_devices():
  cam, d, intr, a, cfactor = _inputs(160, 120, "random")
  calib = DepthCalibration.from_numpy(intr, a, cfactor, 40.0, CELL,
                                      (160, 120), "cpu")
  raw = torch.from_numpy(d)
  before = fused_preprocess.fused_depth_preprocess.launches
  got = fused_preprocess.fused_depth_preprocess(raw, calib, **KW)
  want = fused_preprocess.fused_depth_preprocess_reference(raw, calib, **KW)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  # The CPU path is the plain version, not a kernel launch.
  assert fused_preprocess.fused_depth_preprocess.launches == before
  with pytest.raises(ValueError):
    fused_preprocess.fused_depth_preprocess(raw.to("meta"), calib, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("size,kw", [((640, 480), KW), ((641, 479), KW),
                                     ((320, 240), KW_RADIUS_2)],
                         ids=["640x480", "641x479", "320x240-radius2"])
def test_cuda_kernel_matches_plain_chain(size, kw):
  if not torch.cuda.is_available():
    pytest.skip(NEEDS_CUDA)
  width, height = size
  cam = synthetic.default_test_camera(width, height)
  depth, _ = synthetic.render_heightmap(cam, np.eye(4, dtype=np.float32))
  rng = np.random.default_rng(width)
  depth[rng.random(depth.shape) < 0.02] = 0.0
  depth[rng.random(depth.shape) < 0.01] = 9.0
  cfactor = rng.uniform(-0.01, 0.01, cfactor_shape(height, width, CELL))
  calib = DepthCalibration.from_numpy(
      [cam.fx, cam.fy, cam.cx, cam.cy], 0.01, cfactor, 40.0, CELL,
      (width, height), "cuda")
  raw = torch.from_numpy(depth).cuda()
  before = fused_preprocess.fused_depth_preprocess.launches
  got = fused_preprocess.fused_depth_preprocess(raw, calib, **kw)
  assert fused_preprocess.fused_depth_preprocess.launches == before + 1
  want = fused_preprocess.fused_depth_preprocess_reference(raw, calib, **kw)
  torch.cuda.synchronize()
  for name, g, w in zip(TOL, got, want):
    np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                               atol=TOL[name], rtol=0, err_msg=name)


def test_rgb_to_intensity_is_exact():
  rng = np.random.default_rng(4)
  rgb = rng.integers(0, 256, size=(61, 83, 3), dtype=np.uint8)
  rgb[0, :3] = [[0, 0, 0], [255, 255, 255], [1, 254, 127]]
  want = np.asarray(jax_image_proc.rgb_to_intensity(jnp.asarray(rgb)))
  got = image_proc.rgb_to_intensity(torch.from_numpy(rgb)).numpy()
  np.testing.assert_array_equal(got, want)


def test_sobel_gradient_magnitude_matches_jax():
  rng = np.random.default_rng(5)
  img = (rng.integers(0, 256, size=(37, 53)) / 255.0).astype(np.float32)
  want = np.asarray(jax_image_proc.sobel_gradient_magnitude(
      jnp.asarray(img)))
  got = image_proc.sobel_gradient_magnitude(torch.from_numpy(img)).numpy()
  np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
