"""The port's input paths and reconstruction export against the JAX
package: the median filter and the pyramid-level downscales of the depth
and color inputs, the cfactor resampling of ``--export_reconstruction``,
``--no_pose_estimation`` through both CLIs, the twins of the reference's
``--export_reconstruction`` and ``--pyramid_level_for_depth/color`` tests,
and the frame prefetcher.

Tolerances: the depth filters and the RGB downscale are exact (medians and
one rounding of the same float32 sums); the cfactor resampling agrees with
``jax.image.resize`` within 1e-8 (a few ulps of the 0.01-sized values),
growing and shrinking; with --no_pose_estimation both CLIs export the
dataset's trajectory (within 1e-6, the text files' rounding) and maps whose
sizes agree within 1%.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import badslam_tpu.main as jax_main
from badslam_tpu.ops import depth_proc as jax_depth_proc
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io import dataset as port_dataset
from badslam_tpu_torch.io import ply
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.ops import depth_model, depth_proc
from badslam_tpu_torch.slam import system as system_mod
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic, tum_synth

W, H = 160, 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread: the frames are small, and the suite's worker
  processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def _depth_with_holes(h, w, seed):
  rng = np.random.default_rng(seed)
  depth = rng.uniform(0.5, 4.0, (h, w)).astype(np.float32)
  depth[rng.random((h, w)) < 0.3] = 0.0
  depth[: h // 5, : w // 4] = 0.0   # a hole larger than a 3x3 window
  return depth


@pytest.mark.parametrize("size", [(120, 160), (61, 83)], ids=["even", "odd"])
@pytest.mark.parametrize("op", ["median_filter", "depth_downscale",
                                "rgb_downscale"])
def test_input_filters_match_jax(op, size):
  h, w = size
  depth = _depth_with_holes(h, w, seed=h)
  rgb = np.random.default_rng(w).integers(0, 256, (h, w, 3), dtype=np.uint8)
  for levels in (1, 2):
    if op == "median_filter":
      want = jax_depth_proc.median_filter_and_densify(jnp.asarray(depth),
                                                      levels)
      got = depth_proc.median_filter_and_densify(torch.from_numpy(depth),
                                                 levels)
    elif op == "depth_downscale":
      want = jax_depth_proc.downscale_depth_median_excluding_invalid(
          jnp.asarray(depth), levels)
      got = depth_proc.downscale_depth_median_excluding_invalid(
          torch.from_numpy(depth), levels)
    else:
      want = jax_depth_proc.downscale_rgb(jnp.asarray(rgb), levels)
      got = depth_proc.downscale_rgb(torch.from_numpy(rgb), levels)
    assert got.dtype == {"rgb_downscale": torch.uint8}.get(op, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
  if op == "median_filter":
    # It fills holes next to valid pixels, and only those.
    assert (got.numpy() > 0).sum() > (depth > 0).sum()


@pytest.mark.parametrize("cells", [(4, 2), (4, 1), (4, 3), (2, 4), (2, 8)],
                         ids=lambda c: f"cell{c[0]}to{c[1]}")
def test_cfactor_resize_matches_jax_image_resize(cells):
  """The reconstruction's cfactor grid resampled from one cell size to
  another, finer (upscale) and coarser (downscale, antialiased)."""
  old, new = cells
  rng = np.random.default_rng(old * 10 + new)
  grid = rng.uniform(-0.01, 0.01,
                     depth_model.cfactor_shape(H, W, old)).astype(np.float32)
  shape = depth_model.cfactor_shape(H, W, new)
  want = np.asarray(jax.image.resize(jnp.asarray(grid), shape,
                                     method="bilinear"))
  got = depth_model.resize_cfactor(torch.from_numpy(grid), shape)
  assert tuple(got.shape) == shape
  np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8)


def _plane_world(seed=7):
  return synthetic.plane_world_normals(seed=seed)


def _plane_dataset(out, n, step):
  cam = synthetic.default_test_camera(W, H)
  traj = [se3.exp(torch.tensor(
      [step[0] * i, 0, 0, 0, step[1] * i, 0])).numpy() for i in range(n)]
  video = synthetic.make_synthetic_video(cam, traj, _plane_world())
  return tum_synth.write_tum_video(out, video, traj), cam


SMALL_MAP = ["--num_scales", "3", "--max_depth", "5.0",
             "--min_observation_count_while_bootstrapping_1", "1",
             "--min_observation_count_while_bootstrapping_2", "1",
             "--min_observation_count", "1", "--no_loop_detection",
             "--quiet"]


def test_cli_export_reconstruction(tmp_path, monkeypatch):
  """The twin of tests/test_io_and_cli.py:189: dense geometry-only BA at
  the reconstruction cell size gives a denser cloud on the true planes,
  and the system gets its own calibration back."""
  data, _ = _plane_dataset(str(tmp_path / "data"), 4, (0.003, 0.0008))
  sparse, dense = str(tmp_path / "sparse.ply"), str(tmp_path / "dense.ply")
  built = []
  original = system_mod.BadSlam

  def recording(*args, **kwargs):
    built.append(original(*args, **kwargs))
    return built[-1]

  monkeypatch.setattr(system_mod, "BadSlam", recording)
  assert port_main.main([data, *SMALL_MAP, "--sequential_ba", "--device",
                         "cpu", "--keyframe_interval", "2",
                         "--sparsification", "4",
                         "--export_point_cloud", sparse,
                         "--export_reconstruction", dense,
                         "--reconstruction_sparsification", "2"]) == 0
  sparse_pos, _, _ = ply.load_point_cloud_ply(sparse)
  dense_pos, dense_nrm, _ = ply.load_point_cloud_ply(dense)
  assert len(dense_pos) > 2 * len(sparse_pos)
  assert np.isfinite(dense_pos).all() and np.isfinite(dense_nrm).all()
  d = np.abs(dense_pos @ _plane_world().T + 2.5).min(axis=1)
  assert np.quantile(d, 0.9) < 0.01
  slam = built[-1]
  assert slam.direct_ba.calibration is slam.calibration
  assert slam.calibration.cell_size == 4
  assert slam.direct_ba.use_descriptor_residuals


def test_pyramid_level_input_scaling():
  """The twin of tests/test_io_and_cli.py:368: --pyramid_level_for_depth
  and --pyramid_level_for_color halve the inputs and the cameras."""
  cam = synthetic.default_test_camera(W, H)
  traj = [np.eye(4, dtype=np.float32)] * 2
  video = synthetic.make_synthetic_video(cam, traj, _plane_world())
  cfg = BadSlamConfig(
      pyramid_level_for_depth=1, pyramid_level_for_color=1,
      keyframe_interval=2, num_scales=2, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1, enable_loop_detection=False,
      parallel_ba=False,
      initial_keyframe_capacity=2, initial_surfel_capacity=1 << 12)
  slam = BadSlam(cfg, video, device="cpu")
  assert slam.direct_ba.depth_size == (W // 2, H // 2)
  assert slam.direct_ba.color_size == (W // 2, H // 2)
  assert float(slam.direct_ba.depth_camera().fx) == pytest.approx(
      cam.fx / 2)
  slam.process_frame(0)
  assert slam.direct_ba.keyframe_count == 1
  assert tuple(slam.direct_ba.kf.depth.shape[1:]) == (H // 2, W // 2)
  assert slam.direct_ba.surfel_count > 50


def test_cli_no_pose_estimation_matches_jax(tmp_path):
  """Mapping only: both CLIs keep the dataset's trajectory (the positional
  trajectory argument), run no odometry and no BA, and map from it."""
  data, _ = _plane_dataset(str(tmp_path / "data"), 5, (0.004, 0.0008))
  with open(os.path.join(data, "groundtruth.txt")) as f:
    (tmp_path / "data" / "trajectory.txt").write_text(f.read())
  out = {}
  for name, main, device in (("port", port_main.main, ["--device", "cpu"]),
                             ("jax", jax_main.main, [])):
    out[name] = (str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}.ply"))
    # No --sequential_ba: without pose estimation there is no BA thread.
    assert main([data, "trajectory.txt", *SMALL_MAP, *device,
                 "--no_pose_estimation", "--keyframe_interval", "2",
                 "--sparsification", "2", "--export_poses", out[name][0],
                 "--export_point_cloud", out[name][1]]) == 0
  ts_p, poses_p = read_tum_trajectory(out["port"][0])
  ts_j, poses_j = read_tum_trajectory(out["jax"][0])
  _, truth = read_tum_trajectory(os.path.join(data, "groundtruth.txt"))
  np.testing.assert_array_equal(ts_p, ts_j)
  np.testing.assert_allclose(poses_p, poses_j, rtol=0, atol=1e-6)
  np.testing.assert_allclose(poses_p, truth, rtol=0, atol=1e-6)
  pos_p, _, _ = ply.load_point_cloud_ply(out["port"][1])
  pos_j, _, _ = ply.load_point_cloud_ply(out["jax"][1])
  assert len(pos_p) > 500
  assert abs(len(pos_p) - len(pos_j)) <= 0.01 * len(pos_j)


def test_prefetcher_returns_the_direct_loads(tmp_path):
  """Frames read through the prefetcher, in order and out of order, hold
  the arrays that direct loads give; closing it stops its threads."""
  data = tum_synth.write_tum_dataset(
      str(tmp_path / "data"), tum_synth.straight_trajectory(9), width=W,
      height=H)
  direct = port_dataset.load_tum_dataset(data)
  video = port_dataset.load_tum_dataset(data)
  before = set(threading.enumerate())
  assert video.enable_prefetch()
  for i in list(range(9)) + [4, 0, 8]:
    f, g = video.frames[i], direct.frames[i]
    np.testing.assert_array_equal(f.depth_raw(), g.depth_raw())
    np.testing.assert_array_equal(f.rgb(), g.rgb())
    assert f.depth_raw().dtype == np.uint16 and f.pinned() is None
    f.clear_cache()
    g.clear_cache()
  video.close_prefetch()
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
  assert video.frames[3].depth_raw().shape == (H, W)
  # In-memory frames have no files to decode ahead.
  assert not synthetic.make_heightmap_video(
      synthetic.default_test_camera(W, H), [np.eye(4)]).enable_prefetch()
