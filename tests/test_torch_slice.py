"""The odometry-only slice end to end: the port's CLI
(badslam_tpu_torch.main) against the JAX package's CLI on one TUM dataset,
the refusal of what is not ported, the dataset loader and the import
boundary.

Tolerances: exported poses agree per frame within 1e-4 m and 1e-4 rad, and
the two runs' ATE RMSE against groundtruth.txt within 1e-4 m.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import badslam_tpu.main as jax_main
from badslam_tpu.eval import ate_rmse
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 12
ODOMETRY_ONLY = ["--keyframe_interval", "5", "--num_scales", "4",
                 "--max_depth", "5.0",
                 "--max_num_ba_iterations_per_keyframe", "0",
                 "--no_loop_detection", "--sequential_ba",
                 "--restrict_fps_to", "0", "--quiet"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  """A 160x120 TUM dataset of the heightmap world along the constant-twist
  trajectory, written by the port's writer."""
  out = str(tmp_path_factory.mktemp("tum160"))
  return synthetic.write_tum_dataset(
      out, synthetic.straight_trajectory(FRAMES), width=160, height=120)


def test_cli_trajectory_matches_jax(dataset, tmp_path):
  port_poses = str(tmp_path / "port.txt")
  jax_poses = str(tmp_path / "jax.txt")
  assert port_main.main([dataset, *ODOMETRY_ONLY, "--device", "cpu",
                         "--export_poses", port_poses]) == 0
  assert jax_main.main([dataset, *ODOMETRY_ONLY,
                        "--export_poses", jax_poses]) == 0
  ts_p, poses_p = read_tum_trajectory(port_poses)
  ts_j, poses_j = read_tum_trajectory(jax_poses)
  assert poses_p.shape == poses_j.shape == (FRAMES, 4, 4)
  np.testing.assert_array_equal(ts_p, ts_j)
  trans = np.linalg.norm(poses_p[:, :3, 3] - poses_j[:, :3, 3], axis=1)
  rel = np.linalg.inv(poses_j.astype(np.float64)) @ poses_p
  rot = se3.log(torch.from_numpy(rel.astype(np.float32)))[:, 3:].norm(dim=-1)
  assert trans.max() <= 1e-4, trans
  assert float(rot.max()) <= 1e-4, rot

  _, gt = read_tum_trajectory(os.path.join(dataset, "groundtruth.txt"))
  ate_port = ate_rmse(poses_p[:, :3, 3], gt[:, :3, 3])[0]
  ate_jax = ate_rmse(poses_j[:, :3, 3], gt[:, :3, 3])[0]
  assert abs(ate_port - ate_jax) <= 1e-4, (ate_port, ate_jax)
  assert ate_port < 2e-3  # tracked, not just agreeing


@pytest.mark.parametrize("flags", [
    [],  # the defaults run loop detection, parallel BA and BA iterations
    ["--max_num_ba_iterations_per_keyframe", "5"],
    ["--export_point_cloud", "x.ply"],
    ["--mesh_devices", "2"],
    ["--prewarm"],
    ["--no_pose_estimation"],
])
def test_unported_flags_are_refused(dataset, flags):
  base = [] if not flags else [
      "--max_num_ba_iterations_per_keyframe", "0", "--no_loop_detection",
      "--sequential_ba"]
  with pytest.raises(SystemExit, match="ROADMAP"):
    port_main.main([dataset, "--device", "cpu", *base, *flags])


def test_dataset_loader_matches_jax(dataset, tmp_path):
  """Raw TUM layout (rgb.txt + depth.txt, no associated.txt), trajectory
  interpolation at frame timestamps, and image decoding."""
  from badslam_tpu.io import dataset as jax_dataset
  from badslam_tpu_torch.io import dataset as port_dataset
  raw = tmp_path / "raw"
  raw.mkdir()
  for name in ("calibration.txt", "rgb", "depth"):
    os.symlink(os.path.join(dataset, name), raw / name)
  with open(os.path.join(dataset, "associated.txt")) as f:
    rows = [line.split() for line in f if line.strip()]
  (raw / "rgb.txt").write_text("".join(f"{r[0]} {r[1]}\n" for r in rows))
  (raw / "depth.txt").write_text("".join(f"{r[2]} {r[3]}\n" for r in rows))
  # Ground truth at half the frame rate, so poses interpolate between rows.
  with open(os.path.join(dataset, "groundtruth.txt")) as f:
    (raw / "gt.txt").write_text("".join(f.readlines()[::2]))
  jv = jax_dataset.load_tum_dataset(str(raw), "gt.txt")
  pv = port_dataset.load_tum_dataset(str(raw), "gt.txt")
  assert pv.frame_count() == jv.frame_count() == FRAMES
  assert pv.depth_camera == jv.depth_camera
  for fp, fj in zip(pv.frames, jv.frames):
    assert (fp.rgb_timestamp, fp.depth_timestamp) == (
        fj.rgb_timestamp, fj.depth_timestamp)
    np.testing.assert_allclose(fp.global_T_frame, fj.global_T_frame,
                               atol=1e-6)
    np.testing.assert_array_equal(fp.depth_raw(), fj.depth_raw())
    np.testing.assert_array_equal(fp.rgb(), fj.rgb())


def test_port_imports_no_jax():
  code = ("import sys, badslam_tpu_torch.main, badslam_tpu_torch.slam.system,"
          " badslam_tpu_torch.ops.fused_preprocess, badslam_tpu_torch.kernels"
          ".build; bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'badslam_tpu')]; assert not bad, bad")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                 check=True, timeout=120)

