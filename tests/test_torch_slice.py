"""The port end to end: its CLI (badslam_tpu_torch.main) against the JAX
package's CLI on one TUM dataset, odometry-only and with sequential BA on,
the refusal of what is not ported, the dataset loader and the import
boundary.

Tolerances: exported poses agree per frame within 1e-4 m and 1e-4 rad, and
the two runs' ATE RMSE against groundtruth.txt within 1e-4 m. With BA on,
also: live surfel counts within 1%, both exported maps' median |error|
against the heightmap < 1e-3 m and within 1e-4 m of each other.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import badslam_tpu.main as jax_main
from badslam_tpu.eval import ate_rmse
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io import ply
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 16
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


SEQUENTIAL_BA = ["--keyframe_interval", "4",
                 "--max_num_ba_iterations_per_keyframe", "3",
                 "--sparsification", "2", "--num_scales", "4",
                 "--max_depth", "5.0", "--sequential_ba",
                 "--no_loop_detection", "--restrict_fps_to", "0", "--quiet"]


def _assert_same_trajectory(dataset, port_poses, jax_poses):
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


def test_cli_trajectory_matches_jax(dataset, tmp_path):
  port_poses = str(tmp_path / "port.txt")
  jax_poses = str(tmp_path / "jax.txt")
  assert port_main.main([dataset, *ODOMETRY_ONLY, "--device", "cpu",
                         "--export_poses", port_poses]) == 0
  assert jax_main.main([dataset, *ODOMETRY_ONLY,
                        "--export_poses", jax_poses]) == 0
  _assert_same_trajectory(dataset, port_poses, jax_poses)


@pytest.mark.parametrize("extra", [
    [], ["--final_ba_iterations", "1", "--use_deactivation"]],
    ids=["ba", "final_ba_with_deactivation"])
def test_cli_with_ba_matches_jax(dataset, tmp_path, extra):
  """Sequential BA through both CLIs: 4 keyframes, 3 BA iterations planned
  per keyframe, cell 2; trajectory, surfel count and exported map."""
  out = {}
  for name, main, device in (("port", port_main.main, ["--device", "cpu"]),
                             ("jax", jax_main.main, [])):
    out[name] = dict(poses=str(tmp_path / f"{name}.txt"),
                     ply=str(tmp_path / f"{name}.ply"),
                     stream=str(tmp_path / f"{name}_ba.txt"))
    assert main([dataset, *SEQUENTIAL_BA, *extra, *device,
                 "--export_poses", out[name]["poses"],
                 "--export_point_cloud", out[name]["ply"],
                 "--save_timings", out[name]["stream"]]) == 0
  _assert_same_trajectory(dataset, out["port"]["poses"], out["jax"]["poses"])

  # --save_timings: one line per BA iteration, the same schedule in both.
  def schedule(path):
    with open(path) as f:
      return [tuple(line.split()[:6]) for line in f]
  lines = schedule(out["port"]["stream"])
  assert lines == schedule(out["jax"]["stream"]) and len(lines) >= 3

  pos_p, nrm_p, col_p = ply.load_point_cloud_ply(out["port"]["ply"])
  pos_j, _, _ = ply.load_point_cloud_ply(out["jax"]["ply"])
  assert len(pos_p) > 1000 and np.isfinite(pos_p).all()
  assert nrm_p.shape == pos_p.shape and col_p.dtype == np.uint8
  assert abs(len(pos_p) - len(pos_j)) <= 0.01 * len(pos_j)
  err_p = synthetic.surfel_map_error(pos_p)
  err_j = jsynthetic.surfel_map_error(pos_j)
  assert err_p["median_abs_m"] < 1e-3 and err_j["median_abs_m"] < 1e-3
  assert abs(err_p["median_abs_m"] - err_j["median_abs_m"]) <= 1e-4
  # The port's copy of the metric is the reference's.
  assert synthetic.surfel_map_error(pos_j) == pytest.approx(err_j, rel=1e-9)


@pytest.mark.parametrize("flags,map_gate", [
    (["--no_surfel_updates"], 1e-3), (["--no_geometric_residuals"], 1e-2),
    (["--no_photometric_residuals"], 1e-3),
    (["--target_frame_rate", "1000"], 1e-3),
    (["--no_active_kf_window"], 1e-3)],
    ids=lambda f: f[0].lstrip("-") if isinstance(f, list) else "")
def test_cli_ba_options_run(dataset, tmp_path, flags, map_gate):
  """Each BA option of the CLI drives a whole run on the CPU: finite poses
  that track, and a map on the surface. Without geometric residuals the
  photometric term alone leaves a surfel's offset along its normal nearly
  free, and the map's median error is 5.5 mm in the reference as in the
  port (the same run of both CLIs, 10 frames); its gate is 1e-2 m."""
  poses = str(tmp_path / "poses.txt")
  cloud = str(tmp_path / "map.ply")
  timings = str(tmp_path / "timings.txt")
  assert port_main.main([dataset, *SEQUENTIAL_BA, *flags, "--device", "cpu",
                         "--export_poses", poses, "--end_frame", "9",
                         "--export_point_cloud", cloud,
                         "--export_final_timings", timings]) == 0
  _, est = read_tum_trajectory(poses)
  _, gt = read_tum_trajectory(os.path.join(dataset, "groundtruth.txt"))
  assert est.shape == (10, 4, 4) and np.isfinite(est).all()
  assert ate_rmse(est[:, :3, 3], gt[:10, :3, 3])[0] < 2e-3
  pos, _, _ = ply.load_point_cloud_ply(cloud)
  assert len(pos) > 1000
  assert synthetic.surfel_map_error(pos)["median_abs_m"] < map_gate
  with open(timings) as f:
    assert "Bundle adjustment" in f.read()


@pytest.mark.parametrize("flags", [
    [],  # the defaults run loop detection, parallel BA and BA iterations
    ["--use_pcg"],
    ["--save_state", "x"],
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
          ".build, badslam_tpu_torch.slam.direct_ba, badslam_tpu_torch.models"
          ".surfel_ops, badslam_tpu_torch.models.geometry_opt, "
          "badslam_tpu_torch.models.surfels, badslam_tpu_torch.models"
          ".keyframes, badslam_tpu_torch.models.pose_opt, badslam_tpu_torch"
          ".loop.trajectory_deformation, badslam_tpu_torch.io.ply; "
          "bad = [m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'badslam_tpu')]; assert not bad, bad")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                 check=True, timeout=120)

