"""The port's calibration and state files (badslam_tpu_torch.io.state) and
its CLI with self-calibration, against the JAX package's: one 12-frame run
of each CLI at 160x120 with a keyframe on every frame, so that the schedule
of ``--optimize_intrinsics`` (from the tenth keyframe on) fires, then a final
BA with both intrinsics flags; each run exports its trajectory, its
calibration and its state.

Tolerances: the two runs agree per frame within 1e-4 m and 1e-4 rad and
export calibrations within 1e-3 px, a within 1e-5 and cfactor within 1e-4
(a cell that only one or two surfels observe moves by up to 6.3e-5 when one
run's association keeps an observation that the other's drops: 10 of 4,800
cells are past 1e-5 after the run's five steps). A file
written by one package loads in the other: what the receiving system holds
equals the file (poses, surfels, calibration, counters, bit for bit), its
host mirrors verify, and the frame it tracks next lands within 1e-4 m of
where the other package's system, loaded from the other file, puts it.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import badslam_tpu.main as jax_main
from badslam_tpu.io import dataset as jax_dataset
from badslam_tpu.io import state as jax_state_io
from badslam_tpu.slam.system import BadSlam as JaxBadSlam
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig as PortConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io import dataset as port_dataset
from badslam_tpu_torch.io import state as state_io
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import tum_synth

torch.set_num_threads(2)

FRAMES = 13          # 12 for the runs, one more to track after a load
RUN_FRAMES = 12
SELF_CALIBRATION = [
    "--keyframe_interval", "1", "--max_num_ba_iterations_per_keyframe", "1",
    "--sparsification", "2", "--num_scales", "4", "--max_depth", "5.0",
    "--sequential_ba", "--no_loop_detection", "--restrict_fps_to", "0",
    "--quiet", "--end_frame", str(RUN_FRAMES - 1), "--optimize_intrinsics",
    "--final_ba_iterations", "1"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("tum160"))
  return tum_synth.write_tum_dataset(
      out, tum_synth.straight_trajectory(FRAMES), width=160, height=120)


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
  """Both CLIs' self-calibration runs: {package: paths of its exports}."""
  out = tmp_path_factory.mktemp("runs")
  paths = {}
  for name, main, device in (("port", port_main.main, ["--device", "cpu"]),
                             ("jax", jax_main.main, [])):
    paths[name] = dict(poses=str(out / f"{name}.txt"),
                       calibration=str(out / f"{name}_calibration"),
                       state=str(out / f"{name}_state.npz"),
                       timings=str(out / f"{name}_timings.txt"))
    assert main([dataset, *SELF_CALIBRATION, *device,
                 "--export_poses", paths[name]["poses"],
                 "--export_calibration", paths[name]["calibration"],
                 "--save_state", paths[name]["state"],
                 "--export_final_timings", paths[name]["timings"]]) == 0
  return paths


def _read_calibration(base):
  out = {}
  for name in ("depth", "color"):
    with open(f"{base}.{name}_intrinsics.txt") as f:
      out[name] = np.array([float(v) for v in f.readline().split()])
  deform = np.loadtxt(base + ".deformation.txt")
  out["a"], out["cfactor"] = deform[0], deform[1:]
  return out


def _pose_distance(a, b):
  """(metres, radians) between two (..., 4, 4) pose arrays."""
  rel = np.linalg.inv(np.asarray(b, np.float64)) @ np.asarray(a, np.float64)
  rot = se3.log(torch.from_numpy(rel.astype(np.float32)))[..., 3:].norm(dim=-1)
  return (np.linalg.norm(np.asarray(a)[..., :3, 3]
                         - np.asarray(b)[..., :3, 3], axis=-1).max(),
          float(rot.max()))


def test_cli_with_self_calibration_matches_jax(runs):
  _, poses_p = read_tum_trajectory(runs["port"]["poses"])
  _, poses_j = read_tum_trajectory(runs["jax"]["poses"])
  assert poses_p.shape == poses_j.shape == (RUN_FRAMES, 4, 4)
  trans, rot = _pose_distance(poses_p, poses_j)
  assert trans <= 1e-4 and rot <= 1e-4, (trans, rot)
  calib_p = _read_calibration(runs["port"]["calibration"])
  calib_j = _read_calibration(runs["jax"]["calibration"])
  for name in ("depth", "color"):
    np.testing.assert_allclose(calib_p[name], calib_j[name], rtol=0,
                               atol=1e-3)
  np.testing.assert_allclose(calib_p["a"], calib_j["a"], rtol=0, atol=1e-5)
  np.testing.assert_allclose(calib_p["cfactor"], calib_j["cfactor"], rtol=0,
                             atol=1e-4)
  assert (np.abs(calib_p["cfactor"] - calib_j["cfactor"]) > 1e-5).mean() < 0.01
  # Self-calibration ran (keyframes 10 to 12 and the final BA) and moved
  # the camera off the dataset's (60, 60, 79, 59).
  for name in ("port", "jax"):
    with open(runs[name]["timings"]) as f:
      count = re.search(r"BA intrinsics optimization\s+count\s+(\d+)",
                        f.read())
    assert count and int(count.group(1)) >= 4, name
  assert np.abs(calib_p["depth"] - [60, 60, 79, 59]).max() > 1e-3
  assert np.abs(calib_p["cfactor"]).max() > 0


def _fresh_systems(dataset, state_path):
  """A new system of each package with the configuration the state was
  saved with."""
  import json
  cfg = json.loads(str(np.load(state_path)["config"]))
  jcfg = jax_main.config_from_args(jax_main.build_parser().parse_args(
      [dataset]))
  jcfg = dataclasses.replace(jcfg, **cfg)
  jslam = JaxBadSlam(jcfg, jax_dataset.load_tum_dataset(
      dataset, None, raw_to_float_depth=jcfg.raw_to_float_depth))
  pslam = BadSlam(PortConfig(**cfg), port_dataset.load_tum_dataset(
      dataset, None, raw_to_float_depth=jcfg.raw_to_float_depth),
      device="cpu")
  return jslam, pslam


def test_state_files_load_across_packages(dataset, runs):
  """The port loads the state the JAX package saved, and the JAX package
  the state the port saved."""
  jslam, _ = _fresh_systems(dataset, runs["port"]["state"])
  _, pslam = _fresh_systems(dataset, runs["jax"]["state"])
  jax_state_io.load_state(runs["port"]["state"], jslam)
  state_io.load_state(runs["jax"]["state"], pslam)

  # The port holds what the JAX package's file holds.
  data = np.load(runs["jax"]["state"])
  ba = pslam.direct_ba
  n_kf = RUN_FRAMES
  assert ba.keyframe_count == n_kf == len(data["kf_frame_index"])
  assert ba.surfel_count == len(data["surfel_pos"]) > 1000
  np.testing.assert_array_equal(ba.kf.global_T_frame[:n_kf].numpy(),
                                data["kf_global_T_frame"])
  np.testing.assert_array_equal(ba.kf.covis[:n_kf, :n_kf].numpy(),
                                data["kf_covis"])
  np.testing.assert_array_equal(ba.kf.activation[:n_kf].numpy(),
                                data["kf_activation"])
  valid = ba.surfels.valid
  for field in ("pos", "normal", "radius_sq", "color", "desc"):
    np.testing.assert_array_equal(getattr(ba.surfels, field)[valid].numpy(),
                                  data[f"surfel_{field}"])
  np.testing.assert_array_equal(ba.calibration.depth_intr.numpy(),
                                data["depth_intr"])
  np.testing.assert_array_equal(ba.color_intr.numpy(), data["color_intr"])
  np.testing.assert_array_equal(ba.calibration.a.numpy(), data["a"])
  np.testing.assert_array_equal(ba.calibration.cfactor.numpy(),
                                data["cfactor"])
  assert ba.ba_iteration_count == int(data["ba_iteration_count"]) > 0
  assert pslam.num_planned_ba_iterations == int(
      data["num_planned_ba_iterations"])
  np.testing.assert_array_equal(ba.last_active_in_ba_iteration[:n_kf],
                                data["last_active_in_ba_iteration"])
  assert pslam.last_frame_index == RUN_FRAMES - 1
  assert pslam.base_kf_index == n_kf - 1
  poses = np.stack([f.global_T_frame for f in pslam.rgbd_video.frames])
  np.testing.assert_array_equal(poses[:RUN_FRAMES],
                                data["frame_poses"][:RUN_FRAMES])
  # The shared calibration object was written in place.
  assert pslam.calibration is ba.calibration
  ba.debug_verify_counts()

  # The JAX package holds what the port's file holds.
  data = np.load(runs["port"]["state"])
  jba = jslam.direct_ba
  assert jba.keyframe_count == n_kf
  assert jba.surfel_count == len(data["surfel_pos"])
  np.testing.assert_array_equal(np.asarray(jba.depth_intr),
                                data["depth_intr"])
  np.testing.assert_array_equal(np.asarray(jba.cfactor), data["cfactor"])
  np.testing.assert_array_equal(
      np.asarray(jba.kf.global_T_frame)[:n_kf], data["kf_global_T_frame"])
  assert jba.ba_iteration_count == int(data["ba_iteration_count"])
  jba.debug_verify_counts()

  # Both go on from there: the next frame is tracked against the restored
  # base keyframe, registered as a keyframe and bundle-adjusted.
  pslam.process_frame(RUN_FRAMES)
  jslam.process_frame(RUN_FRAMES)
  trans, rot = _pose_distance(
      pslam.rgbd_video.frames[RUN_FRAMES].global_T_frame,
      jslam.rgbd_video.frames[RUN_FRAMES].global_T_frame)
  assert trans <= 1e-4 and rot <= 1e-4, (trans, rot)
  assert ba.keyframe_count == jba.keyframe_count == n_kf + 1
  assert abs(ba.surfel_count - jba.surfel_count) <= 0.01 * jba.surfel_count
  ba.debug_verify_counts()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_calibration_files_load_across_packages(dataset, runs, tmp_path,
                                                writer):
  """A calibration exported by either package, imported by the other, and
  exported again gives the same three files, byte for byte."""
  jslam, pslam = _fresh_systems(dataset, runs[writer]["state"])
  again = str(tmp_path / "again")
  if writer == "jax":
    state_io.load_calibration(runs["jax"]["calibration"], pslam)
    state_io.save_calibration(again, pslam)
  else:
    jax_state_io.load_calibration(runs["port"]["calibration"], jslam)
    jax_state_io.save_calibration(again, jslam)
  for suffix in (".depth_intrinsics.txt", ".color_intrinsics.txt",
                 ".deformation.txt"):
    with open(runs[writer]["calibration"] + suffix) as f, \
        open(again + suffix) as g:
      assert f.read() == g.read(), suffix
  if writer == "jax":
    want = _read_calibration(runs["jax"]["calibration"])
    np.testing.assert_allclose(
        pslam.calibration.depth_intr.numpy(),
        want["depth"] + [0, 0, 0.5, 0.5], rtol=0, atol=1e-5)
    assert float(pslam.calibration.a) == pytest.approx(want["a"], abs=1e-9)


def test_load_state_refuses_what_the_reference_refuses(dataset, runs,
                                                       tmp_path):
  _, pslam = _fresh_systems(dataset, runs["port"]["state"])
  data = dict(np.load(runs["port"]["state"]))
  cases = (
      (dict(cell_size=np.asarray(4)), "snapshot cell_size 4 != configured 2"),
      (dict(depth_size=np.asarray([320, 240])),
       r"snapshot depth size .*320.*240.* != dataset \(160, 120\)"),
      (dict(color_size=np.asarray([320, 240])),
       r"snapshot color size .*320.*240.* != dataset \(160, 120\)"),
      (dict(magic=np.asarray("OTHER")), "Not a BADSLAM_TPU state file"),
      (dict(version=np.asarray(2)), "Unsupported state version 2"),
  )
  for i, (change, message) in enumerate(cases):
    path = str(tmp_path / f"bad{i}.npz")
    np.savez_compressed(path, **{**data, **change})
    with pytest.raises(ValueError, match=message):
      state_io.load_state(path, pslam)
  assert pslam.direct_ba.keyframe_count == 0
  state_io.load_state(runs["port"]["state"], pslam)
  with pytest.raises(ValueError, match="freshly-constructed system"):
    state_io.load_state(runs["port"]["state"], pslam)


def test_cli_round_trip_of_state_and_calibration(dataset, runs, tmp_path):
  """A second CLI run that loads the state and processes no frame exports
  the same poses, the same calibration and the same number of surfels."""
  poses = str(tmp_path / "poses.txt")
  calibration = str(tmp_path / "calibration")
  state = str(tmp_path / "state.npz")
  base = [a for a in SELF_CALIBRATION
          if a not in ("--final_ba_iterations",)][:-1]
  assert port_main.main([
      dataset, *base, "--device", "cpu", "--start_frame", "1000",
      "--load_state", runs["port"]["state"], "--export_poses", poses,
      "--export_calibration", calibration, "--save_state", state]) == 0
  with open(poses) as f, open(runs["port"]["poses"]) as g:
    assert f.read() == g.read()
  for suffix in (".depth_intrinsics.txt", ".color_intrinsics.txt",
                 ".deformation.txt"):
    with open(calibration + suffix) as f, \
        open(runs["port"]["calibration"] + suffix) as g:
      assert f.read() == g.read(), suffix
  a, b = np.load(state), np.load(runs["port"]["state"])
  assert len(a["surfel_pos"]) == len(b["surfel_pos"])
  for name in b.files:
    if name != "config":   # start_frame differs
      np.testing.assert_array_equal(a[name], b[name], err_msg=name)

  # --import_calibration alone: the calibration is the exported one.
  calibration2 = str(tmp_path / "calibration2")
  assert port_main.main([
      dataset, *base, "--device", "cpu", "--start_frame", "1000",
      "--import_calibration", runs["port"]["calibration"],
      "--export_calibration", calibration2]) == 0
  for suffix in (".depth_intrinsics.txt", ".color_intrinsics.txt",
                 ".deformation.txt"):
    with open(calibration2 + suffix) as f, \
        open(runs["port"]["calibration"] + suffix) as g:
      assert f.read() == g.read(), suffix
