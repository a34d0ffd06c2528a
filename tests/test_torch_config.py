"""The port's own copies of the configuration, the CLI parser and the device
choice (badslam_tpu_torch.config, .main, .slam.system) against the JAX
package's (badslam_tpu.config, .main).

Everything here compares exactly: field names, annotations and defaults,
parser actions, and the configuration a command line produces.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

import badslam_tpu.config as jax_config
import badslam_tpu.main as jax_main
import badslam_tpu_torch.config as port_config
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.io.dataset import Frame, RGBDVideo
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The odometry-only command line of chip_smoke.py.
ODOMETRY_ONLY = ["--keyframe_interval", "5", "--num_scales", "5",
                 "--max_depth", "5.0",
                 "--max_num_ba_iterations_per_keyframe", "0",
                 "--no_loop_detection", "--sequential_ba",
                 "--restrict_fps_to", "0", "--device_accurate_timings",
                 "--export_poses", "poses.txt", "--export_final_timings",
                 "timings.txt"]
ACTION_FIELDS = ("option_strings", "dest", "type", "default", "nargs",
                 "choices", "const", "required")


@pytest.mark.parametrize("name", ["BadSlamConfig", "DepthParams"])
def test_config_fields_equal_the_reference(name):
  def described(cls):
    return [(f.name, str(f.type), f.default, f.default_factory)
            for f in dataclasses.fields(cls)]
  port, ref = getattr(port_config, name), getattr(jax_config, name)
  assert described(port) == described(ref)
  assert port.__module__ == "badslam_tpu_torch.config"
  assert dataclasses.asdict(port()) == dataclasses.asdict(ref())


def test_loop_detection_frequency_fallback_equals_the_reference():
  for kwargs in ({}, {"loop_detection_image_frequency": 2.5},
                 {"keyframe_interval": 0}):
    assert (port_config.BadSlamConfig(**kwargs)
            .get_loop_detection_image_frequency(24.0)
            == jax_config.BadSlamConfig(**kwargs)
            .get_loop_detection_image_frequency(24.0))


def _actions(parser):
  return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_parser_actions_equal_the_reference_except_device():
  port = _actions(port_main.build_parser())
  ref = _actions(jax_main.build_parser())
  assert set(port) - set(ref) == {"device"}
  assert not set(ref) - set(port)
  assert [d for d in port if d != "device"] == list(ref)  # same order
  for dest, want in ref.items():
    got = port[dest]
    assert type(got) is type(want), dest
    for field in ACTION_FIELDS:
      assert getattr(got, field) == getattr(want, field), (dest, field)
  device = port["device"]
  assert device.option_strings == ["--device"]
  assert device.default == "cuda" and list(device.choices) == ["cuda", "cpu"]


@pytest.mark.parametrize("argv", [
    [],
    ODOMETRY_ONLY,
    ["--max_num_ba_iterations_per_keyframe", "25", "--use_deactivation",
     "--no_active_kf_window", "--no_surfel_updates", "--use_pcg",
     "--final_ba_iterations", "3", "--sparsification", "2",
     "--max_surfel_count", "1000000", "--surfel_merge_dist_factor", "0.5",
     "--min_observation_count", "2",
     "--min_observation_count_while_bootstrapping_1", "2",
     "--min_observation_count_while_bootstrapping_2", "3"],
    ["--sequential_loop_detection", "--loop_detection_image_frequency", "2.0",
     "--keyframe_interval", "7"],
    ["--optimize_intrinsics", "--intrinsics_optimization_interval", "4",
     "--no_geometric_residuals", "--baseline_fx", "35.5",
     "--bilateral_filter_sigma_xy", "1.0",
     "--bilateral_filter_radius_factor", "3.0",
     "--bilateral_filter_sigma_inv_depth", "0.01"],
    ["--pipelined_frontend", "--pipelined_concurrent_ba",
     "--target_frame_rate", "30", "--no_pallas_preprocess",
     "--min_free_gpu_memory_mb", "500"],
    ["gt.txt", "--depth_scaling", "1000", "--start_frame", "3",
     "--end_frame", "40", "--pyramid_level_for_depth", "1",
     "--pyramid_level_for_color", "1", "--no_motion_model",
     "--no_pose_estimation", "--no_photometric_residuals",
     "--median_filter_and_densify_iterations", "2"],
], ids=["defaults", "odometry_only", "ba", "loop", "intrinsics", "pipelined",
        "playback"])
def test_config_from_args_equals_the_reference(argv):
  port_args = port_main.build_parser().parse_args(["data", *argv])
  ref_args = jax_main.build_parser().parse_args(["data", *argv])
  port_vars = dict(vars(port_args))
  assert port_vars.pop("device") == "cuda"
  assert port_vars == vars(ref_args)
  port = port_main.config_from_args(port_args)
  assert isinstance(port, port_config.BadSlamConfig)
  assert dataclasses.asdict(port) == dataclasses.asdict(
      jax_main.config_from_args(ref_args))


def test_port_entry_points_import_nothing_of_jax_or_the_jax_package():
  code = ("import sys, badslam_tpu_torch.main, badslam_tpu_torch.slam.system,"
          " badslam_tpu_torch.config, badslam_tpu_torch.utils.logging; "
          "badslam_tpu_torch.main.build_parser(); "
          "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
          "('jax', 'jaxlib', 'badslam_tpu')); assert not bad, bad")
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, check=True,
                 timeout=120)


def _tiny_video():
  cam = synthetic.default_test_camera(32, 24)
  return RGBDVideo([Frame("", "", 0.0, 0.0)], cam, cam, 1.0 / 5000.0)


def _odometry_only_config():
  return port_config.BadSlamConfig(
      max_num_ba_iterations_per_keyframe=0, enable_loop_detection=False,
      parallel_ba=False)


def test_badslam_defaults_to_cuda_and_never_picks_the_cpu(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  for device in (None, "cuda", torch.device("cuda", 0)):
    with pytest.raises(RuntimeError, match="no CUDA device"):
      BadSlam(_odometry_only_config(), _tiny_video(), device=device)
  with pytest.raises(RuntimeError, match="no CUDA device"):
    BadSlam(_odometry_only_config(), _tiny_video())
  slam = BadSlam(_odometry_only_config(), _tiny_video(), device="cpu")
  assert slam.device == torch.device("cpu")


def test_cli_fails_without_a_card_and_runs_with_device_cpu(
    tmp_path, monkeypatch, capsys):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  data = synthetic.write_tum_dataset(
      str(tmp_path / "tum"), synthetic.straight_trajectory(3), width=64,
      height=48)
  argv = [data, "--keyframe_interval", "5", "--num_scales", "2",
          "--max_depth", "5.0", "--max_num_ba_iterations_per_keyframe", "0",
          "--no_loop_detection", "--sequential_ba", "--restrict_fps_to", "0",
          "--quiet"]
  with pytest.raises(SystemExit) as exc:
    port_main.main(argv)
  assert "no CUDA device" in str(exc.value.code)
  poses = tmp_path / "poses.txt"
  assert port_main.main([*argv, "--device", "cpu",
                         "--export_poses", str(poses)]) == 0
  assert len(poses.read_text().strip().splitlines()) == 3


def test_module_entry_point_exits_nonzero_without_a_card(tmp_path):
  """``python -m badslam_tpu_torch.main`` with the default device, in a
  process that sees no CUDA device."""
  if torch.cuda.is_available():
    pytest.skip("needs a machine without a CUDA device")
  data = synthetic.write_tum_dataset(
      str(tmp_path / "tum"), synthetic.straight_trajectory(2), width=64,
      height=48)
  env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
  proc = subprocess.run(
      [sys.executable, "-m", "badslam_tpu_torch.main", data,
       "--max_num_ba_iterations_per_keyframe", "0", "--no_loop_detection",
       "--sequential_ba", "--quiet"],
      cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
  assert proc.returncode != 0
  assert "no CUDA device" in proc.stderr
