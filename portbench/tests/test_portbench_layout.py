"""The harness is driven by data: a new configuration, traffic mix and
per-layer metric are files and entries in BENCHMARK.json, found by name;
and what the benchmark loads stays clear of the JAX package."""

import importlib.util
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench.harness import runner, spec

ROOT = str(spec.ROOT)
SEED = 2**31 + 4242

# A generator that is not a circle: a straight line at the sweep's speed.
LINE = '''"""A straight line along x, the camera looking down +z."""
import numpy as np


def poses(traffic, seed):
  n = int(traffic["rendered_frames"])
  out = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
  out[:, 0, 3] = float(traffic["step_m"]) * np.arange(n)
  return out
'''


def _run_module():
  loader = importlib.util.spec_from_file_location(
      "portbench_run", os.path.join(ROOT, "portbench", "run.py"))
  run = importlib.util.module_from_spec(loader)
  loader.loader.exec_module(run)
  return run


def test_every_cell_resolves():
  bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
  for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    assert cell.end_to_end and cell.per_layer and cell.limits
    assert "setup_s" in [m.name for m in cell.end_to_end]
    assert cell.config["session_frames"] > 0
    assert runner.badslam_config(cell.config) is not None
    poses = cell.generator.poses(cell.traffic, SEED)
    assert poses.shape == (cell.traffic["rendered_frames"], 4, 4)


@pytest.mark.parametrize("frames, stride, want", [
    (5, 1, [0, 1, 2, 3, 4]),
    (30, 10, [0, 10] + list(range(20, 30))),
    (250, 10, list(range(0, 240, 10)) + list(range(240, 250))),
])
def test_session_indices_make_the_sessions_keyframes(frames, stride, want):
  got = runner.session_indices(frames, stride)
  assert got == want
  # Every keyframe of the session (a keyframe every stride frames) is made.
  assert [i for i in got if i % stride == 0] == list(range(0, frames, stride))


def test_new_config_traffic_and_metric_are_files_alone(tmp_path):
  shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
  pb = tmp_path / "portbench"
  config = json.loads((pb / "configs" / "seq_ba.json").read_text())
  config["cli"] = config["cli"] + ["--keyframe_interval", "5"]
  (pb / "configs" / "seq_ba_kf5.json").write_text(json.dumps(config))
  traffic = json.loads((pb / "traffic" / "sweep.json").read_text())
  traffic["radius_m"] = 1.0
  (pb / "traffic" / "tight.json").write_text(json.dumps(traffic))
  (pb / "limits" / "seq_ba_kf5.tight.json").write_text(
      json.dumps({"limits": {"ate_rmse_m": 1.0}}))
  (pb / "metrics" / "window_frames.py").write_text(
      "def read(record):\n  return float(len(record.frame_s))\n")
  bench["configs"].append({"name": "seq_ba_kf5", "source": "x",
                           "file": "portbench/configs/seq_ba_kf5.json",
                           "reduced": [], "why": "x"})
  bench["workloads"].append({"name": "seq_ba_kf5.tight",
                             "config": "seq_ba_kf5", "traffic": "tight",
                             "chips": 1, "why": "x"})
  bench["per_layer"].append({"name": "window_frames", "unit": "frames",
                             "better": "higher", "source": "host_clock",
                             "layer": "x", "moves": "frames_per_s",
                             "workloads": ["seq_ba_kf5.tight"]})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  cell = spec.load_cell("seq_ba_kf5.tight", root=tmp_path)
  assert cell.traffic["radius_m"] == 1.0
  assert runner.badslam_config(cell.config).keyframe_interval == 5
  assert cell.limits == {"ate_rmse_m": 1.0}
  names = [m.name for m in cell.per_layer]
  assert names == ["window_frames"]
  record = runner.Record("cpu", 1.0, 2.0, [0.1, 0.2], {}, 0, False, {})
  assert cell.per_layer[0].read(record) == 2.0
  # The metrics without a workloads key hold in every cell.
  assert "frames_per_s" in [m.name for m in cell.end_to_end]
  assert "ba_iterations_per_s" not in [m.name for m in cell.end_to_end]


def test_new_generator_is_a_file_alone(tmp_path, tiny_cell):
  """A mix with new code: ``traffic/<generator>.py`` beside its data file,
  found by the mix's "generator" and run through a whole cell."""
  shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                  ignore=shutil.ignore_patterns("__pycache__"))
  pb = tmp_path / "portbench"
  (pb / "traffic" / "line.py").write_text(LINE)
  traffic = json.loads((pb / "traffic" / "sweep.json").read_text())
  for key in ("radius_m", "frames_per_circle", "wobble_m",
              "look_jitter_rad"):
    del traffic[key]
  traffic.update(name="line", generator="line", step_m=0.0063)
  (pb / "traffic" / "line.json").write_text(json.dumps(traffic))
  shutil.copy(pb / "limits" / "seq_ba.sweep.json",
              pb / "limits" / "seq_ba.line.json")
  bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
  bench["workloads"].append({"name": "seq_ba.line", "config": "seq_ba",
                             "traffic": "line", "chips": 1, "why": "x"})
  (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
  cell = tiny_cell("seq_ba.line", root=tmp_path)
  poses = cell.generator.poses(cell.traffic, SEED)
  assert np.allclose(poses[:, 1:3, 3], 0.0)
  assert np.isclose(poses[100, 0, 3], 0.63)
  correct, line = _run_module().run_cell(cell, SEED, 8.0, False,
                                         torch.device("cpu"))
  assert correct, line["checks"]
  assert line["attempted"] >= 3


def _loaded_top_level(code: str) -> set:
  out = subprocess.run(
      [sys.executable, "-c", code + "\nimport sys, json\n"
       "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
      cwd=ROOT, capture_output=True, text=True, timeout=300,
      env=dict(os.environ, PYTHONPATH=ROOT))
  assert out.returncode == 0, out.stderr
  return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_neither_jax_nor_program():
  top = _loaded_top_level(
      "import portbench.reference.judge, portbench.reference.scene, "
      "portbench.reference.preprocess")
  for name in ("jax", "jaxlib", "flax", "badslam_tpu", "badslam_tpu_torch"):
    assert name not in top


def test_harness_and_port_load_no_jax():
  top = _loaded_top_level(
      "import portbench.harness.runner, portbench.harness.trace\n"
      "from badslam_tpu_torch.slam.system import BadSlam\n"
      "import badslam_tpu_torch.main, badslam_tpu_torch.loop.detector")
  assert "badslam_tpu_torch" in top
  for name in ("jax", "jaxlib", "flax", "badslam_tpu"):
    assert name not in top


@pytest.mark.parametrize("modules, found", [
    (["badslam_tpu_torch", "badslam_tpu_torch.slam"], []),
    (["badslam_tpu.ops"], ["badslam_tpu.ops"]),
    (["jax._src.core", "jaxlib"], ["jax._src.core", "jaxlib"]),
    (["jaxtyping", "flax_like"], []),
])
def test_forbidden_modules_compare_top_level_names_whole(modules, found):
  run = _run_module()
  assert run.forbidden_modules(modules) == sorted(found)
  assert run.forbidden_modules() == []
