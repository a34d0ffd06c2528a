"""A whole run of a cell at the rehearsal size on the CPU, past the
harness's look for a chip: it prints no device metric and comes out
correct; with the timed path broken underneath, ``correct`` comes out
false. The control, on the card only, runs the program with TF32 products
and must come out false too."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from portbench.harness import spec

RUN = importlib.util.spec_from_file_location(
    "portbench_run", os.path.join(str(spec.ROOT), "portbench", "run.py"))
run = importlib.util.module_from_spec(RUN)
RUN.loader.exec_module(run)

CPU = torch.device("cpu")
SEED = 2**31 + 977
DEVICE_METRICS = ("preprocess_roofline", "launches_per_frame",
                  "device_idle_share")


@pytest.mark.parametrize("trace_on", [False, True])
def test_cpu_rehearsal_prints_no_device_metric(tiny_cell, trace_on):
  cell = tiny_cell("seq_ba.sweep")
  correct, line = run.run_cell(cell, SEED, 6.0, trace_on, CPU)
  assert correct, line["checks"]
  assert line["device"]["platform"] == "cpu"
  assert "busy_s" not in line["device"] and "breakdown" not in line
  names = set(line["metrics"])
  assert not names & set(DEVICE_METRICS)
  if trace_on:
    assert "odometry_ms" in names and "ba_ms.seq" in names
  else:
    assert {"frames_per_s", "frame_ms_p95", "setup_s"} <= names
  assert line["attempted"] >= 3 and line["failed"] == 0
  assert list(line)[-1] == "checks"
  assert set(line["checks"]) == set(cell.limits)


def _unchanged_state(slam):
  """A step that returns its state unchanged: the frame is not processed."""
  real = slam.process_frame
  calls = [0]

  def step(i, *a, **k):
    calls[0] += 1
    if calls[0] > 12:   # after the warm-up
      return None
    return real(i, *a, **k)
  slam.process_frame = step


def _no_op_ba(slam):
  """A BA step that returns its state unchanged: DirectBA's pose and
  geometry updates skipped, on every path that calls it, so no keyframe
  pose or surfel moves, no surfel is made after the first keyframe's, and
  the frames keep their odometry poses."""
  ba = slam.direct_ba
  real = ba.bundle_adjustment

  def skipped(*args, **kwargs):
    kwargs.update(optimize_poses=False, optimize_geometry=False)
    return real(*args, **kwargs)
  ba.bundle_adjustment = skipped


def _half_of_the_image(slam):
  """Half of the batch left out: the kernel's outputs keep only the upper
  half of the image, and the rest of the frame works from that half."""
  from badslam_tpu_torch.slam import system
  real = system.fused_depth_preprocess

  def half(raw, calib, **kw):
    depth, normals, radius_sq = real(raw, calib, **kw)
    h = depth.shape[0] // 2
    depth, radius_sq = depth.clone(), radius_sq.clone()
    depth[h:] = 0.0
    radius_sq[h:] = 0.0
    return depth, normals, radius_sq
  system.fused_depth_preprocess = half
  slam._restore = lambda: setattr(system, "fused_depth_preprocess", real)


def _altered_pose(slam):
  """An answer altered where it is produced: every odd frame's pose turns by
  0.2 degrees about the optical axis after odometry (odd frames are never
  keyframes, so no later frame inherits the turn)."""
  real = slam.run_odometry
  a = np.radians(0.2)
  turn = np.array([[np.cos(a), -np.sin(a), 0, 0], [np.sin(a), np.cos(a), 0, 0],
                   [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)

  def odometry(frame_index, *args, **kwargs):
    real(frame_index, *args, **kwargs)
    if frame_index % 2 == 1:
      frame = slam.rgbd_video.frames[frame_index]
      frame.global_T_frame = frame.global_T_frame @ turn
  slam.run_odometry = odometry


def _altered_pixel(slam):
  """An answer altered where it is produced: one depth pixel of the
  kernel's output moves by 1 mm."""
  from badslam_tpu_torch.slam import system
  real = system.fused_depth_preprocess

  def altered(raw, calib, **kw):
    depth, normals, radius_sq = real(raw, calib, **kw)
    depth = depth.clone()
    ys, xs = torch.nonzero(depth > 0, as_tuple=True)
    depth[ys[len(ys) // 2], xs[len(xs) // 2]] += 1e-3
    return depth, normals, radius_sq
  system.fused_depth_preprocess = altered
  slam._restore = lambda: setattr(system, "fused_depth_preprocess", real)


# (fault, frames of the session before the window, the check it must fail,
# or None for any): a BA that makes no surfels shows once the session's
# keyframes have left the first one's view.
FAULTS = [(_unchanged_state, 30, None), (_no_op_ba, 200, "map_missing_share"),
          (_half_of_the_image, 30, None), (_altered_pose, 30, None),
          (_altered_pixel, 30, None)]


@pytest.mark.parametrize("fault, session, check", FAULTS,
                         ids=[f.__name__ for f, _, _ in FAULTS])
def test_broken_timed_path_is_not_correct(tiny_cell, fault, session, check):
  cell = tiny_cell("seq_ba.sweep", session)
  holder = {}

  def apply(slam):
    fault(slam)
    holder["slam"] = slam
  try:
    correct, line = run.run_cell(cell, SEED, 3.0, False, CPU, fault=apply)
  finally:
    restore = getattr(holder.get("slam"), "_restore", None)
    if restore is not None:
      restore()
  assert not correct, line["checks"]
  failed = [k for k, v in line["checks"].items()
            if v["value"] is None or v["value"] > v["limit"]]
  assert failed and (check is None or check in failed), failed


def _on_the_card(cell_name: str, seed: int, **kwargs):
  """(correct, line) of one run of a cell at its own size on the card."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the run is the cell's own, on the card")
  cell = spec.load_cell(cell_name)
  seconds = spec.load_json(spec.ROOT / "BENCHMARK.json")["run_seconds"]
  return run.run_cell(cell, seed, seconds, False, torch.device("cuda", 0),
                      **kwargs)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 5101, 2**31 + 5102, 2**31 + 5103])
def test_no_op_ba_is_not_correct_on_the_card(seed):
  """The BA step that leaves its state unchanged, in a cell at its own size
  on the card: some check fails. Run on the chip with ``python -m pytest
  portbench/tests -m cuda -s -n 0`` (one process on the card; the readings
  go to standard error)."""
  correct, line = _on_the_card("seq_ba.sweep", seed, fault=_no_op_ba)
  assert not correct, line["checks"]


@pytest.mark.cuda
def test_tf32_control_is_not_correct():
  """The control at the cell's own size and load, on the card: the program
  with TF32 products fails the check. Run on the chip with
  ``python -m pytest portbench/tests -m cuda -s -n 0``."""
  correct, line = _on_the_card("seq_ba.sweep", SEED, control="tf32")
  assert not correct, line["checks"]
