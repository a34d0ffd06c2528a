"""The port's parallel BA thread on the CPU: the twins of the reference's
concurrency, watchdog and real-time pacing tests, parity with the JAX
package where the thread order is fixed, the calibration hand-off between
the BA thread and the front-end, a failing BA thread, and the CLI with the
reference's bare defaults.

A parallel run's schedule depends on timing, so parity is held only where
the test fixes the order: ``quiesce()`` after every frame, in both packages.
There the trajectories agree per frame within 1e-4 m and 1e-4 rad and the
live surfel counts within 1%. The free-running runs are held to invariants
and accuracy gates: translation error against the truth < 2e-2 m under
forced merges (the reference's gate); for the default CLI ATE RMSE < 2e-3 m
and the map's median |error| < 1e-3 m.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.eval import ate_rmse
from badslam_tpu.slam.system import BadSlam as JaxBadSlam
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io import ply
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.models import odometry as odometry_mod
from badslam_tpu_torch.slam import direct_ba as direct_ba_mod
from badslam_tpu_torch.slam import system as system_mod
from badslam_tpu_torch.slam.system import BadSlam, BAThreadError
from badslam_tpu_torch.utils import synthetic, tum_synth

W, H = 160, 120
STEP = np.asarray([0.002, 0.0008, -0.0004, 0.0004, -0.0002, 0.0003],
                  np.float32)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread per Python thread: the frames are small, and the
  suite's worker processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def _trajectory(n):
  return [se3.exp(torch.from_numpy(i * STEP)).numpy() for i in range(n)]


def _config(**kw):
  base = dict(
      keyframe_interval=2, max_num_ba_iterations_per_keyframe=5,
      num_scales=4, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
      parallel_ba=True, enable_loop_detection=False,
      initial_keyframe_capacity=4, initial_surfel_capacity=1 << 14)
  base.update(kw)
  return base


def _make_slam(n_frames, keyframe_interval=2, loop_detection=True,
               ba_iterations_per_keyframe=5):
  """tests/test_concurrency.py's system: the heightmap world, parallel BA,
  and the detection thread with a short recent-exclusion window."""
  cam = synthetic.default_test_camera(W, H)
  traj = _trajectory(n_frames)
  video = synthetic.make_heightmap_video(cam, traj)
  cfg = BadSlamConfig(**_config(
      keyframe_interval=keyframe_interval,
      max_num_ba_iterations_per_keyframe=ba_iterations_per_keyframe,
      enable_loop_detection=loop_detection,
      parallel_loop_detection=loop_detection))
  det = (LoopDetector(cfg, cam, parallel=True, recent_exclude=4)
         if loop_detection else None)
  return BadSlam(cfg, video, device="cpu", loop_detector=det), traj, video


def _valid(slam):
  return slam.direct_ba.kf.valid.numpy()


def _check_invariants(slam, merges_forced):
  ba = slam.direct_ba
  valid = _valid(slam)
  watermark = ba.keyframe_count
  assert valid[watermark:].sum() == 0
  # Every merge must show: a lost concurrent update would bring a deleted
  # keyframe back.
  assert valid[:watermark].sum() == watermark - merges_forced
  assert np.isfinite(ba.kf.global_T_frame.numpy()[valid]).all()
  assert not slam._queued_keyframes
  assert slam._ba_thread is None
  det = slam.loop_detector
  if det is not None:
    for e in det.entries:
      assert e is None or (0 <= e.kf_slot < len(valid) and valid[e.kf_slot])
    assert det.num_loops_closed + det.num_loops_ignored == len(det.events)
    assert det._detection_thread is None


def _wait(predicate, what, seconds=120.0):
  deadline = time.monotonic() + seconds
  while not predicate():
    assert time.monotonic() < deadline, what
    time.sleep(0.01)


def test_parallel_ba_detection_and_merges_under_load():
  """The BA thread, the detection thread and forced merges at once. A merge
  is requested every 8 frames once 6 keyframes were made (registered or
  still queued), and the frame loop goes on once the BA thread has taken
  the request; the merges must all land, in the store and the detector."""
  slam, traj, video = _make_slam(24, ba_iterations_per_keyframe=3)
  # Switch threads 50x as often as by default, so that an unguarded
  # read-modify-write of shared state is more likely to lose an update.
  interval = sys.getswitchinterval()
  sys.setswitchinterval(1e-4)
  try:
    for i in range(24):
      slam.process_frame(i)
      made = slam.direct_ba.keyframe_count + len(slam._queued_keyframes)
      if i % 8 == 7 and made >= 6:
        slam.request_keyframe_merge()
        _wait(lambda: not slam._merge_requested, "merge request not taken")
    slam.stop_ba_thread_and_wait()
  finally:
    sys.setswitchinterval(interval)
  merges = slam.direct_ba.keyframe_count - int(_valid(slam).sum())
  assert merges >= 1 and merges == slam.num_keyframes_merged
  _check_invariants(slam, merges)
  errs = [np.linalg.norm(video.frames[i].global_T_frame[:3, 3]
                         - traj[i][:3, 3]) for i in range(24)]
  assert max(errs) < 2e-2, f"drift {max(errs) * 1000:.1f} mm"


def test_merge_serviced_with_empty_iteration_queue():
  """With no BA iteration planned, a merge request alone still wakes the
  BA thread (the watchdog does not depend on BA, bad_slam.cc:958-968)."""
  slam, _, _ = _make_slam(14, loop_detection=False,
                          ba_iterations_per_keyframe=0)
  for i in range(14):
    slam.process_frame(i)
  # Nothing wakes the thread to register the queued keyframes: quiesce
  # registers them without stopping it.
  slam.quiesce()
  assert slam.direct_ba.keyframe_count >= 6
  before = int(_valid(slam).sum())
  slam.request_keyframe_merge()
  _wait(lambda: int(_valid(slam).sum()) < before,
        "merge request never serviced without BA iterations")
  after = int(_valid(slam).sum())
  slam.stop_ba_thread_and_wait()
  _check_invariants(slam, before - after)


def test_parallel_shutdown_with_pending_work():
  """Stopping with keyframes and iterations still queued drains them all;
  a second stop does nothing."""
  slam, _, _ = _make_slam(12, loop_detection=False)
  for i in range(12):
    slam.process_frame(i)
  slam.stop_ba_thread_and_wait()
  _check_invariants(slam, 0)
  assert slam.direct_ba.keyframe_count == 6
  slam.stop_ba_thread_and_wait()


def test_watchdog_merges_on_the_ba_thread():
  """tests/test_memory_watchdog.py:45-67 under parallel BA: every keyframe
  creation sees pressure, the request goes to the BA thread, the anchor
  keyframe survives and the store stays consistent."""
  cam = synthetic.default_test_camera(W, H)
  traj = [se3.exp(torch.tensor([0.003 * i, 0.001 * i, 0, 0.0008 * i, 0, 0]))
          .numpy() for i in range(13)]
  video = synthetic.make_synthetic_video(
      cam, traj, synthetic.plane_world_normals())
  cfg = BadSlamConfig(**_config(
      num_scales=3, max_num_ba_iterations_per_keyframe=2,
      initial_keyframe_capacity=8, min_free_gpu_memory_mb=250))
  slam = BadSlam(cfg, video, device="cpu")
  limit = 16 * 1024 ** 3
  slam._device_memory_stats = lambda: (
      cfg.min_free_gpu_memory_mb * 1024 * 1024, limit)
  merged_on = []
  merge = slam.direct_ba.merge_keyframes
  slam.direct_ba.merge_keyframes = lambda *args: (merged_on.append(
      threading.current_thread().name), merge(*args))[1]
  for i in range(len(traj)):
    slam.process_frame(i)
  slam.stop_ba_thread_and_wait()
  # Seven keyframes each requested a merge; the requests that came while
  # one was pending coalesced, and every merge ran on the BA thread.
  assert 1 <= len(merged_on) <= 7 and set(merged_on) == {"ba_thread"}
  assert slam.num_keyframes_merged > 0
  valid = _valid(slam)
  assert valid[0]
  assert valid.sum() == (slam.direct_ba.keyframe_count
                         - slam.num_keyframes_merged)
  assert np.isfinite(slam.direct_ba.kf.global_T_frame.numpy()[valid]).all()


# --- real-time pacing (tests/test_realtime_pacing.py:43-89) ---


def _pacing_video(n):
  cam = synthetic.default_test_camera(W, H)
  traj = [se3.exp(torch.tensor([0.004 * i, 0, 0, 0, 0.0008 * i, 0]))
          .numpy() for i in range(n)]
  return synthetic.make_synthetic_video(cam, traj,
                                        synthetic.plane_world_normals())


def _pacing_config(**kw):
  return BadSlamConfig(**_config(
      keyframe_interval=4, num_scales=3, initial_keyframe_capacity=8,
      parallel_ba=False, max_num_ba_iterations_per_keyframe=10, **kw))


def test_fps_restriction_paces_playback():
  """With fps_restriction > 0, N frames take at least N / fps seconds."""
  n, fps = 6, 4.0
  slam = BadSlam(_pacing_config(fps_restriction=fps), _pacing_video(n),
                 device="cpu")
  t0 = time.perf_counter()
  for i in range(n):
    slam.process_frame(i)
    slam.end_frame()
  assert time.perf_counter() - t0 >= n / fps - 0.05


def test_target_frame_rate_bounds_ba_budget():
  """In real-time mode an exhausted frame budget defers BA (the planned
  iterations stay planned); offline, the same run spends them."""
  n = 10
  video = _pacing_video(n)
  slam = BadSlam(_pacing_config(target_frame_rate=1e6, fps_restriction=0),
                 video, device="cpu")
  for i in range(n):
    slam.process_frame(i)
    slam.end_frame()
  assert slam.num_planned_ba_iterations > 0
  assert all(np.isfinite(f.global_T_frame).all() for f in video.frames)
  offline = BadSlam(_pacing_config(fps_restriction=0), _pacing_video(n),
                    device="cpu")
  for i in range(n):
    offline.process_frame(i)
    offline.end_frame()
  assert offline.num_planned_ba_iterations == 0


def test_deadline_stops_ba_iterations():
  """A deadline in the past limits the scheme to one iteration."""
  slam = BadSlam(_pacing_config(fps_restriction=0), _pacing_video(9),
                 device="cpu")
  for i in range(9):
    slam.process_frame(i)
  done, _ = slam.run_bundle_adjustment(
      False, False, max_iterations=8, deadline=time.perf_counter() - 1.0,
      increase_ba_iteration_count=False)
  assert done == 1


# --- parity, the calibration hand-off, failure, the default CLI ---


def test_parallel_ba_matches_jax_when_quiesced_every_frame():
  """Both packages' BadSlam with parallel_ba=True on one heightmap video,
  each quiesced after every frame, so that the BA thread has registered
  every keyframe and run every requested iteration before the next frame
  starts."""
  n = 8
  cfg = _config(max_num_ba_iterations_per_keyframe=2)
  traj = _trajectory(n)
  port_video = synthetic.make_heightmap_video(
      synthetic.default_test_camera(W, H), traj)
  jax_video = jsynthetic.make_heightmap_video(
      jsynthetic.default_test_camera(W, H), traj)
  for pf, jf in zip(port_video.frames, jax_video.frames):
    np.testing.assert_array_equal(pf.depth_raw(), jf.depth_raw())
    np.testing.assert_array_equal(pf.rgb(), jf.rgb())
  port = BadSlam(BadSlamConfig(**cfg), port_video, device="cpu")
  ref = JaxBadSlam(JaxConfig(**cfg), jax_video)
  try:
    for i in range(n):
      port.process_frame(i)
      port.quiesce()
      ref.process_frame(i)
      ref.quiesce()
  finally:
    port.stop_ba_thread_and_wait()
    ref.stop_ba_thread_and_wait()
  assert port.direct_ba.keyframe_count == ref.direct_ba.keyframe_count == 4
  assert port.direct_ba.ba_iteration_count == ref.direct_ba.ba_iteration_count
  for i in range(n):
    a = port_video.frames[i].global_T_frame
    b = np.asarray(jax_video.frames[i].global_T_frame)
    assert np.linalg.norm(a[:3, 3] - b[:3, 3]) <= 1e-4, i
    rel = np.linalg.inv(b.astype(np.float64)) @ a
    rot = se3.log(torch.from_numpy(rel.astype(np.float32)))[3:].norm()
    assert float(rot) <= 1e-4, i
  ps, js = port.direct_ba.surfel_count, ref.direct_ba.surfel_count
  assert ps > 1000 and abs(ps - js) <= 0.01 * js


def test_ba_thread_intrinsics_step_between_two_readers_of_a_frame(
    monkeypatch):
  """A self-calibration step of the BA thread that lands after a frame's
  preprocessing and before its odometry: both readers of that frame see the
  calibration the frame started with, and the next frame's both see the
  new one, which the shared calibration object holds."""
  slam, _, _ = _make_slam(8, loop_detection=False,
                          ba_iterations_per_keyframe=1)
  seen = []
  step_at = 5
  real_preprocess = system_mod.fused_depth_preprocess
  real_track = odometry_mod.track_frame_pairwise

  def preprocess(raw, calibration, **kwargs):
    seen.append(("preprocess", calibration.depth_intr.clone(),
                 calibration.cfactor.clone()))
    out = real_preprocess(raw, calibration, **kwargs)
    if len(seen) == 2 * step_at:   # frame step_at; odometry not run yet
      before = slam.calibration.depth_intr.clone()
      slam.start_parallel_iterations(1, True, True)
      slam.quiesce()
      assert not torch.equal(slam.calibration.depth_intr, before)
    return out

  def track(base_pyr, tracked_pyr, camera, *rest, **kwargs):
    seen.append(("odometry", torch.stack([camera.fx, camera.fy, camera.cx,
                                          camera.cy]), None))
    return real_track(base_pyr, tracked_pyr, camera, *rest, **kwargs)

  monkeypatch.setattr(system_mod, "fused_depth_preprocess", preprocess)
  monkeypatch.setattr(odometry_mod, "track_frame_pairwise", track)
  try:
    for i in range(step_at + 2):
      slam.process_frame(i)
      if i < step_at:
        slam.quiesce()
  finally:
    slam.stop_ba_thread_and_wait()
  assert [kind for kind, _, _ in seen] == (
      ["preprocess"] + ["preprocess", "odometry"] * (step_at + 1))
  frames = [seen[0]] + [seen[1 + 2 * k: 3 + 2 * k]
                        for k in range(step_at + 1)]
  old, new = frames[step_at], frames[step_at + 1]
  # One frame, one calibration, whatever the BA thread did meanwhile.
  for pre, odo in (old, new):
    assert torch.equal(pre[1], odo[1])
  assert torch.equal(old[0][1], frames[step_at - 1][0][1])
  assert not torch.equal(new[0][1], old[0][1])
  assert torch.equal(new[0][1], slam.calibration.depth_intr)
  assert torch.equal(new[0][2], slam.calibration.cfactor)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("tum160"))
  return tum_synth.write_tum_dataset(
      out, tum_synth.straight_trajectory(16), width=W, height=H)


def test_cli_fails_when_the_ba_thread_fails(dataset, monkeypatch):
  """An error in one BA iteration on the BA thread ends the CLI with that
  error (a non-zero exit for ``python -m``), with the threads stopped."""
  real = direct_ba_mod.DirectBA.bundle_adjustment
  calls = []

  def failing(self, *args, **kwargs):
    if threading.current_thread().name == "ba_thread":
      calls.append(1)
      if len(calls) == 2:
        raise FloatingPointError("injected into one BA iteration")
    return real(self, *args, **kwargs)

  monkeypatch.setattr(direct_ba_mod.DirectBA, "bundle_adjustment", failing)
  before = set(threading.enumerate())
  with pytest.raises(BAThreadError, match="injected") as info:
    port_main.main([dataset, "--device", "cpu", "--keyframe_interval", "3",
                    "--max_num_ba_iterations_per_keyframe", "2",
                    "--no_loop_detection", "--restrict_fps_to", "0",
                    "--quiet"])
  assert isinstance(info.value.__cause__, FloatingPointError)
  assert len(calls) == 2
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]


def test_cli_runs_with_the_bare_defaults(dataset, tmp_path):
  """The reference's defaults: BA on its thread, loop detection on its
  thread, playback paced to 30 FPS, a keyframe every 10 frames."""
  poses = str(tmp_path / "poses.txt")
  cloud = str(tmp_path / "map.ply")
  before = set(threading.enumerate())
  assert port_main.main([dataset, "--device", "cpu", "--export_poses",
                         poses, "--export_point_cloud", cloud]) == 0
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
  _, est = read_tum_trajectory(poses)
  _, gt = read_tum_trajectory(os.path.join(dataset, "groundtruth.txt"))
  assert est.shape == (16, 4, 4) and np.isfinite(est).all()
  assert ate_rmse(est[:, :3, 3], gt[:, :3, 3])[0] < 2e-3
  pos, _, _ = ply.load_point_cloud_ply(cloud)
  assert len(pos) > 500
  assert synthetic.surfel_map_error(pos)["median_abs_m"] < 1e-3
