"""The port's tracing (``badslam_tpu_torch/utils/timing.py``) and the spans
and counters the system records through it, on the CPU at 160x120:

  * ``Timing.count`` and the rule that a tag is a span or a counter;
  * every span's thread CPU time under ``"<tag> [cpu]"``, with as many
    samples as the span, and the lines of ``--export_final_timings``;
  * a profiler range per span while a ``torch.profiler`` session runs, on
    any thread, and none built without one;
  * "Odometry GN iterations": one sample per tracked frame, equal to the
    H/b evaluations of the GN loops, on the host and the pipelined
    (transfer-free) front-end; the loop closure's tracking adds none;
  * the loop detector's spans and its query and verification counters;
  * "Keyframe hand-off wait": one sample per keyframe queued for the BA
    thread.

The ``cuda`` case runs frames and a BA iteration under
``torch.cuda.set_sync_debug_mode("warn")`` with the spans and counters on
and patched out: the synchronizing calls are as many either way. Run it on
a card alone: ``python -m pytest -o addopts="" --noconftest -m cuda
tests/test_torch_tracing.py``.
"""

import contextlib
import re
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.models import odometry as odometry_mod
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic
from badslam_tpu_torch.utils.timing import Timing

W, H = 160, 120
GN = "Odometry GN iterations"
HANDOFF = "Keyframe hand-off wait"
LOOP_SPANS = ("Loop feature extraction", "Loop database query",
              "Loop verification")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread for this module: its frames are small, and the
  suite's worker processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def fresh_registry():
  Timing.reset()
  yield
  Timing.reset()


def _trajectory(n, step=(0.003, 0.001, 0, 0.0008, 0, 0)):
  step = np.asarray(step, np.float32)
  return [se3.exp(torch.from_numpy(i * step)).numpy() for i in range(n)]


def _config(**kw):
  base = dict(
      keyframe_interval=2, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
      max_num_ba_iterations_per_keyframe=0, enable_loop_detection=False,
      parallel_ba=False, initial_keyframe_capacity=8,
      initial_surfel_capacity=1 << 14)
  base.update(kw)
  return BadSlamConfig(**base)


def _samples(tag):
  s = Timing.stats().get(tag)
  return [] if s is None else list(s.samples)


# --- the registry ---

def test_count_records_one_sample_of_n():
  Timing.count("things", 3)
  Timing.count("things")
  s = Timing.stats()["things"]
  assert s.counter and s.samples == [3, 1]
  assert (s.count, s.total, s.min, s.max, s.mean) == (2, 4, 1, 3, 2.0)
  assert "things [cpu]" not in Timing.stats()


@pytest.mark.parametrize("first", ["span", "counter"])
def test_a_tag_is_a_span_or_a_counter(first):
  if first == "span":
    with Timing.time("tag"):
      pass
    with pytest.raises(ValueError, match="is a span"):
      Timing.count("tag")
    Timing.add_time("tag", 0.5)   # a span takes more spans
    assert Timing.stats()["tag"].count == 2
  else:
    Timing.count("tag")
    with pytest.raises(ValueError, match="is a counter"):
      with Timing.time("tag"):
        pass
    with pytest.raises(ValueError, match="is a counter"):
      Timing.add_time("tag", 0.5)
    assert Timing.stats()["tag"].samples == [1]


def _sleep_span():
  with Timing.time("sleeping"):
    time.sleep(0.05)


def test_every_span_records_its_thread_cpu_time():
  _sleep_span()
  # The same span on another thread, while this one works: each thread's
  # CPU time is its own.
  thread = threading.Thread(target=_sleep_span)
  thread.start()
  with Timing.time("working"):
    deadline = time.thread_time() + 0.03
    while time.thread_time() < deadline:
      pass
  thread.join()
  Timing.add_time("added", 0.5)   # no block, so no CPU time
  stats = Timing.stats()
  assert stats["sleeping"].count == stats["sleeping [cpu]"].count == 2
  assert min(stats["sleeping"].samples) >= 0.05
  assert max(stats["sleeping [cpu]"].samples) < 0.02
  assert stats["working [cpu]"].count == stats["working"].count == 1
  assert 0.03 <= stats["working [cpu]"].samples[0] <= (
      stats["working"].samples[0] + 1e-3)
  assert "added [cpu]" not in stats


def test_export_lines_show_cpu_time_on_the_span_line_and_counters_as_counts(
    tmp_path):
  with Timing.time("BA intrinsics optimization"):
    pass
  Timing.add_time("Keyframe hand-off wait", 0.25)
  Timing.count(GN, 7)
  Timing.count(GN, 12)
  path = tmp_path / "timings.txt"
  Timing.export_file(str(path))
  text = path.read_text()
  lines = text.splitlines()
  assert lines[0] == "Timing statistics (seconds):"
  assert not any(l.strip().startswith("BA intrinsics optimization [cpu]")
                 for l in lines)
  # The reader of tests/test_torch_state_io.py.
  count = re.search(r"BA intrinsics optimization\s+count\s+(\d+)", text)
  assert count and int(count.group(1)) == 1
  span = next(l for l in lines if "BA intrinsics optimization" in l)
  assert re.search(r"mean +[\d.]+ms .* max +[\d.]+ms  cpu +[\d.]+ms$", span)
  handoff = next(l for l in lines if HANDOFF in l)
  assert "250.00ms" in handoff and "cpu" not in handoff
  assert lines.index("Counters:") < lines.index(
      next(l for l in lines if GN in l))
  counter = next(l for l in lines if GN in l)
  assert re.search(r"count +2  total +19  mean +9.50  min +7  max +12$",
                   counter), counter
  assert "ms" not in counter


# --- the profiler ---

def _profiled(block):
  from torch._C._profiler import _ExperimentalConfig
  from torch.profiler import ProfilerActivity, profile
  prof = profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True))
  prof.start()
  try:
    block()
  finally:
    prof.stop()
  return [(e.name(), e.start_thread_id(), e.start_ns(), e.end_ns(),
           e.activity_type())
          for e in prof.profiler.kineto_results.events()]


def test_spans_open_a_profiler_range_on_every_thread():
  def work(tag):
    with Timing.time(tag):
      torch.ones(8).sum()

  def block():
    work("main thread phase")
    thread = threading.Thread(target=work, args=("other thread phase",))
    thread.start()
    thread.join()

  events = _profiled(block)
  by_name = {name: (tid, s, e, kind) for name, tid, s, e, kind in events}
  assert "main thread phase" in by_name and "other thread phase" in by_name
  assert by_name["main thread phase"][0] != by_name["other thread phase"][0]
  # A host op, not a user annotation (which the profiler would copy onto
  # the device's timeline).
  assert by_name["main thread phase"][3] == "cpu_op"
  # The op inside the span lies inside its range, on the span's clock.
  tid, s, e, _ = by_name["main thread phase"]
  assert any(name == "aten::sum" and t == tid and s <= a and b <= e
             for name, t, a, b, _ in events)
  assert Timing.stats()["main thread phase"].count == 1


def test_no_profiler_range_without_a_session(monkeypatch):
  from badslam_tpu_torch.utils import timing

  def refuse(*_):
    raise AssertionError("profiler range built with no profiler running")

  monkeypatch.setattr(timing, "_RecordFunctionFast", refuse)
  monkeypatch.setattr(torch.profiler, "record_function", refuse)
  with Timing.time("unprofiled"):
    pass
  assert Timing.stats()["unprofiled"].count == 1


# --- odometry ---

def _count_h_b(monkeypatch):
  """Counts every frame-to-frame H/b evaluation."""
  calls = [0]
  real = odometry_mod.frame_to_frame_h_b

  def counting(*args, **kwargs):
    calls[0] += 1
    return real(*args, **kwargs)

  monkeypatch.setattr(odometry_mod, "frame_to_frame_h_b", counting)
  return calls


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["host", "transfer_free"])
def test_odometry_gn_iterations_one_sample_per_tracked_frame(
    monkeypatch, pipelined):
  frames = 5
  video = synthetic.make_heightmap_video(
      synthetic.default_test_camera(W, H), _trajectory(frames))
  slam = BadSlam(_config(pipelined_frontend=pipelined), video, device="cpu")
  calls = _count_h_b(monkeypatch)
  per_frame = []
  try:
    for i in range(frames):
      before = calls[0]
      slam.process_frame(i)
      slam.end_frame()
      per_frame.append(calls[0] - before)
    # Frame 0 has no keyframe to track against.
    assert per_frame[0] == 0 and all(n > 0 for n in per_frame[1:])
    assert _samples(GN) == per_frame[1:]
    assert len(_samples("Odometry")) == frames - 1
    assert Timing.stats()[GN].counter
    assert len(_samples("[BadSlam::ProcessFrame]")) == frames
    # The loop closure's refinement tracks with the same GN loops, and
    # counts nothing here.
    before = calls[0]
    slam.track_keyframe_pair(1, 0, np.eye(4, dtype=np.float32))
    assert calls[0] > before
    assert _samples(GN) == per_frame[1:]
  finally:
    slam.stop_ba_thread_and_wait()


def test_track_frame_pairwise_counts_each_scales_launches(monkeypatch):
  """Without the system: one entry per scale, their sum the H/b calls."""
  from badslam_tpu_torch.ops.pyramid import build_pyramid
  cam = synthetic.default_test_camera(W, H)
  video = synthetic.make_heightmap_video(cam, _trajectory(2))
  slam = BadSlam(_config(), video, device="cpu")
  calls = _count_h_b(monkeypatch)
  processed = [slam.preprocess_frame(i) for i in range(2)]
  pyramids = [build_pyramid(p.depth, p.normals, p.intensity, 3)
              for p in processed]
  eye = torch.eye(4)
  for transfer_free in (False, True):
    got, before = [], calls[0]
    odometry_mod.track_frame_pairwise(
        pyramids[0], pyramids[1], cam, 40.0, eye, eye,
        use_pyramid_level_0=True, transfer_free=transfer_free,
        gn_iterations=got)
    assert len(got) == 3 and sum(got) == calls[0] - before
    assert all(1 <= n <= 30 for n in got)


# --- the loop detector ---

@pytest.mark.parametrize("parallel", [False, True],
                         ids=["sequential", "detection_thread"])
def test_loop_spans_and_query_counts(parallel):
  """config2's revisit of frame 0 (tests/test_torch_loop_closure.py):
  every keyframe queries the database, and the revisit reaches
  verification."""
  traj = _trajectory(10)
  traj.append(traj[0].copy())
  cam = synthetic.default_test_camera(W, H)
  video = synthetic.make_synthetic_video(
      cam, traj, synthetic.plane_world_normals(), texture_kind="checker")
  cfg = _config(enable_loop_detection=True,
                parallel_loop_detection=parallel)
  detector = LoopDetector(cfg, cam, recent_exclude=2, parallel=parallel)
  slam = BadSlam(cfg, video, device="cpu", loop_detector=detector)
  try:
    for i in range(10):
      slam.process_frame(i)
      slam.end_frame()
    slam.process_frame(10, force_keyframe=True)
  finally:
    slam.stop_ba_thread_and_wait()
  stats = Timing.stats()
  keyframes = slam.direct_ba.keyframe_count
  assert keyframes == 6
  for tag in LOOP_SPANS:
    assert stats[tag + " [cpu]"].count == stats[tag].count
  assert stats["Loop feature extraction"].count == keyframes
  assert stats["Loop database query"].count == keyframes
  queries = {t[len("Loop query: "):]: s.count for t, s in stats.items()
             if t.startswith("Loop query: ")}
  assert all(stats[f"Loop query: {o}"].counter for o in queries)
  assert sum(queries.values()) == keyframes
  assert queries.get("sent to verification", 0) >= 1, queries
  events = detector.events
  assert stats["Loop verification"].count == len(events) >= 1
  verified = {t: s.count for t, s in stats.items()
              if t.startswith("Loop verification: ")}
  assert sum(verified.values()) == len(events)
  for e in events:
    assert f"Loop verification: {e.reason.split(' (')[0]}" in verified
  assert ("Loop result wait" in stats) == parallel
  if parallel:
    assert stats["Loop result wait"].count == keyframes


# --- the BA thread's queue ---

def test_keyframe_handoff_wait_one_sample_per_queued_keyframe():
  frames = 7
  video = synthetic.make_heightmap_video(
      synthetic.default_test_camera(W, H), _trajectory(frames))
  slam = BadSlam(_config(parallel_ba=True,
                         max_num_ba_iterations_per_keyframe=1),
                 video, device="cpu")
  try:
    for i in range(frames):
      slam.process_frame(i)
      slam.end_frame()
  finally:
    slam.stop_ba_thread_and_wait()
  waits = _samples(HANDOFF)
  assert slam.direct_ba.keyframe_count == 4
  assert len(waits) == 4 and all(0.0 <= w < 60.0 for w in waits)
  assert not Timing.stats()[HANDOFF].counter


def test_sequential_ba_queues_no_keyframe():
  video = synthetic.make_heightmap_video(
      synthetic.default_test_camera(W, H), _trajectory(3))
  slam = BadSlam(_config(), video, device="cpu")
  for i in range(3):
    slam.process_frame(i)
    slam.end_frame()
  assert slam.direct_ba.keyframe_count == 2
  assert HANDOFF not in Timing.stats()


# --- no device read added (on a card) ---

def _sync_warnings(block) -> int:
  """The synchronizing calls ``block`` makes, by sync debug mode's
  warnings."""
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      block()
      torch.cuda.synchronize()
    finally:
      torch.cuda.set_sync_debug_mode("default")
  return sum("synchroniz" in str(w.message) for w in caught)


@contextlib.contextmanager
def _timing_patched_out():
  saved = {name: Timing.__dict__[name]
           for name in ("time", "count", "add_time")}
  Timing.time = classmethod(lambda cls, tag: contextlib.nullcontext())
  Timing.count = classmethod(lambda cls, tag, n=1: None)
  Timing.add_time = classmethod(lambda cls, tag, seconds: None)
  try:
    yield
  finally:
    for name, value in saved.items():
      setattr(Timing, name, value)


@pytest.mark.cuda
def test_spans_and_counters_add_no_device_read():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  frames = 5
  traj = _trajectory(frames)

  def run():
    video = synthetic.make_heightmap_video(
        synthetic.default_test_camera(W, H), traj)
    slam = BadSlam(_config(max_num_ba_iterations_per_keyframe=1), video,
                   device="cuda")
    for i in range(frames):
      slam.process_frame(i)
      slam.end_frame()
    slam.stop_ba_thread_and_wait()
    assert slam.direct_ba.keyframe_count == 3

  # The first run builds the kernel, warms the allocator and takes torch's
  # one synchronizing call of a first run under the debug mode.
  _sync_warnings(run)
  Timing.reset()
  with_timing = _sync_warnings(run)
  assert len(_samples(GN)) == frames - 1
  with _timing_patched_out():
    without = _sync_warnings(run)
  assert with_timing == without > 0, (with_timing, without)


@pytest.mark.cuda
def test_spans_leave_the_device_timeline_alone():
  """Under a CUDA profiler a span is a host range only: no device event
  carries its name, so the trace's device-busy union is the kernels'."""
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  from torch.autograd import DeviceType
  from torch.profiler import ProfilerActivity, profile
  x = torch.ones(1 << 20, device="cuda")
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
    with Timing.time("device phase"):
      for _ in range(4):
        x = x * 1.5
      time.sleep(0.05)   # the device idles inside the span
    torch.cuda.synchronize()
  events = list(prof.profiler.kineto_results.events())
  assert any(e.name() == "device phase" and e.device_type() == DeviceType.CPU
             for e in events)
  device = [e for e in events if e.device_type() == DeviceType.CUDA]
  assert device and not any(e.name() == "device phase" for e in device)
  busy = sum(e.end_ns() - e.start_ns() for e in device)
  assert busy < 0.01e9, busy
