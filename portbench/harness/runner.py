"""One run of a cell: set-up, the measured window, the check.

  1. Render the traffic's frames on the device from the seed (the mix's
     generator, ``traffic/<generator>.py``) and hand them to the program as
     host arrays (u16 depth, u8 RGB) in an ``RGBDVideo``.
  2. Build ``BadSlam`` from the configuration's command line, as the CLI
     builds it.
  3. Warm up: map the session before the window, the configuration's
     first ``session_frames`` frames: their keyframes, then the last
     keyframe interval's frames each (``session_indices``), so that the
     window starts from the map of a session of that length.
  4. The window: ``process_frame(i)`` then ``end_frame()``, frame after
     frame from frame ``session_frames`` on, the next handed in when the
     last returns, until ``seconds`` have passed. With ``trace`` the
     profiler covers ``PROFILE_FRAMES`` frames inside it.
  5. ``stop_ba_thread_and_wait()``; the device's peak memory.
  6. The program's state is freed, and the reference judges what the
     window produced: the frames' poses, the map, the kernel's outputs on
     frames sampled from the window.

The program's spans (``Timing``) are read over the window, less the
profiled frames; the harness adds its own spans around the loop
detector's extraction and query and around ``LoopDetector.add_keyframe``,
and keeps the kernel's outputs of the sampled frames by wrapping
``BadSlam.preprocess_frame`` of the one instance.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import random
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from portbench.harness import roofline, spec, trace
from portbench.reference import judge, scene

# The profiled sub-window: it starts at the window's PROFILE_START_FRAME-th
# frame and covers PROFILE_FRAMES frames (two keyframe intervals).
PROFILE_START_FRAME = 10
PROFILE_FRAMES = 20
# Window frames whose preprocess outputs the check compares.
KERNEL_SAMPLES = 4


@dataclasses.dataclass
class Record:
  """What a run measured, for the metric readers."""
  device: str
  setup_s: float
  window_s: float
  frame_s: List[float]
  timing: Dict[str, List[float]]     # window samples, profiled ones left out
  ba_iterations: int
  parallel_ba: bool
  loop_s: Dict[str, List[float]]     # "detect" and "add" spans, seconds
  trace: Optional[trace.TraceSummary] = None
  preprocess_bound_s: Optional[float] = None   # mean over profiled frames
  profiled: range = range(0)         # positions in frame_s under the profiler


def camera_of(config: dict) -> scene.Camera:
  """The configuration's camera; the file gives cx, cy in the center
  convention of a TUM calibration.txt, the port stores corner ones."""
  c = config["camera"]
  return scene.Camera(int(c["width"]), int(c["height"]), float(c["fx"]),
                      float(c["fy"]), float(c["cx"]) + 0.5,
                      float(c["cy"]) + 0.5)


def session_indices(frames: int, keyframe_interval: int) -> List[int]:
  """The frames set-up processes of a session of ``frames`` frames: every
  keyframe (each ``keyframe_interval``-th frame), then the last interval's
  frames each, so that the window starts from a frame-to-frame motion
  model. Set-up makes the session's keyframes, their surfels and its BA
  calls, without the odometry of the frames between the keyframes."""
  tail = max(0, frames - keyframe_interval)
  return (list(range(0, tail, keyframe_interval))
          + list(range(tail, frames)))


def build_video(config: dict, traffic: dict, generator: spec.Generator,
                session: List[int], seed: int, seconds: float, device):
  """(RGBDVideo of the mix, {frame index: u16 depth} of the frames a run
  may process, ground-truth poses). Only those frames are rendered."""
  from badslam_tpu_torch.geometry.camera import PinholeCamera
  from badslam_tpu_torch.io.dataset import Frame, RGBDVideo
  cam = camera_of(config)
  world = generator.world(traffic, seed)
  poses = generator.poses(traffic, seed)
  scaling = float(config["camera"]["depth_scaling"])
  warm = int(config["session_frames"])
  # A cyclic mix replays its frames for as long as any window could run.
  count = (warm + int(seconds * 200) + 1 if traffic["cyclic"]
           else len(poses))
  used = session + list(range(warm, count))
  index = {i: scene.pose_index(poses, traffic, i) for i in used}
  rendered = sorted(set(index.values()))
  depth, rgb = generator.frames(cam, poses[rendered], world, scaling, device)
  at = {k: j for j, k in enumerate(rendered)}
  fps = float(config["camera"]["fps"])
  frames = []
  for i in range(count):
    f = Frame(rgb_path="", depth_path="", rgb_timestamp=i / fps,
              depth_timestamp=i / fps)
    if i in index:
      f._rgb, f._depth = rgb[at[index[i]]], depth[at[index[i]]]
    frames.append(f)
  pinhole = PinholeCamera(cam.width, cam.height, cam.fx, cam.fy, cam.cx,
                          cam.cy)
  video = RGBDVideo(frames=frames, color_camera=pinhole,
                    depth_camera=pinhole, raw_to_float_depth=1.0 / scaling)
  return video, {i: depth[at[k]] for i, k in index.items()}, poses


def badslam_config(config: dict):
  """The configuration's command line, parsed as the CLI parses it."""
  from badslam_tpu_torch import main as port_main
  args = port_main.build_parser().parse_args(["in-memory"] + config["cli"])
  return port_main.config_from_args(args)


@contextlib.contextmanager
def loop_detector_spans(record: Dict[str, List[tuple]]):
  """(start, end) host seconds of the loop detector's work per keyframe:
  "detect", from the start of its feature extraction to the end of its
  database query, on whichever thread runs them (the detection thread
  under parallel detection), and "add", each ``LoopDetector.add_keyframe``
  call (the hand-over of the detection's result, the verification and the
  closing), on the thread that registers the keyframe
  (``chip_smoke.detector_timing``'s wrappers)."""
  from badslam_tpu_torch.loop import detector as det_mod
  cls = det_mod.LoopDetector
  extract, detect, add = cls._extract, cls._detect, cls.add_keyframe
  started = {}

  def timed_extract(self, *args):
    started[threading.get_ident()] = time.perf_counter()
    return extract(self, *args)

  def timed_detect(self, entry):
    try:
      return detect(self, entry)
    finally:
      t0 = started.pop(threading.get_ident(), None)
      if t0 is not None:
        record["detect"].append((t0, time.perf_counter()))

  def timed_add(self, *args, **kwargs):
    t0 = time.perf_counter()
    try:
      return add(self, *args, **kwargs)
    finally:
      record["add"].append((t0, time.perf_counter()))

  cls._extract, cls._detect, cls.add_keyframe = (timed_extract, timed_detect,
                                                  timed_add)
  try:
    yield
  finally:
    cls._extract, cls._detect, cls.add_keyframe = extract, detect, add


class KernelSampler:
  """Keeps the preprocess outputs of ``k`` window frames, a uniform sample
  drawn from the seed (reservoir sampling), as the device tensors the
  program's kernel returned."""

  def __init__(self, slam, k: int, seed: int):
    self._slam = slam
    self._real = slam.preprocess_frame
    self._rng = random.Random(seed)
    self._k = k
    self._seen = 0
    self.active = False
    self.samples: List[tuple] = []   # (frame index, outputs)
    slam.preprocess_frame = self._wrapped

  def _wrapped(self, frame_index, *args, **kwargs):
    processed = self._real(frame_index, *args, **kwargs)
    if self.active:
      outputs = (processed.depth, processed.normals, processed.radius_sq)
      if len(self.samples) < self._k:
        self.samples.append((frame_index, outputs))
      else:
        j = self._rng.randrange(self._seen + 1)
        if j < self._k:
          self.samples[j] = (frame_index, outputs)
      self._seen += 1
    return processed

  def close(self):
    del self._slam.preprocess_frame


def detector_counts(detector) -> Optional[tuple]:
  """(loops closed, candidates rejected) so far, None without detection."""
  if detector is None:
    return None
  return detector.num_loops_closed, detector.num_loops_ignored


def _timing_counts(Timing) -> Dict[str, int]:
  return {tag: s.count for tag, s in Timing.stats().items()}


@dataclasses.dataclass
class Outcome:
  record: Record
  readings: Dict[str, float]
  exhausted: bool
  attempted: int
  memory_peak_bytes: int
  notes: Dict[str, float]   # printed, not compared


def run(cell: spec.Cell, seed: int, seconds: float, trace_on: bool, device,
        t_process_start: float, control: Optional[str] = None,
        fault: Optional[Callable] = None) -> Outcome:
  """One run of ``cell``. ``control`` "tf32" runs the program with TF32
  products (the precision below the configuration's); ``fault(slam)``
  breaks the program under test before the session is mapped (tests
  only)."""
  import torch
  cuda = device.type == "cuda"
  slam_config = badslam_config(cell.config)
  session = session_indices(int(cell.config["session_frames"]),
                            slam_config.keyframe_interval)
  video, depth_frames, poses = build_video(cell.config, cell.traffic,
                                           cell.generator, session, seed,
                                           seconds, device)
  if cuda:
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
  if control not in (None, "tf32"):
    raise ValueError(f"unknown control {control!r}")
  with tf32(control == "tf32"):
    return _run(cell, slam_config, session, seed, seconds, trace_on, device,
                t_process_start, fault, video, depth_frames, poses)


@contextlib.contextmanager
def tf32(on: bool):
  """TF32 products for cuBLAS and cuDNN while the block runs (the port pins
  them off when imported), then the settings as they were."""
  import torch
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  if on:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _run(cell, slam_config, session, seed, seconds, trace_on, device,
         t_process_start, fault, video, depth_frames, poses) -> Outcome:
  import torch
  from badslam_tpu_torch.slam.system import BadSlam
  from badslam_tpu_torch.utils.timing import Timing

  config, traffic = cell.config, cell.traffic
  cuda = device.type == "cuda"

  def is_keyframe(i: int) -> bool:
    return (i - slam_config.start_frame) % slam_config.keyframe_interval == 0

  loop_spans: Dict[str, List[tuple]] = {"detect": [], "add": []}
  with loop_detector_spans(loop_spans):
    slam = BadSlam(slam_config, video, device=device)
    sampler = KernelSampler(slam, KERNEL_SAMPLES, seed)
    parallel_ba = slam._ba_thread is not None
    if fault is not None:
      fault(slam)
    try:
      for i in session:
        slam.process_frame(i)
        slam.end_frame()
      keyframes_at_start = sum(map(is_keyframe, session))
      warm = int(config["session_frames"])

      # The window.
      prof_first = warm + PROFILE_START_FRAME
      prof_last = prof_first + PROFILE_FRAMES
      profiler, marks = None, {}
      frame_s: List[float] = []
      exhausted = False
      i = warm
      Timing.reset()
      loops_before = detector_counts(slam.loop_detector)
      sampler.active = True
      t_window = time.perf_counter()
      deadline = t_window + seconds
      t_end = t_window
      while True:
        if i >= len(video.frames):
          exhausted = True
          break
        if trace_on and i == prof_first:
          marks["start"] = (_timing_counts(Timing), time.perf_counter())
          profiler = trace.Profiler(device)
        t0 = time.perf_counter()
        slam.process_frame(i)
        slam.end_frame()
        t_end = time.perf_counter()
        frame_s.append(t_end - t0)
        i += 1
        if profiler is not None and i == prof_last:
          profiler.stop()
          marks["stop"] = (_timing_counts(Timing), time.perf_counter())
        if t_end >= deadline:
          break
      window_s = t_end - t_window
      sampler.active = False
      stats = {tag: list(s.samples) for tag, s in Timing.stats().items()}
      ba_iterations = len(stats.get("BA thread iteration", []))
      if profiler is not None and "stop" not in marks:
        profiler.stop()
        marks["stop"] = (_timing_counts(Timing), time.perf_counter())
      last_window_frame = i
    finally:
      # A failing run must not leave the BA or detection thread behind.
      slam.stop_ba_thread_and_wait()
    loops_after = detector_counts(slam.loop_detector)
    if cuda:
      torch.cuda.synchronize()
  memory_peak = torch.cuda.max_memory_allocated() if cuda else 0

  # What the window produced, then the program's state goes.
  window = range(warm, last_window_frame)
  est = np.stack([video.frames[j].global_T_frame for j in window]) \
      if len(window) else np.zeros((0, 4, 4))
  surfels, _, _ = slam.direct_ba.export_point_cloud(refresh_colors=False)
  kernel_samples = [(depth_frames[j], outputs)
                    for j, outputs in sampler.samples]
  sampler.close()
  del slam
  gc.collect()
  if cuda:
    torch.cuda.empty_cache()

  # Leave out the profiled frames' spans, and for each tag the first span
  # that ended after the profiler stopped: it may have begun under it.
  if "start" in marks:
    (c0, p0), (c1, p1) = marks["start"], marks["stop"]
    stats = {tag: v[:c0.get(tag, 0)] + v[c1.get(tag, 0) + 1:]
             for tag, v in stats.items()}
    loop_spans = {k: [s for s in v if s[1] < p0 or s[0] > p1]
                  for k, v in loop_spans.items()}
  loop_s = {k: [b - a for a, b in v if a >= t_window and b <= t_end]
            for k, v in loop_spans.items()}

  summary, bound_s, profiled = None, None, range(0)
  if profiler is not None:
    profiled = range(prof_first, min(last_window_frame, prof_last))
    summary = profiler.summary(len(profiled))
    if cuda and summary is not None:
      bound_s = preprocess_bound_mean(config, depth_frames, profiled, device)

  # The reference.
  gt = np.stack([poses[scene.pose_index(poses, traffic, j)]
                 for j in window]) if len(window) else np.zeros((0, 4, 4))
  readings, world_T_est = judge.trajectory_readings(est, gt)
  readings.update(judge.map_readings(
      surfels, world_T_est, cell.generator.world(traffic, seed),
      cell.generator.surface_z))
  # The keyframes the map must hold: the session's up to two keyframe
  # intervals before the window's end (the BA thread may not have made the
  # newest keyframes' surfels yet).
  settled = last_window_frame - 2 * slam_config.keyframe_interval
  views = [(poses[scene.pose_index(poses, traffic, j)], depth_frames[j])
           for j in sorted(depth_frames) if j < settled and is_keyframe(j)]
  readings.update(judge.map_missing_share(
      surfels, world_T_est, views, camera_of(config),
      float(config["camera"]["depth_scaling"]),
      int(config["preprocess"]["sparse_surfel_cell_size"])))
  readings.update(judge.kernel_readings(
      kernel_samples, camera_of(config), config, device))

  record = Record(
      device=device.type,
      setup_s=t_window - t_process_start, window_s=window_s,
      frame_s=frame_s,
      timing=stats, ba_iterations=ba_iterations, parallel_ba=parallel_ba,
      loop_s=loop_s, trace=summary, preprocess_bound_s=bound_s,
      profiled=range(profiled.start - warm, profiled.stop - warm))
  notes = {"map_keyframes_at_window_start": keyframes_at_start,
           "map_surfels_at_end": int(len(surfels))}
  if loops_before is not None:
    notes["loops_closed_in_window"] = loops_after[0] - loops_before[0]
    notes["loops_ignored_in_window"] = loops_after[1] - loops_before[1]
  return Outcome(record, readings, exhausted, len(frame_s), memory_peak,
                 notes)


def preprocess_bound_mean(config: dict, depth_frames, frames, device
                          ) -> float:
  """Mean over ``frames`` of the kernel's least time on each frame's own
  depth (``roofline.preprocess_bound``)."""
  import torch
  p = config["preprocess"]
  scale = 1.0 / float(config["camera"]["depth_scaling"])
  total = 0.0
  for j in frames:
    counts = depth_frames[j]
    raw = torch.from_numpy(counts.astype(np.float32)).to(device) * scale
    total += roofline.preprocess_bound(
        raw, sigma_xy=p["bilateral_filter_sigma_xy"],
        radius_factor=p["bilateral_filter_radius_factor"],
        max_depth=p["max_depth"])["bound_s"]
  return total / max(len(frames), 1)
