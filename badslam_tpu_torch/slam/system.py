"""BadSlam front-end: the per-frame SLAM pipeline with sequential BA.

Port of the sequential path of ``badslam_tpu/slam/system.py``
(bad_slam.cc of the original BAD SLAM):
  ProcessFrame         preprocess, odometry against the base keyframe,
                       keyframe creation every keyframe_interval frames,
                       then the planned bundle-adjustment iterations
  PreprocessFrame      u16 depth to metres and RGB to intensity on the
                       device, optionally the median filter and the
                       pyramid-level downscales, then the fused depth
                       preprocess (hand-written CUDA kernel on a GPU, its
                       plain chain on the CPU)
  PredictFramePose     two constant-velocity hypotheses, orthonormalized
  RunOdometry          calibrate, build pyramids, coarse-to-fine pairwise
                       tracking, tracking-failure gate
  CreateKeyframe       the memory watchdog, register the keyframe in the
                       map (the first one creates surfels unfiltered) or
                       queue it for the BA thread, loop detection and
                       closing, rebase the motion-model history, plan BA
                       iterations
  RunBundleAdjustment  BA over the map (alternating, or joint by PCG with
                       ``use_pcg``), with self-calibration on the schedule
                       of ``optimize_intrinsics``, then the trajectory
                       deformation of the frames between keyframes

Parallel BA (``parallel_ba``, the default; BAThreadMain, bad_slam.cc:
1160-1313): keyframes go into a queue with their pose relative to the
previous keyframe, and a BA thread registers them (fixing the absolute pose
up from the relative one, as the previous keyframe may have moved), runs the
loop closing and one BA iteration per request over all keyframes, then the
trajectory deformation. The BA thread is the map's only writer; the
watchdog's merge is routed to it. Shared host state is guarded by
``_ba_lock``. A BA thread that raises stops, and the main thread raises its
error at its next keyframe or at ``stop_ba_thread_and_wait``.

On a GPU the two threads run on two CUDA streams, as the reference does
(bad_slam.cc:68-74): the frame's work on a high-priority stream, BA on a
low-priority one. Every hand-off from the main thread (a keyframe, an
iteration request, a merge request) records an event on the main stream
that the BA stream waits on before it starts the requested work, and a
queued keyframe's tensors are marked as used by the BA stream
(``record_stream``) so that the caching allocator cannot hand their memory
out while BA still reads them. Between frames the main thread puts no work
on the caller's stream; ``quiesce`` and ``stop_ba_thread_and_wait`` make
the caller's stream wait for both. The map is allocated on the BA stream.

The calibration: sequential BA writes the shared ``DepthCalibration`` in
place, and the next frame's preprocessing and odometry read the new values
from the same tensors. Under parallel BA the front-end reads a snapshot
instead: after an iteration with self-calibration the BA thread publishes a
clone of its calibration with an event, and the main thread takes the
newest publication once, at the start of a frame, and waits for its event.
Both readers of one frame (the preprocess kernel and odometry) thus see the
same values, whatever the BA thread writes meanwhile.

The mesh (``mesh=``, JAX :154-165): the back-end runs with its surfel
store sharded over the mesh (``DirectBA`` mesh mode); everything else,
preprocessing, odometry, the loop closure and the pipelined state machine,
computes on the mesh's first device, which is ``device``. JAX serializes the
SPMD programs of its two host threads behind ``_spmd_dispatch_lock``,
because XLA's collective rendezvous deadlocks when two threads submit
programs in different per-device orders; the port's collectives meet at
barriers made per ``shard_map`` call, between the workers of that call
only, so two threads' calls cannot interleave into that hazard and the
port has no such lock.

Loop detection (``loop/detector.py``) runs its feature extraction and
database query on a thread of its own unless ``parallel_loop_detection`` is
off; the closing runs inside the keyframe's registration: on the main
thread under sequential BA, on the BA thread under parallel BA.

The pipelined front-end (``pipelined_frontend``; ``slam/pipelined.py``)
keeps the motion model, the failure gate, the trajectory, BA and the loop
closure on the device, and the host never waits for the card from the first
``process_frame`` to the last: BA runs transfer-free, one iteration per
frame while budget remains, inline or (``pipelined_concurrent_ba``) on a
thread of its own; loop detection runs inline, from the dataset's host
images, and a closure is one device program whose outcome
``finalize_pipelined`` reads, with the trajectory, after the run. Under
``pipelined_concurrent_ba`` on a GPU the frame's work runs on the
high-priority stream and every map write (keyframe registration, surfel
creation, the closure, BA) on the low-priority one, in the order of a map
lock: the BA stream waits on an event of the main stream before it reads a
keyframe's images, which are marked as used by it (``record_stream``), and
the main stream never waits on the BA stream.
"""

from __future__ import annotations

import atexit
import contextlib
import threading
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.io.dataset import RGBDVideo
from badslam_tpu_torch.loop.trajectory_deformation import (
    extrapolate_and_interpolate_keyframe_pose_changes)
from badslam_tpu_torch.models import odometry as odometry_mod
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.ops import depth_model, depth_proc, image_proc
from badslam_tpu_torch.ops.fused_preprocess import fused_depth_preprocess
from badslam_tpu_torch.ops.pyramid import build_pyramid
from badslam_tpu_torch.slam import pipelined
from badslam_tpu_torch.slam.direct_ba import DirectBA
from badslam_tpu_torch.slam.pipelined import WEAK_EDGE_WEIGHT
from badslam_tpu_torch.utils import logging as log
from badslam_tpu_torch.utils.timing import Timing
from badslam_tpu_torch.utils.transfer import to_device
# kApproxKeyframeSize of the memory watchdog (bad_slam.cc:958-968).
APPROX_KEYFRAME_BYTES = 4 * 1024 * 1024
# How long stop_ba_thread_and_wait waits for the BA thread to finish the
# iteration it is in once asked to quit.
BA_THREAD_JOIN_SECONDS = 600.0


class ProcessedFrame(NamedTuple):
  """Output of PreprocessFrame: everything a keyframe needs (on the
  device)."""
  depth: torch.Tensor      # (H, W) filtered raw metric depth, 0 = invalid
  raw_depth: torch.Tensor  # (H, W) unfiltered raw metric depth (odometry)
  normals: torch.Tensor    # (H, W, 2)
  radius_sq: torch.Tensor  # (H, W)
  intensity: torch.Tensor  # (H, W) in [0, 1]
  rgb: torch.Tensor        # (H, W, 3) uint8


class NoCudaDeviceError(RuntimeError):
  """The run was to compute on the CUDA device and none is visible."""


class BAThreadError(RuntimeError):
  """The parallel BA thread raised; the original error is the cause."""


def check_supported(config: BadSlamConfig, device: torch.device) -> None:
  """Raise NotImplementedError for a configuration outside the port."""
  if device.type == "cuda" and not config.use_pallas_preprocess:
    raise NotImplementedError(
        "--no_pallas_preprocess on a CUDA device: there the plain "
        "preprocess chain is only the fused kernel's test reference")


class BadSlam:
  """The system orchestrator (class BadSlam, bad_slam.h). It computes on
  ``device``: the CUDA device when none is named, the CPU only when the
  caller asks for it, the mesh's first device under a ``mesh``
  (``parallel/spmd.Mesh``), over which the back-end is sharded.
  ``loop_detector`` replaces the one that ``config.enable_loop_detection``
  would build."""

  def __init__(self, config: BadSlamConfig, rgbd_video: RGBDVideo,
               device=None, loop_detector=None, mesh=None):
    if mesh is not None:
      if device is not None and torch.device(device).type != \
          mesh.first_device.type:
        raise ValueError(f"device {device} and a mesh over "
                         f"{mesh.first_device}")
      device = mesh.first_device
    self.device = torch.device("cuda" if device is None else device)
    if self.device.type == "cuda" and not torch.cuda.is_available():
      raise NoCudaDeviceError(
          "no CUDA device is visible (torch.cuda.is_available() is False); "
          "BadSlam runs on the GPU unless the caller passes device=\"cpu\" "
          "(--device cpu)")
    check_supported(config, self.device)
    self.config = config
    self.rgbd_video = rgbd_video
    # The pipelined front-end (slam/pipelined.py) implies its own BA
    # schedule: inline, or on its thread with pipelined_concurrent_ba.
    self._pipelined = bool(config.pipelined_frontend)
    self._pl_concurrent_ba = bool(self._pipelined
                                  and config.pipelined_concurrent_ba
                                  and config.estimate_poses)
    if self._pipelined and config.parallel_ba and not self._pl_concurrent_ba:
      log.info("pipelined_frontend: forcing sequential BA "
               "(--pipelined_concurrent_ba moves BA off the frame path)")
    # The parallel BA thread (bad_slam.cc:1160-1313) needs estimated poses:
    # with --no_pose_estimation there is no BA at all.
    self._parallel = bool(config.parallel_ba and config.estimate_poses
                          and not self._pipelined)
    # The two CUDA streams of the parallel modes (bad_slam.cc:68-74): the
    # frame's work at high priority, BA at low priority. Elsewhere the
    # caller's stream does everything.
    self._main_stream = self._ba_stream = None
    if ((self._parallel or self._pl_concurrent_ba)
        and self.device.type == "cuda"):
      self._main_stream = torch.cuda.Stream(self.device, priority=-1)
      self._ba_stream = torch.cuda.Stream(self.device, priority=0)
    # Pyramid-level input scaling (main.cc:540-552): cameras and images are
    # downscaled by 2^level before anything else sees them.
    depth_cam = rgbd_video.depth_camera.scaled(
        0.5 ** config.pyramid_level_for_depth)
    color_cam = rgbd_video.color_camera.scaled(
        0.5 ** config.pyramid_level_for_color)
    with self._on_stream(self._ba_stream):
      # The back-end's depth calibration. Sequential BA shares this very
      # object with preprocessing and odometry; parallel BA hands the
      # front-end snapshots of it (_frame_calibration).
      self.calibration = DepthCalibration.initial(
          depth_cam, config.sparse_surfel_cell_size,
          config.depth_deformation_a, config.baseline_fx, self.device)
      self.direct_ba = DirectBA(
          config, depth_cam, color_cam, device=self.device,
          calibration=self.calibration, mesh=mesh)
    if self._ba_stream is not None:
      torch.cuda.current_stream(self.device).wait_stream(self._ba_stream)
    if loop_detector is None and config.enable_loop_detection:
      from badslam_tpu_torch.loop.detector import LoopDetector
      # The pipelined front-end detects inline: the detection thread pairs
      # 1:1 with queue_for_detection, which its keyframe path does not use
      # (its closures verify on the device).
      loop_detector = LoopDetector(
          config, color_cam,
          parallel=config.parallel_loop_detection and not self._pipelined)
    self.loop_detector = loop_detector
    # Guards the map's poses, the trajectory and the hand-off queues below
    # (ba_thread_mutex_): the BA thread, the loop closure and the main
    # thread's pose writes take it.
    self._ba_lock = threading.Lock()
    self._ba_condition = threading.Condition(self._ba_lock)

    # Base keyframe: its slot in the keyframe store, pose, images, and the
    # motion-model history (<= 3 relative poses, base_kf_T_frame and its
    # inverse). The images let odometry track against a keyframe that the
    # BA thread has not registered yet (bad_slam.cc:997-1000).
    self.base_kf_index: Optional[int] = None
    self.base_kf_images: Optional[ProcessedFrame] = None
    self.base_kf_global_T_frame = np.eye(4, dtype=np.float32)
    self.base_kf_tr_frame: List[np.ndarray] = []
    self.frame_tr_base_kf: List[np.ndarray] = []

    self.num_planned_ba_iterations = 0
    self.ba_counter = 0
    self.last_frame_index = -1
    # frame_index of each keyframe slot (for the trajectory deformation).
    self.keyframe_frame_indices: List[int] = []
    # Per keyframe slot, the pose-graph weight of the odometry edge from the
    # previous keyframe into it: WEAK_EDGE_WEIGHT when the tracking-failure
    # gate fired since the previous keyframe, else 1.
    self.keyframe_edge_weight: dict = {}
    self._tracking_failed_since_kf = False
    # Keyframes deleted by the memory watchdog's merges over the run.
    self.num_keyframes_merged = 0
    self._dataset_fps: Optional[float] = None
    self._loop_detection_counter = -1
    # Real-time pacing state (EndFrame, bad_slam.cc:449-479).
    self._actual_frame_start_time = 0.0
    self._target_frame_end_time = 0.0
    self._frame_timer_start: Optional[float] = None
    # Seconds per stage of the last prewarm() (None before one).
    self.last_prewarm_breakdown: Optional[dict] = None

    # Parallel-BA state, guarded by _ba_lock: the keyframe queue (processed
    # frame, frame index, pose relative to the previous keyframe, detection
    # images, edge weight, host time queued), the iteration requests, the
    # watchdog's merge request, and the newest main-stream event the BA
    # stream must wait on.
    self._queued_keyframes: List[tuple] = []
    self._parallel_iteration_queue: List[dict] = []
    self._merge_requested = False
    self._quit_requested = False
    self._ba_busy = False   # the BA thread is working on a popped request
    self._handoff_event = None
    self._ba_thread_error: Optional[BaseException] = None   # not raised yet
    self._ba_thread_failed = False
    # The front-end's calibration under parallel BA: the snapshot it reads,
    # and the BA thread's newest publication (snapshot, event) not yet taken.
    self._front_calibration: Optional[DepthCalibration] = None
    self._published_calibration = None
    self._ba_thread: Optional[threading.Thread] = None
    if self._parallel:
      self._ba_thread = threading.Thread(
          target=self._ba_thread_main, name="ba_thread", daemon=True)
      self._ba_thread.start()
      # Stop the thread before the interpreter tears down under it.
      atexit.register(self.stop_ba_thread_and_wait)

    # The pipelined front-end's device state, and under
    # pipelined_concurrent_ba its BA thread: the thread runs queued BA
    # iterations, each under _pl_map_lock, which the main thread also takes
    # for its map writes. Loop-closure repair iterations still owed to the
    # thread's queue (_pl_ba_repair_debt) pass its backlog cap.
    self.pipelined_state: Optional[pipelined.PipelinedState] = None
    self._pl_map_lock = None
    self._pl_ba_queue: List[dict] = []
    self._pl_ba_busy = False
    self._pl_ba_repair_debt = 0
    self._pl_ba_sched_count = 0
    self.pl_ba_dropped = 0   # iterations the backlog cap dropped
    self._pl_ba_thread: Optional[threading.Thread] = None
    if self._pipelined:
      self.pipelined_state = pipelined.PipelinedState(
          len(rgbd_video.frames), self.device)
    if self._pl_concurrent_ba:
      self._pl_map_lock = threading.Lock()
      self._pl_ba_thread = threading.Thread(
          target=self._pl_ba_thread_main, name="pl_ba_thread", daemon=True)
      self._pl_ba_thread.start()
      atexit.register(self.stop_ba_thread_and_wait)

  @staticmethod
  def _on_stream(stream):
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())

  # --- per-frame pipeline ---

  def process_frame(self, frame_index: int, force_keyframe: bool = False):
    """ProcessFrame (bad_slam.cc:170-279). Under parallel BA on a GPU the
    frame runs on the high-priority stream, ordered after the caller's
    stream's earlier work and before its later work."""
    with Timing.time("[BadSlam::ProcessFrame]"):
      if self._main_stream is None:
        return self._process_frame(frame_index, force_keyframe)
      caller = torch.cuda.current_stream(self.device)
      self._main_stream.wait_stream(caller)
      with torch.cuda.stream(self._main_stream):
        self._process_frame(frame_index, force_keyframe)
      caller.wait_stream(self._main_stream)

  def _process_frame(self, frame_index: int, force_keyframe: bool):
    if self._pipelined:
      return self._process_frame_pipelined(frame_index, force_keyframe)
    cfg = self.config
    self._frame_timer_start = time.perf_counter()
    if cfg.target_frame_rate > 0:
      self._target_frame_end_time += 1.0 / cfg.target_frame_rate

    calibration = self._frame_calibration()
    with Timing.time("Preprocessing"):
      processed = self.preprocess_frame(frame_index, calibration)

    if cfg.estimate_poses and self.base_kf_images is not None:
      with Timing.time("Odometry"):
        self.run_odometry(frame_index, processed, calibration)
    else:
      # No odometry ran (the first frame, or mapping only): the frame still
      # counts as processed for the export and the deformation bounds.
      with self._ba_lock:
        self.last_frame_index = max(self.last_frame_index, frame_index)

    create_keyframe = (
        force_keyframe
        or (frame_index - cfg.start_frame) % cfg.keyframe_interval == 0)
    if create_keyframe:
      with Timing.time("Keyframe creation"):
        self.create_keyframe(frame_index, processed)

    if self.num_planned_ba_iterations > 0:
      # Real-time budget: sequential BA only starts with frame time left
      # (bad_slam.cc:213-219); the BA thread has no frame budget.
      if not self._parallel and cfg.target_frame_rate > 0:
        elapsed = time.perf_counter() - self._frame_timer_start
        if (self._actual_frame_start_time + elapsed
            >= self._target_frame_end_time):
          return
      self.ba_counter += 1
      # Self-calibration starts with the tenth keyframe, runs in every BA
      # call up to the twentieth and at an interval after (bad_slam.cc:
      # 226-236); depth only with geometric residuals, color only with
      # photometric ones. Queued keyframes count.
      with self._ba_lock:
        k = self.direct_ba.keyframe_count + len(self._queued_keyframes)
      optimize_intrinsics = (
          cfg.optimize_intrinsics and k >= 10 and
          (k <= 20
           or self.ba_counter % cfg.intrinsics_optimization_interval == 0))
      optimize_depth = optimize_intrinsics and cfg.use_geometric_residuals
      optimize_color = optimize_intrinsics and cfg.use_photometric_residuals
      if self._parallel:
        self.start_parallel_iterations(self.num_planned_ba_iterations,
                                       optimize_depth, optimize_color)
        self.num_planned_ba_iterations = 0
        return
      deadline = None
      if cfg.target_frame_rate > 0:
        # The rest of the frame's time as an absolute deadline
        # (bad_slam.cc:269).
        deadline = (self._frame_timer_start
                    + (self._target_frame_end_time
                       - self._actual_frame_start_time))
      iterations_done, converged = self.run_bundle_adjustment(
          optimize_depth, optimize_color, self.num_planned_ba_iterations,
          deadline=deadline,
          increase_ba_iteration_count=(cfg.target_frame_rate == 0))
      if converged:
        self.num_planned_ba_iterations = 0
      else:
        self.num_planned_ba_iterations = max(
            0, self.num_planned_ba_iterations - iterations_done)

  def _frame_calibration(self) -> DepthCalibration:
    """The calibration this frame's preprocessing and odometry read: the
    shared object under sequential BA; under parallel BA the newest
    snapshot the BA thread published, taken here once per frame, with the
    main stream made to wait for the snapshot's event."""
    if not (self._parallel or self._pl_concurrent_ba):
      return self.calibration
    with self._ba_lock:
      published, self._published_calibration = (
          self._published_calibration, None)
    if published is not None:
      snapshot, event = published
      if event is not None:
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in snapshot.buffers():
          t.record_stream(stream)
      self._front_calibration = snapshot
    elif self._front_calibration is None:
      # The first frame: nothing runs on the BA thread yet (a loaded state
      # or calibration is already in place).
      self._front_calibration = self.calibration.clone()
    return self._front_calibration

  def end_frame(self):
    """EndFrame: pace playback to fps_restriction; in real-time mode
    (target_frame_rate > 0) allow catching up when behind."""
    if self._frame_timer_start is None:
      return
    actual_frame_time = time.perf_counter() - self._frame_timer_start
    cfg = self.config
    if cfg.fps_restriction > 0:
      min_frame_time = 1.0 / cfg.fps_restriction
      if cfg.target_frame_rate > 0:
        min_frame_time = min(
            min_frame_time,
            self._target_frame_end_time - self._actual_frame_start_time)
      if actual_frame_time < min_frame_time:
        time.sleep(min_frame_time - actual_frame_time)
        self._actual_frame_start_time += min_frame_time
      else:
        self._actual_frame_start_time += actual_frame_time
    else:
      self._actual_frame_start_time += actual_frame_time
      if self._actual_frame_start_time < self._target_frame_end_time:
        self._actual_frame_start_time = self._target_frame_end_time

  # --- prewarm (--prewarm; JAX :396-643) ---

  def prewarm(self, num_keyframes: int = 2,
              max_ba_keyframes: Optional[int] = None,
              compile_workers: Optional[int] = None) -> None:
    """Pay the live loop's first-use costs before the first real frame: on
    a live camera a spike in the middle of the run drops frames, one at
    startup does not (the reference loads its kernel-autotuning database
    before the frame loop, main.cc:437-447). JAX compiles its programs
    here. The port compiles nothing per shape, but its frame loop still
    pays on first use: the kernel library's build and load
    (``kernels/build.py``), the cuBLAS and cuSOLVER handles, CUDA's lazy
    loading of each kernel module at its first launch, and the caching
    allocator's growth.

    Pushes (num_keyframes - 1) * keyframe_interval + 3 synthetic frames of
    the dataset's depth camera (``utils/synthetic.make_heightmap_video``
    along ``utils/tum_synth.straight_trajectory``, the constant twist of
    the odometry benchmark: JAX's pure 4 mm x steps over the heightmap do
    not meet the tracking's convergence test and run several times the
    live frames' Gauss-Newton iterations) through a THROWAWAY BadSlam of
    this configuration, with loop detection,
    the parallel BA thread, pacing and the start frame off, on the same
    device and mesh (pipelined: with a trajectory buffer of the dataset's
    frame count; ``pipelined_concurrent_ba`` still runs its BA thread).

    max_ba_keyframes: then add keyframes to the throwaway map one at a time
    up to this count, and run one transfer-free BA iteration over all of
    them at each keyframe capacity the map passes through and at the first
    count with self-calibration (``optimize_intrinsics`` from the tenth
    keyframe on), with surfel updates only where the capacity grew; each
    on a clone (``DirectBA.clone_for_prewarm``), so the throwaway surfel
    store stays at its initial capacity. In pipelined mode with loop
    detection the device closure runs too, at each capacity. An empty live
    keyframe store is pre-sized to hold this many keyframes, so the live
    run never doubles it (7.1 MB a slot at 640x480).

    compile_workers: JAX's thread pool for concurrent compiles. The port
    has no compile service: the tasks run in order on this thread, and the
    argument is accepted for the signature and unused.

    The live map, trajectory and calibration are left as they were: the
    throwaway system has its own calibration and draws from no generator
    of this one. The warm frames' ``Timing`` spans are kept apart from the
    run's. ``last_prewarm_breakdown`` maps each stage to its seconds; where
    a kernel library was loaded inside the prewarm,
    ``kernel_load_<name>`` holds the load's seconds and
    ``kernel_nvcc_<name>`` the build's (0.0: it was built already), for
    ``fused_preprocess`` and ``pose_h_b``. A build or load that fails
    fails the prewarm.
    """
    import dataclasses
    from badslam_tpu_torch.utils import synthetic, tum_synth

    video = self.rgbd_video
    if (video.depth_camera.width, video.depth_camera.height) != (
        video.color_camera.width, video.color_camera.height):
      # The warm-data generator renders one size for both streams.
      log.warning("prewarm: depth/color camera sizes differ; skipping")
      return
    breakdown = {}

    @contextlib.contextmanager
    def stage(name):
      t0 = time.perf_counter()
      yield
      breakdown[name] = time.perf_counter() - t0

    if self.device.type == "cuda":
      from badslam_tpu_torch.kernels import build
      from badslam_tpu_torch.ops import fused_preprocess, pose_h_b
      for name, module in (("fused_preprocess", fused_preprocess),
                           ("pose_h_b", pose_h_b)):
        if name not in build.build_info:
          with stage(f"kernel_load_{name}"):
            module.load_kernel()
          breakdown[f"kernel_nvcc_{name}"] = build.build_info[name][0]

    cfg = dataclasses.replace(
        self.config, enable_loop_detection=False, parallel_ba=False,
        start_frame=0, fps_restriction=0, target_frame_rate=0)
    if max_ba_keyframes and self.direct_ba.keyframe_count == 0:
      self.direct_ba.reserve_keyframe_capacity(max_ba_keyframes)
      cfg = dataclasses.replace(
          cfg, initial_keyframe_capacity=self.direct_ba.kf.capacity)
    n = (max(1, num_keyframes) - 1) * max(1, cfg.keyframe_interval) + 3
    with stage("render_warm_frames"):
      warm_video = synthetic.make_heightmap_video(
          video.depth_camera, tum_synth.straight_trajectory(n),
          raw_to_float_depth=video.raw_to_float_depth)

    with Timing.isolated():
      with stage("build_warm_system"):
        warm = BadSlam(cfg, warm_video, device=self.device,
                       mesh=self.direct_ba.mesh)
        if warm._pipelined:
          # The live run's trajectory buffer size, which also bounds the
          # warm frames.
          warm.pipelined_state = pipelined.PipelinedState(
              video.frame_count(), self.device)
          n = min(n, video.frame_count())
      try:
        for i in range(n):
          with stage(f"warm_frame_{i}"):
            warm.process_frame(i)
      finally:
        with stage("stop_warm_threads"):
          warm.stop_ba_thread_and_wait()
      self._prewarm_closure_program(warm.direct_ba, stage)
      if max_ba_keyframes is not None:
        self._prewarm_keyframe_growth(warm, cfg, n, max_ba_keyframes, stage)
      if self.device.type == "cuda":
        with stage("device_drain"):
          torch.cuda.synchronize(self.device)
    self.last_prewarm_breakdown = breakdown
    log.info("prewarm breakdown: " + ", ".join(
        f"{k}={v!r}s" for k, v in breakdown.items()))

  def _prewarm_keyframe_growth(self, warm: "BadSlam", cfg: BadSlamConfig,
                               first_frame_index: int, max_ba_keyframes: int,
                               stage) -> None:
    """Grow ``warm``'s map one keyframe at a time up to
    ``max_ba_keyframes`` (copies of its base keyframe, 2 mm apart), with one
    BA iteration on a clone per new (capacity, self-calibration) pair: the
    port's counterpart of JAX's shape keys."""
    ba_w = warm.direct_ba
    processed = warm.base_kf_images
    pl = warm.pipelined_state

    def intrinsics(count):
      return cfg.optimize_intrinsics and count >= 10

    seen = {(ba_w.kf.capacity, intrinsics(ba_w.keyframe_count))}
    warmed_caps = {ba_w.kf.capacity}
    fi = first_frame_index
    while ba_w.keyframe_count < max_ba_keyframes:
      T = np.eye(4, dtype=np.float32)
      T[0, 3] = 2e-3 * ba_w.keyframe_count
      ba_w.add_keyframe(
          processed.depth, processed.normals, processed.radius_sq,
          processed.intensity, processed.rgb, T, fi)
      fi += 1
      count = ba_w.keyframe_count
      cap_grew = ba_w.kf.capacity not in warmed_caps
      warmed_caps.add(ba_w.kf.capacity)
      if pl is not None:
        # The edge weights follow the keyframe capacity (the growth loop
        # bypasses _create_keyframe_pipelined).
        pl.ensure_edge_capacity(ba_w.kf.capacity, warm.device)
        pipelined.record_edge_weight(pl.edge_weight, count - 1, pl.fail_acc)
      key = (ba_w.kf.capacity, intrinsics(count))
      if key in seen:
        continue
      seen.add(key)
      if cap_grew:
        if pl is not None:
          pipelined.keyframe_pose(ba_w.kf.global_T_frame, 0, pl.hist)
        self._prewarm_closure_program(ba_w, stage)
      with stage(f"ba_iteration_{count}_keyframes"):
        ba_w.clone_for_prewarm().bundle_adjustment(
            optimize_depth_intrinsics=(intrinsics(count)
                                       and cfg.use_geometric_residuals),
            optimize_color_intrinsics=(intrinsics(count)
                                       and cfg.use_photometric_residuals),
            do_surfel_updates=cfg.do_surfel_updates and cap_grew,
            optimize_poses=True, optimize_geometry=True,
            min_iterations=0, max_iterations=1,
            active_keyframe_window_start=0,
            active_keyframe_window_end=count - 1,
            increase_ba_iteration_count=False, transfer_free=True)

  def _prewarm_closure_program(self, ba_w: DirectBA, stage) -> None:
    """One run of ``loop/device_closure.verify_and_close`` on ``ba_w``'s map
    (keyframe 1 closing onto keyframe 0, no keypoints), whose first-use
    costs would otherwise fall on the run's first loop candidate (JAX
    :598-643). It reads the map and writes nothing. A no-op unless this
    system is pipelined with loop detection."""
    if not (self._pipelined and self.config.enable_loop_detection
            and ba_w.keyframe_count >= 2):
      return
    from badslam_tpu_torch.loop import device_closure
    kf, calib, dev = ba_w.kf, ba_w.calibration, ba_w.device

    def track(base, tracked, init):
      return self._track_pairwise(
          calib, kf.depth[base], kf.normals[base], kf.intensity[base],
          kf.depth[tracked], kf.normals[tracked], kf.intensity[tracked],
          init, init, transfer_free=True)[0]

    f32 = torch.float32
    e_cap = max(1, kf.capacity - 1)
    kb = device_closure.KEYPOINT_BUCKET
    with stage(f"device_closure_capacity_{kf.capacity}"):
      device_closure.verify_and_close(
          kf.global_T_frame, kf.depth, track, calib.depth_intr,
          calib.baseline_fx, 1, 0, 1, 1,
          torch.eye(4, dtype=f32, device=dev),
          torch.zeros((kb, 3), dtype=f32, device=dev),
          torch.zeros((kb,), dtype=torch.bool, device=dev),
          (1.0, 1.0, 0.0, 0.0),
          torch.zeros(e_cap, dtype=torch.int64, device=dev),
          torch.zeros(e_cap, dtype=torch.int64, device=dev),
          torch.zeros(e_cap, dtype=f32, device=dev),
          torch.ones(kf.capacity, dtype=f32, device=dev),
          device_closure.empty_loop_edges(dev))

  def preprocess_frame(self, frame_index: int,
                       calibration: Optional[DepthCalibration] = None
                       ) -> ProcessedFrame:
    """PreprocessFrame (bad_slam.cc:639-761) with ``calibration`` (the
    shared one when none is given). On the hot path the u16 counts go to
    the device and are scaled to metres there, as the reference converts on
    the device; with the median filter or a depth pyramid level the metric
    depth is filtered and downscaled first (bad_slam.cc:663-673)."""
    cfg = self.config
    video = self.rgbd_video
    frame = video.frames[frame_index]
    if calibration is None:
      calibration = self.calibration
    if (cfg.median_filter_and_densify_iterations == 0
        and cfg.pyramid_level_for_depth == 0):
      raw_depth, raw_scale = self._upload_depth(frame)
      if raw_scale != 1.0:
        raw_depth = raw_depth * raw_scale
    else:
      metric = (frame.depth_raw().astype(np.float32)
                * np.float32(video.raw_to_float_depth))
      raw_depth = torch.from_numpy(metric).to(self.device)
      if cfg.median_filter_and_densify_iterations > 0:
        raw_depth = depth_proc.median_filter_and_densify(
            raw_depth, cfg.median_filter_and_densify_iterations)
      if cfg.pyramid_level_for_depth > 0:
        raw_depth = depth_proc.downscale_depth_median_excluding_invalid(
            raw_depth, cfg.pyramid_level_for_depth)
    pinned = frame.pinned()
    if pinned is not None:
      rgb = pinned[0].to(self.device, non_blocking=True)
    else:
      rgb = torch.from_numpy(frame.rgb()).to(self.device)
    if cfg.pyramid_level_for_color > 0:
      rgb = depth_proc.downscale_rgb(rgb, cfg.pyramid_level_for_color)
    filtered, normals, radius_sq = fused_depth_preprocess(
        raw_depth, calibration,
        sigma_xy=cfg.bilateral_filter_sigma_xy,
        sigma_inv_depth=cfg.bilateral_filter_sigma_inv_depth,
        radius_factor=cfg.bilateral_filter_radius_factor,
        max_depth=cfg.max_depth)
    return ProcessedFrame(
        depth=filtered, raw_depth=raw_depth, normals=normals,
        radius_sq=radius_sq, intensity=image_proc.rgb_to_intensity(rgb),
        rgb=rgb)

  def _upload_depth(self, frame) -> Tuple[torch.Tensor, float]:
    """The frame's depth on the device as float32 raw counts and the scale
    to metres (u16 counts are exact in float32). A frame that the
    prefetcher put in page-locked memory is copied without blocking the
    host, as int16 bits widened on the device."""
    video = self.rgbd_video
    pinned = frame.pinned()
    if pinned is not None:
      bits = pinned[1].to(self.device, non_blocking=True)
      counts = (bits.to(torch.int32) & 0xFFFF).to(torch.float32)
      return counts, float(video.raw_to_float_depth)
    raw = frame.depth_raw()
    if raw.dtype == np.uint16:
      return (torch.from_numpy(raw.astype(np.float32)).to(self.device),
              float(video.raw_to_float_depth))
    raw = raw.astype(np.float32) * video.raw_to_float_depth
    return torch.from_numpy(raw).to(self.device), 1.0

  def predict_frame_pose(self) -> Tuple[np.ndarray, np.ndarray]:
    """Two constant-velocity hypotheses (bad_slam.cc:763-825), as
    base_kf_T_frame estimates."""
    hist = self.base_kf_tr_frame
    inv_hist = self.frame_tr_base_kf
    n = len(hist)
    if self.config.use_motion_model:
      est1 = (hist[n - 1] @ inv_hist[n - 2] @ hist[n - 1] if n >= 2
              else hist[n - 1])
      if n >= 3:
        prev_T_last = inv_hist[n - 3] @ hist[n - 2]
        est2 = hist[n - 2] @ prev_T_last @ prev_T_last
      else:
        est2 = est1
    else:
      est1 = est2 = hist[n - 1]

    def sane(e):
      # A non-finite or absurd prediction falls back to the last relative
      # pose; otherwise renormalize (the motion model squares relative
      # poses, doubling any rotation defect per frame).
      if not np.isfinite(e).all() or np.linalg.norm(e[:3, 3]) > 10.0:
        return (hist[n - 1] if np.isfinite(hist[n - 1]).all()
                else np.eye(4, dtype=np.float32))
      return se3_np.orthonormalize(e)
    return sane(est1), sane(est2)

  def run_odometry(self, frame_index: int, processed: ProcessedFrame,
                   calibration: Optional[DepthCalibration] = None):
    """RunOdometry (bad_slam.cc:827-951): the tracked side uses the
    unfiltered depth, the base side the keyframe's filtered depth, both
    calibrated with ``calibration`` (the shared one when none is given)."""
    cfg = self.config
    if calibration is None:
      calibration = self.calibration
    est1, est2 = self.predict_frame_pose()
    w, h = calibration.depth_size

    base = self.base_kf_images
    gn_iterations: List[int] = []
    base_T_frame, n_resid = self._track_pairwise(
        calibration, base.depth, base.normals, base.intensity,
        processed.raw_depth, processed.normals, processed.intensity, est1,
        est2, gn_iterations=gn_iterations)
    Timing.count("Odometry GN iterations", sum(gn_iterations))
    # Per-frame host reads, as in the reference: renormalize the result
    # (it feeds the motion model) and read the residual count.
    base_T_frame = se3_np.orthonormalize(base_T_frame.cpu().numpy())
    n_resid = int(n_resid)
    # Tracking-failure gate: almost no associated pixels in the last GN
    # iteration, a non-finite pose or an implausible jump means the
    # estimate never entered the association basin; hold the last accepted
    # relative pose instead of letting the motion model extrapolate it.
    min_resid = max(50, (w * h) // 100)
    prev_rel = (self.base_kf_tr_frame[-1] if self.base_kf_tr_frame
                else np.eye(4, dtype=np.float32))
    frame_speed = float(np.linalg.norm(base_T_frame[:3, 3] - prev_rel[:3, 3]))
    if (not np.isfinite(base_T_frame).all() or n_resid < min_resid
        or frame_speed > cfg.max_translation_per_frame
        or self._tracking_failure_injected(frame_index)):
      log.warning(f"tracking failed at frame {frame_index} "
                  f"({n_resid} residuals, {frame_speed:.2f} m moved); "
                  "holding last pose")
      base_T_frame = prev_rel
      self._tracking_failed_since_kf = True

    # The BA thread and the loop closure move the base pose and the frame
    # poses under this lock.
    with self._ba_lock:
      self.rgbd_video.frames[frame_index].global_T_frame = (
          self.base_kf_global_T_frame @ base_T_frame)
      self.last_frame_index = frame_index
    if len(self.base_kf_tr_frame) >= 3:
      self.base_kf_tr_frame.pop(0)
      self.frame_tr_base_kf.pop(0)
    self.base_kf_tr_frame.append(base_T_frame)
    self.frame_tr_base_kf.append(se3_np.inverse(base_T_frame))

  def _track_pairwise(self, calib: DepthCalibration, base_depth,
                      base_normals, base_intensity, tracked_depth,
                      tracked_normals, tracked_intensity,
                      est1, est2, transfer_free: bool = False,
                      gn_iterations: Optional[List[int]] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Calibrate both depth images with ``calib``, build both pyramids and
    track coarse-to-fine from two initial base_T_tracked estimates (the
    compute core of RunOdometry, bad_slam.cc:827-951). Returns
    (base_T_tracked, residual count), both on the device; with
    ``transfer_free`` the GN loops end without the host waiting;
    ``gn_iterations`` gets the H/b evaluations of each scale."""
    cfg = self.config
    residual_type = "gradient_xy"
    if cfg.use_gradmag_for_tracking:
      residual_type = "gradmag"
      base_intensity = image_proc.sobel_gradient_magnitude(base_intensity)
      tracked_intensity = image_proc.sobel_gradient_magnitude(
          tracked_intensity)
    base_pyr = build_pyramid(
        depth_model.calibrate_depth_image(calib.a, calib.cfactor, base_depth,
                                          calib.cell_size),
        base_normals, base_intensity, cfg.num_scales)
    tracked_pyr = build_pyramid(
        depth_model.calibrate_depth_image(calib.a, calib.cfactor,
                                          tracked_depth, calib.cell_size),
        tracked_normals, tracked_intensity, cfg.num_scales)
    return odometry_mod.track_frame_pairwise(
        base_pyr, tracked_pyr, calib.camera(), calib.baseline_fx,
        torch.as_tensor(est1, device=self.device),
        torch.as_tensor(est2, device=self.device),
        test_different_initial_estimates=True,
        use_depth_residuals=cfg.use_geometric_residuals,
        use_descriptor_residuals=cfg.use_photometric_residuals,
        use_pyramid_level_0=True,
        convergence_threshold=cfg.odometry_convergence_threshold,
        residual_type=residual_type, transfer_free=transfer_free,
        gn_iterations=gn_iterations)

  def track_keyframe_pair(self, base_slot: int, tracked_slot: int,
                          base_T_tracked_init: np.ndarray) -> np.ndarray:
    """Direct multi-scale alignment of two stored keyframes, for the loop
    closure's refinement (loop_detector.cc:498-548: base = the current
    keyframe, tracked = the matched keyframe or a neighbour; both sides use
    the keyframes' filtered depth, calibrated on the fly with the map's
    calibration; under parallel BA this runs on the BA thread)."""
    return self.track_keyframe_pair_device(
        base_slot, tracked_slot, base_T_tracked_init).cpu().numpy()

  def track_keyframe_pair_device(self, base_slot: int, tracked_slot: int,
                                 base_T_tracked_init, transfer_free=False
                                 ) -> torch.Tensor:
    """``track_keyframe_pair`` with the result left on the device; with
    ``transfer_free`` its GN loops end without the host waiting (the
    pipelined front-end's device closure)."""
    kf = self.direct_ba.kf
    base_T_tracked, _ = self._track_pairwise(
        self.calibration, kf.depth[base_slot], kf.normals[base_slot],
        kf.intensity[base_slot], kf.depth[tracked_slot],
        kf.normals[tracked_slot], kf.intensity[tracked_slot],
        base_T_tracked_init, base_T_tracked_init,
        transfer_free=transfer_free)
    return base_T_tracked

  def _tracking_failure_injected(self, frame_index: int) -> bool:
    """Fault-injection seam: report a tracking failure for this frame (a
    covered lens or a sensor blackout shows exactly as the gate firing).
    Test and benchmark harnesses override it; always False in
    production."""
    return False

  def _add_keyframe_to_ba(self, processed: ProcessedFrame, frame_index: int,
                          global_T_frame: np.ndarray,
                          detection_images: Optional[tuple] = None,
                          edge_weight: float = 1.0) -> int:
    """AddKeyframeToBA (bad_slam.cc:1120-1158): register the keyframe in the
    store (the first keyframe creates its surfels unfiltered), then run the
    loop closing when ``detection_images``, the host copies of its
    intensity and depth, are given. The caller must not hold _ba_lock: the
    closing takes it."""
    ba = self.direct_ba
    idx = ba.add_keyframe(
        processed.depth, processed.normals, processed.radius_sq,
        processed.intensity, processed.rgb, global_T_frame, frame_index)
    self.keyframe_frame_indices.append(frame_index)
    self.keyframe_edge_weight[idx] = edge_weight
    if ba.keyframe_count == 1:
      # bad_slam.cc:1087-1094
      ba.create_surfels_for_keyframe(idx, filter_new_surfels=False)
    elif not self.config.do_surfel_updates:
      ba.create_surfels_for_keyframe(idx, filter_new_surfels=True)
    if detection_images is not None:
      self.loop_detector.add_keyframe(idx, *detection_images, self)
    return idx

  def _loop_detection_due(self, frame_index: int) -> bool:
    """Throttle loop detection to loop_detection_image_frequency
    (bad_slam_config.h:367-370: by default the keyframe rate, so every
    keyframe; lower values subsample). The keyframe rate derives from the
    dataset's frame rate."""
    if self._dataset_fps is None:
      self._dataset_fps = self.rgbd_video.fps()
    freq = self.config.get_loop_detection_image_frequency(self._dataset_fps)
    kf_freq = self._dataset_fps / max(1, self.config.keyframe_interval)
    if freq >= kf_freq:
      return True
    interval = max(1, int(round(kf_freq / max(freq, 1e-6))))
    self._loop_detection_counter += 1
    return self._loop_detection_counter % interval == 0

  def _device_memory_stats(self) -> Optional[Tuple[int, int]]:
    """(free bytes, total bytes) of the device, or None where it reports
    none (the CPU). Free is what ``torch.cuda.mem_get_info`` reports plus
    the blocks the caching allocator holds unused. The watchdog reads
    memory only through this seam, so tests inject stats here."""
    if self.device.type != "cuda":
      return None
    free, total = torch.cuda.mem_get_info(self.device)
    cached = (torch.cuda.memory_reserved(self.device)
              - torch.cuda.memory_allocated(self.device))
    return free + cached, total

  def _check_memory_pressure(self):
    """The low-memory watchdog (bad_slam.cc:958-968): merge keyframes when
    free device memory drops below min_free_gpu_memory_mb plus about one
    keyframe."""
    stats = self._device_memory_stats()
    if not stats:
      return
    free, _ = stats
    if free < (self.config.min_free_gpu_memory_mb * 1024 * 1024
               + APPROX_KEYFRAME_BYTES):
      self.request_keyframe_merge()

  def request_keyframe_merge(self):
    """The memory-pressure keyframe merge. The map has one writer: the main
    thread under sequential BA, which merges here, and the BA thread under
    parallel BA, to which the request goes (the reference holds
    ba_thread_mutex_ across a BA iteration, bad_slam.cc:1273-1289). Deleted
    keyframes leave the loop detector's database too."""
    if self._parallel:
      with self._ba_condition:
        self._merge_requested = True
        self._handoff_event = self._record_main_event()
        self._ba_condition.notify_all()
      return
    deleted = self.direct_ba.merge_keyframes(self.loop_detector)
    self.num_keyframes_merged += deleted
    if deleted:
      log.warning(f"low device memory; merged {deleted} keyframe(s)")

  def create_keyframe(self, frame_index: int, processed: ProcessedFrame):
    """CreateKeyframe (bad_slam.cc:953-1097)."""
    self._raise_if_ba_thread_failed()
    self._check_memory_pressure()
    global_T_frame = np.asarray(
        self.rgbd_video.frames[frame_index].global_T_frame)
    # This keyframe's pose relative to the previous one, for the BA
    # thread's absolute-pose fixup (bad_slam.cc:1035-1037,1229-1231).
    last_kf_T_this = (self.base_kf_tr_frame[-1] if self.base_kf_tr_frame
                      else np.eye(4, dtype=np.float32))
    # Loop detection is decided here, and the host copies of the images
    # made here, on the main thread (bad_slam.cc:1016-1023); with parallel
    # detection the feature extraction and query run ahead on the
    # detector's thread, each queued image paired 1:1 with the closing in
    # the keyframe's registration.
    detection_images = None
    if (self.loop_detector is not None
        and self._loop_detection_due(frame_index)):
      detection_images = (processed.intensity.cpu().numpy(),
                          processed.depth.cpu().numpy())
      if self.loop_detector.parallel:
        self.loop_detector.queue_for_detection(*detection_images)
    edge_weight = (WEAK_EDGE_WEIGHT if self._tracking_failed_since_kf
                   else 1.0)
    self._tracking_failed_since_kf = False

    if self._parallel:
      if self._ba_stream is not None:
        # BA reads these tensors on its stream: their memory must not be
        # handed out again before it has.
        for t in processed:
          t.record_stream(self._ba_stream)
      with self._ba_condition:
        self._queued_keyframes.append(
            (processed, frame_index, last_kf_T_this, detection_images,
             edge_weight, time.perf_counter()))
        keyframes_added = (len(self._queued_keyframes)
                           + self.direct_ba.keyframe_count)
        self.base_kf_index = None   # set when the BA thread registers it
        self.base_kf_global_T_frame = global_T_frame
        self._handoff_event = self._record_main_event()
    else:
      self.base_kf_index = self._add_keyframe_to_ba(
          processed, frame_index, global_T_frame, detection_images,
          edge_weight)
      # The pose the keyframe was created at, as in the reference, even
      # where a loop closure inside just moved it: the next BA's trajectory
      # deformation refreshes it.
      self.base_kf_global_T_frame = global_T_frame
      keyframes_added = self.direct_ba.keyframe_count
    self.base_kf_images = processed

    # Rebase the motion-model history onto the new base keyframe
    # (bad_slam.cc:1062-1075).
    if self.base_kf_tr_frame:
      last = self.base_kf_tr_frame[-1]
      last_inv = self.frame_tr_base_kf[-1]
      for k in range(len(self.base_kf_tr_frame) - 1):
        self.frame_tr_base_kf[k] = se3_np.orthonormalize(
            self.frame_tr_base_kf[k] @ last)
        self.base_kf_tr_frame[k] = se3_np.orthonormalize(
            last_inv @ self.base_kf_tr_frame[k])
      self.base_kf_tr_frame[-1] = np.eye(4, dtype=np.float32)
      self.frame_tr_base_kf[-1] = np.eye(4, dtype=np.float32)
    else:
      self.base_kf_tr_frame.append(np.eye(4, dtype=np.float32))
      self.frame_tr_base_kf.append(np.eye(4, dtype=np.float32))

    if self.config.estimate_poses and keyframes_added >= 2:
      self.num_planned_ba_iterations += (
          self.config.max_num_ba_iterations_per_keyframe)

  # --- parallel BA (BAThreadMain, bad_slam.cc:1160-1313) ---

  def _record_main_event(self):
    """An event after the main thread's work so far, on its stream (None
    off the GPU): the BA stream waits on it before the work it hands
    over."""
    if self._main_stream is None:
      return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(self.device))
    return event

  def start_parallel_iterations(self, num_planned: int,
                                optimize_depth_intrinsics: bool,
                                optimize_color_intrinsics: bool):
    """StartParallelIterations (bad_slam.cc:1160-1190): queue up to
    max_num_ba_iterations_per_keyframe iteration requests."""
    self._raise_if_ba_thread_failed()
    options = dict(optimize_depth_intrinsics=optimize_depth_intrinsics,
                   optimize_color_intrinsics=optimize_color_intrinsics,
                   do_surfel_updates=self.config.do_surfel_updates)
    with self._ba_condition:
      cap = self.config.max_num_ba_iterations_per_keyframe
      to_queue = min(cap - len(self._parallel_iteration_queue), num_planned)
      for _ in range(max(0, to_queue)):
        self._parallel_iteration_queue.append(options)
      self._handoff_event = self._record_main_event()
      self._ba_condition.notify_all()

  def _drain_keyframe_queue_locked(self):
    """Register the queued keyframes, each at the pose of the last
    registered keyframe (which BA may have moved) times its relative pose.
    Called with _ba_lock held; releases it around each registration, whose
    loop closing takes it. A keyframe's time in the queue, from
    ``create_keyframe`` to here, is the span "Keyframe hand-off wait"."""
    while self._queued_keyframes:
      (processed, frame_index, last_kf_T_this, detection_images,
       edge_weight, queued_at) = self._queued_keyframes.pop(0)
      Timing.add_time("Keyframe hand-off wait",
                      time.perf_counter() - queued_at)
      ba = self.direct_ba
      if ba.keyframe_count > 0:
        last_pose = ba.kf.global_T_frame[ba.keyframe_count - 1]
        global_T_frame = last_pose.cpu().numpy() @ last_kf_T_this
      else:
        global_T_frame = np.asarray(
            self.rgbd_video.frames[frame_index].global_T_frame)
      self._ba_lock.release()
      try:
        idx = self._add_keyframe_to_ba(processed, frame_index, global_T_frame,
                                       detection_images, edge_weight)
      finally:
        self._ba_lock.acquire()
      self.rgbd_video.frames[frame_index].global_T_frame = global_T_frame
      if not self._queued_keyframes and self.base_kf_index is None:
        self.base_kf_index = idx
        self.base_kf_global_T_frame = global_T_frame

  def _publish_calibration(self):
    """Hand the front-end a snapshot of the calibration this thread just
    changed, with an event after its copy on this thread's stream."""
    snapshot = self.calibration.clone()
    event = None
    if self._ba_stream is not None:
      event = torch.cuda.Event()
      event.record(self._ba_stream)
    with self._ba_lock:
      self._published_calibration = (snapshot, event)

  def _ba_thread_main(self):
    """The BA thread: wait for a request, service a merge before the queued
    keyframes are registered (so that memory is freed before they are
    stored, bad_slam.cc:958-997), then run one BA iteration over all
    keyframes, without deactivation or PCG (bad_slam.cc:1268-1289), and the
    trajectory deformation. An error stops the thread and is kept for the
    main thread to raise."""
    try:
      with self._on_stream(self._ba_stream):
        while self._ba_thread_step():
          pass
    except BaseException as e:   # re-raised on the main thread
      with self._ba_condition:
        self._ba_thread_error = e
        self._ba_thread_failed = True
        self._ba_busy = False
        self._ba_condition.notify_all()

  def _ba_thread_step(self) -> bool:
    """One request of the BA thread; False once it is asked to quit."""
    with self._ba_condition:
      self._ba_busy = False
      while (not self._parallel_iteration_queue
             and not self._merge_requested and not self._quit_requested):
        self._ba_condition.wait(timeout=0.1)
      if self._quit_requested:
        return False
      self._ba_busy = True
      # A merge request alone still wakes the thread: memory pressure is
      # serviced even when no BA iteration is planned.
      options = (self._parallel_iteration_queue.pop(0)
                 if self._parallel_iteration_queue else None)
      merge_requested, self._merge_requested = self._merge_requested, False
      handoff = self._handoff_event
    if handoff is not None:
      self._ba_stream.wait_event(handoff)

    if merge_requested:
      deleted = self.direct_ba.merge_keyframes(self.loop_detector)
      self.num_keyframes_merged += deleted
      if deleted:
        log.warning(f"low device memory; merged {deleted} keyframe(s)")

    with self._ba_lock:
      self._drain_keyframe_queue_locked()
      original = self.direct_ba.kf.global_T_frame.cpu().numpy().copy()
    if options is None:
      return True
    k = self.direct_ba.keyframe_count
    if k >= 2:
      with Timing.time("BA thread iteration"):
        self.direct_ba.bundle_adjustment(
            optimize_depth_intrinsics=options["optimize_depth_intrinsics"],
            optimize_color_intrinsics=options["optimize_color_intrinsics"],
            do_surfel_updates=options["do_surfel_updates"],
            optimize_poses=True, optimize_geometry=True,
            min_iterations=0, max_iterations=1,
            active_keyframe_window_start=0,
            active_keyframe_window_end=k - 1,
            increase_ba_iteration_count=False)
      if (options["optimize_depth_intrinsics"]
          or options["optimize_color_intrinsics"]):
        self._publish_calibration()
    self._apply_trajectory_deformation(original)
    return True

  def _raise_if_ba_thread_failed(self):
    """Raise the BA thread's error on the calling thread, once."""
    with self._ba_lock:
      error, self._ba_thread_error = self._ba_thread_error, None
    if error is not None:
      raise BAThreadError(
          f"the parallel BA thread failed: {error!r}") from error

  def _join_streams(self):
    """Make the caller's stream wait for the work of both streams."""
    if self._main_stream is not None:
      caller = torch.cuda.current_stream(self.device)
      caller.wait_stream(self._main_stream)
      caller.wait_stream(self._ba_stream)

  def _drain_on_ba_stream_locked(self):
    """_drain_keyframe_queue_locked from another thread while the BA thread
    is idle, with the map's writes on the BA stream, after the caller's and
    the main stream's work, and the caller's stream after them."""
    self._join_streams()
    if self._ba_stream is not None:
      self._ba_stream.wait_stream(torch.cuda.current_stream(self.device))
    with self._on_stream(self._ba_stream):
      self._drain_keyframe_queue_locked()
    self._join_streams()

  def quiesce(self):
    """Wait until the BA thread has no request queued or in progress, then
    register the keyframes still queued, without stopping the thread: what
    reads a full snapshot mid-run (``io/state.save_state``) calls this."""
    if self._ba_thread is None:
      return
    while True:
      self._raise_if_ba_thread_failed()
      with self._ba_lock:
        if (not self._parallel_iteration_queue and not self._ba_busy
            and not self._merge_requested):
          self._drain_on_ba_stream_locked()
          return
      time.sleep(0.005)

  def stop_ba_thread_and_wait(self):
    """StopBAThreadAndWaitForIt (bad_slam.h): let the BA thread finish its
    queued iterations, stop it, register the keyframes still queued, and
    stop the loop detector's thread; then raise the BA thread's error if it
    had one. Safe to call more than once."""
    pl_thread = self._pl_ba_thread
    if pl_thread is not None:
      atexit.unregister(self.stop_ba_thread_and_wait)
      try:
        self._drain_pl_ba()
      finally:
        with self._ba_condition:
          self._quit_requested = True
          self._ba_condition.notify_all()
        pl_thread.join(timeout=BA_THREAD_JOIN_SECONDS)
        if pl_thread.is_alive():
          raise BAThreadError(
              f"the pipelined BA thread did not stop within "
              f"{BA_THREAD_JOIN_SECONDS} s of the request")
        self._pl_ba_thread = None
        self._join_streams()
    thread = self._ba_thread
    if thread is not None:
      atexit.unregister(self.stop_ba_thread_and_wait)
      while thread.is_alive():
        with self._ba_lock:
          if not self._parallel_iteration_queue:
            break
        time.sleep(0.01)
      with self._ba_condition:
        self._quit_requested = True
        self._ba_condition.notify_all()
      thread.join(timeout=BA_THREAD_JOIN_SECONDS)
      if thread.is_alive():
        raise BAThreadError(
            f"the parallel BA thread did not stop within "
            f"{BA_THREAD_JOIN_SECONDS} s of the request")
      self._ba_thread = None
      if not self._ba_thread_failed:
        with self._ba_lock:
          self._drain_on_ba_stream_locked()
      self._join_streams()
    if self.loop_detector is not None:
      self.loop_detector.request_exit_and_wait()
    self._raise_if_ba_thread_failed()

  # --- the pipelined front-end (slam/pipelined.py) ---

  def _process_frame_pipelined(self, frame_index: int, force_keyframe: bool):
    """ProcessFrame without the host waiting for the device: tracking, the
    motion model, the failure gate and the trajectory run on the device, BA
    in DirectBA's transfer-free mode. ``finalize_pipelined`` makes the
    global poses after the run."""
    cfg = self.config
    ba = self.direct_ba
    self._frame_timer_start = time.perf_counter()
    if cfg.target_frame_rate > 0:
      self._target_frame_end_time += 1.0 / cfg.target_frame_rate

    calibration = self._frame_calibration()
    with Timing.time("Preprocessing"):
      processed = self.preprocess_frame(frame_index, calibration)

    if cfg.estimate_poses and self.base_kf_images is not None:
      with Timing.time("Odometry"):
        injected = self._tracking_failure_injected(frame_index)
        if injected:
          self._tracking_failed_since_kf = True
        base = self.base_kf_images
        w, h = calibration.depth_size
        gn_iterations: List[int] = []

        def track(est1, est2):
          return self._track_pairwise(
              calibration, base.depth, base.normals, base.intensity,
              processed.raw_depth, processed.normals, processed.intensity,
              est1, est2, transfer_free=True, gn_iterations=gn_iterations)

        pl = self.pipelined_state
        pl.hist, pl.fail_acc = pipelined.track_frame(
            track, pl.hist, min(3, pl.hist_n), pl.traj_rel, frame_index,
            pl.fail_acc, injected, use_motion_model=cfg.use_motion_model,
            min_resid=max(50, (w * h) // 100),
            max_speed=float(cfg.max_translation_per_frame))
        pl.hist_n = min(3, pl.hist_n + 1)
        pl.traj_slot[frame_index] = pl.base_slot
        Timing.count("Odometry GN iterations", sum(gn_iterations))
      # Fault-injection seam: the device state between tracking and the
      # keyframe.
      self._after_pipelined_tracking(frame_index)
    self.last_frame_index = max(self.last_frame_index, frame_index)

    if (force_keyframe
        or (frame_index - cfg.start_frame) % cfg.keyframe_interval == 0):
      with Timing.time("Keyframe creation"):
        self._create_keyframe_pipelined(frame_index, processed)

    # One transfer-free BA iteration per frame while budget remains (the
    # parallel-BA thread's schedule, bad_slam.cc:1268-1289): inline, or
    # queued for the BA thread so that the frame never waits on BA.
    if self.num_planned_ba_iterations > 0 and ba.keyframe_count >= 2:
      self.ba_counter += 1
      k = ba.keyframe_count
      optimize_intrinsics = (
          cfg.optimize_intrinsics and k >= 10 and
          (k <= 20
           or self.ba_counter % cfg.intrinsics_optimization_interval == 0))
      opts = dict(
          optimize_depth_intrinsics=(optimize_intrinsics
                                     and cfg.use_geometric_residuals),
          optimize_color_intrinsics=(optimize_intrinsics
                                     and cfg.use_photometric_residuals),
          k=k)
      if not self._pl_concurrent_ba:
        with Timing.time("Bundle adjustment"):
          self._run_pl_ba_iteration(opts)
      elif self._pl_ba_thread.is_alive():
        self._enqueue_pl_ba(opts)
      else:
        # The thread died: raise its error once; after that the iterations
        # run here (queueing to a dead thread would drop them all).
        self._raise_if_ba_thread_failed()
        with Timing.time("Bundle adjustment"), self._pl_map_lock, \
            self._on_map_stream():
          self._run_pl_ba_iteration(opts)
      self.num_planned_ba_iterations -= 1

  @contextlib.contextmanager
  def _on_map_stream(self):
    """Map writes from the main thread: on the BA stream, after the main
    stream's work so far (a no-op without the two streams)."""
    if self._ba_stream is None:
      yield
      return
    self._ba_stream.wait_event(self._record_main_event())
    with torch.cuda.stream(self._ba_stream):
      yield

  def _enqueue_pl_ba(self, opts: dict) -> bool:
    """Hand one BA iteration to the pipelined BA thread. The backlog is
    capped, as start_parallel_iterations caps it: when BA is slower than the
    frames, the excess drops instead of queueing behind the camera, except
    loop-closure repair iterations (_pl_ba_repair_debt), which finalize
    flushes if the run ends first."""
    cfg = self.config
    with self._ba_condition:
      repair = self._pl_ba_repair_debt > 0
      if repair:
        self._pl_ba_repair_debt -= 1
      if repair or (len(self._pl_ba_queue)
                    < 3 * cfg.max_num_ba_iterations_per_keyframe):
        self._pl_ba_queue.append(dict(opts, event=self._record_main_event()))
        self._ba_condition.notify_all()
        return True
      self.pl_ba_dropped += 1
      return False

  def _run_pl_ba_iteration(self, opts: dict):
    """One transfer-free BA iteration over the whole store, and every
    max_num_ba_iterations_per_keyframe iterations the end tasks' delete and
    radius pass (without the merge): with increase_ba_iteration_count off,
    the counter-gated end tasks would run only once, and surfels orphaned by
    a closure's repair would stay."""
    cfg = self.config
    self.direct_ba.bundle_adjustment(
        optimize_depth_intrinsics=opts["optimize_depth_intrinsics"],
        optimize_color_intrinsics=opts["optimize_color_intrinsics"],
        do_surfel_updates=cfg.do_surfel_updates,
        optimize_poses=True, optimize_geometry=True,
        min_iterations=0, max_iterations=1,
        active_keyframe_window_start=0,
        active_keyframe_window_end=opts["k"] - 1,
        increase_ba_iteration_count=False, transfer_free=True)
    if cfg.do_surfel_updates:
      self._pl_ba_sched_count += 1
      if (self._pl_ba_sched_count
          % max(1, cfg.max_num_ba_iterations_per_keyframe) == 0):
        self.direct_ba.perform_ba_scheme_end_tasks(
            do_surfel_updates=False, transfer_free=True)
    if (self._pl_concurrent_ba and (opts["optimize_depth_intrinsics"]
                                    or opts["optimize_color_intrinsics"])):
      self._publish_calibration()

  def _pl_ba_thread_main(self):
    """The pipelined BA thread (BAThreadMain without the keyframe queue:
    the main thread registers keyframes): each queued iteration runs on the
    BA stream, after its hand-off event, holding the map lock. An error
    stops the thread and is kept for the main thread to raise."""
    try:
      with self._on_stream(self._ba_stream):
        while True:
          with self._ba_condition:
            self._pl_ba_busy = False
            while not self._pl_ba_queue and not self._quit_requested:
              self._ba_condition.wait(timeout=0.1)
            if not self._pl_ba_queue:
              return
            self._pl_ba_busy = True
            opts = self._pl_ba_queue.pop(0)
          if opts["event"] is not None:
            self._ba_stream.wait_event(opts["event"])
          with self._pl_map_lock, Timing.time("BA thread iteration"):
            self._run_pl_ba_iteration(opts)
    except BaseException as e:   # re-raised on the main thread
      with self._ba_condition:
        self._ba_thread_error = e
        self._ba_thread_failed = True
        self._pl_ba_busy = False
        self._pl_ba_queue.clear()
        self._ba_condition.notify_all()

  def _drain_pl_ba(self):
    """Wait, without waiting for the device, until the pipelined BA thread
    has no iteration queued or running; raise its error if it died."""
    if self._pl_ba_thread is None:
      return
    while True:
      self._raise_if_ba_thread_failed()
      with self._ba_lock:
        if not self._pl_ba_queue and not self._pl_ba_busy:
          return
        if not self._pl_ba_thread.is_alive():
          self._pl_ba_queue.clear()
          raise BAThreadError(
              "the pipelined BA thread died with queued iterations")
      time.sleep(0.002)

  def _after_pipelined_tracking(self, frame_index: int):
    """Hook between tracking and keyframe creation in the pipelined loop;
    a no-op (fault-injection harnesses override it)."""

  def _create_keyframe_pipelined(self, frame_index: int,
                                 processed: ProcessedFrame):
    """CreateKeyframe without reads: the pose is composed on the device from
    the base keyframe's current store pose; loop-detection features come
    from the dataset's host images (the reference extracts them on the CPU
    too, bad_slam.cc:1014-1024). The memory watchdog is skipped (its merge
    ranks poses read back): size the stores by the configuration. The map
    writes run under the map lock, on the BA stream when there is one."""
    ba = self.direct_ba
    cfg = self.config
    pl = self.pipelined_state
    lock = self._pl_map_lock or contextlib.nullcontext()
    if self._ba_stream is not None:
      # The BA stream reads these after the hand-off event; their memory
      # must not be handed out again before it has.
      for t in (*processed, pl.hist, pl.fail_acc):
        t.record_stream(self._ba_stream)
    with lock, self._on_map_stream():
      if ba.keyframe_count == 0 or not cfg.estimate_poses:
        # The first keyframe, or mapping only (--no_pose_estimation): the
        # dataset's pose, as the host front-end takes it; without tracking
        # the history stays the identity and composing would put every
        # keyframe onto the first.
        pose = to_device(np.asarray(
            self.rgbd_video.frames[frame_index].global_T_frame, np.float32),
            self.device)
      else:
        pose = pipelined.keyframe_pose(ba.kf.global_T_frame, pl.base_slot,
                                       pl.hist)
      idx = ba.add_keyframe(
          processed.depth, processed.normals, processed.radius_sq,
          processed.intensity, processed.rgb, pose, frame_index)
      self.keyframe_frame_indices.append(frame_index)
      # The odometry edge into this keyframe is weak where the failure gate
      # fired since the last one (the device closure's pose graph reads
      # it). The host mirror knows injected failures only.
      pl.ensure_edge_capacity(ba.kf.capacity, self.device)
      pipelined.record_edge_weight(pl.edge_weight, idx, pl.fail_acc)
      self.keyframe_edge_weight[idx] = (
          WEAK_EDGE_WEIGHT if self._tracking_failed_since_kf
          or self._tracking_failure_injected(frame_index) else 1.0)
      self._tracking_failed_since_kf = False
      if ba.keyframe_count == 1:
        ba.create_surfels_for_keyframe(idx, filter_new_surfels=False,
                                       transfer_free=True)
      elif not cfg.do_surfel_updates:
        ba.create_surfels_for_keyframe(idx, filter_new_surfels=True,
                                       transfer_free=True)
      if (self.loop_detector is not None
          and self._loop_detection_due(frame_index)):
        event = self.loop_detector.add_keyframe(
            idx, *self._host_detection_images(frame_index, processed), self)
        if event is not None and event.reason == "device-pending":
          self._plan_closure_repair()

    # The front-end's state, on the main stream: a new accumulator (the old
    # one was read above), the history rebased onto the new keyframe.
    pl.fail_acc = torch.zeros((), dtype=torch.float32, device=self.device)
    pl.base_slot = idx
    pl.traj_slot[frame_index] = idx
    if pl.hist_n == 0:
      pl.hist_n = 1   # the identity entry of the first keyframe
    else:
      pl.hist = pipelined.rebase_history(pl.hist)
    self.base_kf_index = idx
    self.base_kf_images = processed
    if cfg.estimate_poses and ba.keyframe_count >= 2:
      self.num_planned_ba_iterations += cfg.max_num_ba_iterations_per_keyframe

  def _plan_closure_repair(self):
    """The BA iterations that re-converge keyframes and surfels onto the
    poses a device closure corrected. Its applied flag is on the device, so
    they are planned either way (after a rejected closure they change
    little). Where the BA thread runs them they are owed to its queue, past
    its backlog cap; an inline run owes nothing."""
    budget = self.config.max_num_ba_iterations_per_keyframe
    self.num_planned_ba_iterations += budget
    if self._pl_concurrent_ba:
      self._pl_ba_repair_debt += budget

  def _host_detection_images(self, frame_index: int,
                             processed: ProcessedFrame):
    """Loop-detection inputs without reading the device: intensity and
    metric depth from the dataset's host images, with the u8-luma rounding
    of ops/image_proc.rgb_to_intensity and the max-depth cutoff of the
    processed depth (its bilateral smoothing and isolated-pixel removal are
    left out: far below RANSAC's 0.06 m gate). With a pyramid level the
    host images no longer match the detector's camera, and the processed
    images are read back instead."""
    cfg = self.config
    if cfg.pyramid_level_for_depth or cfg.pyramid_level_for_color:
      return processed.intensity.cpu().numpy(), processed.depth.cpu().numpy()
    video = self.rgbd_video
    frame = video.frames[frame_index]
    rgb = np.asarray(frame.rgb(), np.float32)
    luma = np.floor(0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
                    + 0.114 * rgb[..., 2] + 0.5)
    intensity = np.clip(luma, 0.0, 255.0) * (1.0 / 255.0)
    depth = (frame.depth_raw().astype(np.float32)
             * np.float32(video.raw_to_float_depth))
    depth = np.where((depth > 0.0) & (depth <= cfg.max_depth), depth, 0.0)
    return intensity.astype(np.float32), depth.astype(np.float32)

  def finalize_pipelined(self):
    """Write the global per-frame poses of a pipelined run into the video
    (the run's blocking reads): flush the closure repair iterations still
    owed into the BA thread's queue and wait for it, then read the relative
    trajectory and the keyframe poses, and the pending device closures'
    outcomes. A no-op for the host front-end."""
    if not self._pipelined:
      return
    t0 = time.perf_counter()
    # A closure near the end of the run plans more repair iterations than
    # frames are left to queue them on: they run now, as the reference's
    # BA thread finishes its planned iterations after the camera stops.
    debt = self._pl_ba_repair_debt
    if (debt > 0 and self._pl_ba_thread is not None
        and self._pl_ba_thread.is_alive()
        and self.direct_ba.keyframe_count >= 2):
      log.info(f"finalize_pipelined: flushing {debt} closure repair BA "
               f"iterations")
      opts = dict(optimize_depth_intrinsics=False,
                  optimize_color_intrinsics=False,
                  k=self.direct_ba.keyframe_count,
                  event=self._record_main_event())
      with self._ba_condition:
        self._pl_ba_queue.extend(dict(opts) for _ in range(debt))
        self._pl_ba_repair_debt = 0
        self._ba_condition.notify_all()
    self._drain_pl_ba()
    self._join_streams()
    t1 = time.perf_counter()
    poses = pipelined.finalize(
        self.pipelined_state, self.direct_ba.kf.global_T_frame,
        self.keyframe_frame_indices, self.last_frame_index)
    for i, p in poses.items():
      self.rgbd_video.frames[i].global_T_frame = p
    t2 = time.perf_counter()
    if self.loop_detector is not None:
      self.loop_detector.resolve_pending_device_events()
    log.info(f"finalize_pipelined: BA drain {t1 - t0:.3f} s, trajectory "
             f"{t2 - t1:.3f} s, device closures "
             f"{time.perf_counter() - t2:.3f} s")

  # --- bundle adjustment ---

  def run_bundle_adjustment(self, optimize_depth_intrinsics: bool,
                            optimize_color_intrinsics: bool,
                            max_iterations: int,
                            deadline: Optional[float] = None,
                            increase_ba_iteration_count: bool = True,
                            ) -> Tuple[int, bool]:
    """RunBundleAdjustment, sequential path (bad_slam.cc:481-536). In
    real-time mode the caller passes the frame deadline (perf_counter time)
    and increase_ba_iteration_count=False (bad_slam.cc:264-270)."""
    cfg = self.config
    k = self.direct_ba.keyframe_count
    # A host copy: the poses as they were before BA moved them.
    original = self.direct_ba.kf.global_T_frame.cpu().numpy().copy()
    with Timing.time("Bundle adjustment"):
      result = self.direct_ba.bundle_adjustment(
          optimize_depth_intrinsics=optimize_depth_intrinsics,
          optimize_color_intrinsics=optimize_color_intrinsics,
          do_surfel_updates=cfg.do_surfel_updates,
          optimize_poses=True,
          optimize_geometry=True,
          min_iterations=0,
          max_iterations=max_iterations,
          active_keyframe_window_start=0 if cfg.disable_deactivation else -1,
          active_keyframe_window_end=(
              (k - 1) if cfg.disable_deactivation else -1),
          increase_ba_iteration_count=increase_ba_iteration_count,
          deadline=deadline)
    self._apply_trajectory_deformation(original)
    return result

  def _apply_trajectory_deformation(self, original_kf_poses: np.ndarray):
    """Propagate the keyframes' pose changes to the frames between them and
    refresh the cached base-keyframe pose (bad_slam.cc:524-530), under
    _ba_lock, which the caller must not hold."""
    new_poses = self.direct_ba.kf.global_T_frame.cpu().numpy()
    with self._ba_lock:
      n_kf = len(self.keyframe_frame_indices)
      if n_kf and self.last_frame_index >= 0:
        frame_poses = [f.global_T_frame for f in self.rgbd_video.frames]
        orig_frame_T_global = se3_np.inverse(original_kf_poses[:n_kf])
        for slot in range(n_kf):
          frame_poses[self.keyframe_frame_indices[slot]] = new_poses[slot]
        extrapolate_and_interpolate_keyframe_pose_changes(
            self.keyframe_frame_indices, orig_frame_T_global,
            new_poses[:n_kf], frame_poses,
            start_frame=self.config.start_frame,
            end_frame=self.last_frame_index)
        for i, p in enumerate(frame_poses):
          self.rgbd_video.frames[i].global_T_frame = p
      if self.base_kf_index is not None:
        self.base_kf_global_T_frame = new_poses[self.base_kf_index]

  def update_keyframe_poses_in_video(self):
    """Write the optimized keyframe poses back to the video frames."""
    poses = self.direct_ba.kf.global_T_frame.cpu().numpy()
    for slot, frame_index in enumerate(self.keyframe_frame_indices):
      self.rgbd_video.frames[frame_index].global_T_frame = poses[slot]

  # --- trajectory access ---

  def trajectory(self) -> Tuple[List[float], List[np.ndarray]]:
    """(timestamps, global_T_frame) for all processed frames."""
    ts, poses = [], []
    for f in self.rgbd_video.frames[: self.last_frame_index + 1]:
      ts.append(f.depth_timestamp)
      poses.append(f.global_T_frame)
    return ts, poses
