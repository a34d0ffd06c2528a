"""``BadSlam.prewarm`` (``--prewarm``) and ``DirectBA.clone_for_prewarm`` of
the port, on the CPU.

The fixture is the reference's tests/test_frontend.py prewarm case: three
planes, a slow twist, 3 scales, a keyframe every 4 frames, at 80x60 (the
prewarm renders its own heightmap frames at the dataset's camera, so the
camera's size is its cost). What is held:

  * the live map stays empty after a prewarm, and a prewarm in the middle
    of a run leaves the map, the calibration and the trajectory as they
    were, the throwaway map's store growth, BA iterations and device
    closures included;
  * the run after a prewarm equals the run without it bit for bit (poses,
    surfel store, calibration), with the host front-end, with a pre-sized
    keyframe store and with the pipelined front-end and loop detection;
  * ``prewarm(max_ba_keyframes=N)`` pre-sizes the live keyframe store to
    the JAX package's ``DirectBA.reserve_keyframe_capacity(N)`` and the
    live loop then grows no store;
  * the warm frames converge in about the live frames' Gauss-Newton
    iterations (their constant twist; JAX's pure x translation does not);
  * self-calibration runs in the warm BA from the tenth keyframe on and the
    live calibration stays bitwise as it was;
  * a BA iteration on a clone leaves the original bitwise as it was, on one
    device and on a 2-shard CPU mesh;
  * the CLI with ``--prewarm --prewarm_keyframes 4`` exports the trajectory
    of the run without them.

Every comparison is exact: the port's runs are deterministic.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.slam.direct_ba import DirectBA as JaxDirectBA
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import keyframes as kf_mod, odometry
from badslam_tpu_torch.parallel import sharded_ba, spmd
from badslam_tpu_torch.slam import direct_ba as direct_ba_mod
from badslam_tpu_torch.slam.direct_ba import DirectBA
from badslam_tpu_torch.slam.system import BadSlam, check_supported
from badslam_tpu_torch.utils import synthetic, tum_synth
from badslam_tpu_torch.utils.timing import Timing

W, H = 80, 60
FRAMES = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread: the frames are small, and the suite's worker
  processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def _world():
  rng = np.random.default_rng(7)
  normals = []
  for _ in range(3):
    n = rng.uniform(-1, 1, 3).astype(np.float32)
    n[2] = -1.0
    normals.append(n / np.linalg.norm(n))
  return np.asarray(normals)


def _trajectory(n, step=0.004, rot_step=0.0012):
  return [se3.exp(torch.tensor(
      [step * i, 0.4 * step * i, -0.2 * step * i,
       rot_step * i, -0.5 * rot_step * i, 0.3 * rot_step * i],
      dtype=torch.float32)).numpy() for i in range(n)]


def _config(**kw):
  base = dict(
      keyframe_interval=4, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1,
      initial_keyframe_capacity=8, initial_surfel_capacity=1 << 14,
      enable_loop_detection=False, parallel_ba=False)
  base.update(kw)
  return BadSlamConfig(**base)


def _system(frames=FRAMES, **kw):
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), _trajectory(frames), _world())
  return BadSlam(_config(**kw), video, device="cpu")


def _map_state(slam):
  """Every tensor of the live map and calibration, and the host mirrors."""
  ba = slam.direct_ba
  tensors = [*ba.kf, *ba.surfels, *slam.calibration.buffers(), ba.color_intr]
  host = (ba.keyframe_count, ba._kf_valid_host.tolist(),
          ba.last_active_in_ba_iteration.tolist(), ba.ba_iteration_count,
          ba.last_ba_iteration_count, slam.last_frame_index,
          slam.base_kf_index, list(slam.keyframe_frame_indices))
  return [t.clone() for t in tensors], host


def _assert_same_state(a, b):
  (ta, ha), (tb, hb) = a, b
  assert ha == hb
  assert len(ta) == len(tb)
  for x, y in zip(ta, tb):
    assert torch.equal(x, y)


def _run(slam, frames=FRAMES):
  """The frames through ``slam``; (poses, surfel store, calibration)."""
  for i in range(frames):
    slam.process_frame(i)
  slam.stop_ba_thread_and_wait()
  slam.finalize_pipelined()
  poses = np.stack([f.global_T_frame
                    for f in slam.rgbd_video.frames[:frames]])
  tensors, _ = _map_state(slam)
  return poses, tensors


def _assert_same_run(a, b):
  np.testing.assert_array_equal(a[0], b[0])
  assert len(a[1]) == len(b[1])
  for x, y in zip(a[1], b[1]):
    assert torch.equal(x, y)


@contextlib.contextmanager
def _gn_iterations():
  """Counts the odometry's Gauss-Newton iterations (each evaluates its
  convergence test once)."""
  count = [0]
  real = odometry.is_scale_n_converged

  def counted(*args, **kwargs):
    count[0] += 1
    return real(*args, **kwargs)

  odometry.is_scale_n_converged = counted
  try:
    yield count
  finally:
    odometry.is_scale_n_converged = real


@pytest.fixture(scope="module")
def sequential():
  """The host front-end without prewarm, and after prewarm(6), with the
  GN iterations of the warm and of the live frames."""
  plain = _run(_system())
  slam = _system()
  with _gn_iterations() as gn:
    slam.prewarm(max_ba_keyframes=6)
    warm_gn = gn[0]
    ba = slam.direct_ba
    after_prewarm = (ba.keyframe_count, ba.surfel_count,
                     ba.surfel_watermark, slam.last_frame_index,
                     slam.base_kf_index)
    warmed = _run(slam)
    live_gn = gn[0] - warm_gn
  return dict(plain=plain, after_prewarm=after_prewarm,
              breakdown=slam.last_prewarm_breakdown, warmed=warmed,
              slam=slam, warm_gn=warm_gn, live_gn=live_gn)


def test_prewarm_leaves_the_map_empty(sequential):
  """(a) tests/test_frontend.py's prewarm case: the map stays empty."""
  assert sequential["after_prewarm"] == (0, 0, 0, -1, None)
  assert sequential["slam"].direct_ba.keyframe_count == 2   # frames 0, 4
  breakdown = sequential["breakdown"]
  assert {"render_warm_frames", "build_warm_system", "warm_frame_0",
          "stop_warm_threads"} <= set(breakdown)
  # The CPU loads no kernel library.
  assert not any(k.startswith("kernel_") for k in breakdown)


def test_run_after_prewarm_equals_run_without(sequential):
  """(b) The same bits: poses, surfel store, calibration."""
  _assert_same_run(sequential["plain"], sequential["warmed"])
  errors = [np.linalg.norm(p[:3, 3] - t[:3, 3]) for p, t in
            zip(sequential["warmed"][0], _trajectory(FRAMES))]
  assert max(errors) < 5e-3, errors


def test_warm_frames_track_like_live_frames(sequential):
  """The warm frames follow the dataset's kind of motion, a constant twist,
  and converge in about the live frames' GN iterations: JAX's warm path, a
  pure x translation over the heightmap, does not meet the convergence
  test and runs ~3x the live frames' iterations here (up to the caps on
  the card), which would make the prewarm pay for iterations the live
  run never runs."""
  warm_frames = sum(k.startswith("warm_frame_")
                    for k in sequential["breakdown"])
  warm = sequential["warm_gn"] / (warm_frames - 1)
  live = sequential["live_gn"] / (FRAMES - 1)
  assert warm <= 1.5 * live, (warm, live)


def test_prewarm_mid_run_leaves_the_map_as_it_was():
  """A prewarm into a map that holds keyframes: the live store is not
  pre-sized, so the throwaway map grows 2 -> 4 -> 8 and runs a BA
  iteration on a clone and the device closure at each capacity; the live
  map, calibration and pipelined state stay bitwise as they were."""
  slam = _system(frames=8, initial_keyframe_capacity=2,
                 pipelined_frontend=True, enable_loop_detection=True)
  for i in range(6):
    slam.process_frame(i)
  pl = slam.pipelined_state
  before = _map_state(slam), pl.traj_rel.clone(), pl.hist.clone()
  slam.prewarm(max_ba_keyframes=5)
  _assert_same_state(before[0], _map_state(slam))
  assert torch.equal(before[1], pl.traj_rel)
  assert torch.equal(before[2], pl.hist)
  assert {"ba_iteration_3_keyframes", "ba_iteration_5_keyframes",
          "device_closure_capacity_2", "device_closure_capacity_4",
          "device_closure_capacity_8"} <= set(slam.last_prewarm_breakdown)
  for i in range(6, 8):
    slam.process_frame(i)
  slam.finalize_pipelined()
  assert slam.direct_ba.keyframe_count == 2


@pytest.mark.parametrize("n", [3, 8, 17])
def test_prewarm_presizes_the_keyframe_store_as_jax(n):
  """(c) The live capacity after prewarm(max_ba_keyframes=n) is JAX's
  DirectBA.reserve_keyframe_capacity(n) from the same initial capacity."""
  slam = _system(initial_keyframe_capacity=2)
  slam.prewarm(num_keyframes=1, max_ba_keyframes=n)
  assert slam.direct_ba.keyframe_count == 0
  cam = jsynthetic.default_test_camera(W, H)
  ref = JaxDirectBA(JaxConfig(initial_keyframe_capacity=2,
                              initial_surfel_capacity=1 << 10,
                              sparse_surfel_cell_size=2), cam, cam)
  ref.reserve_keyframe_capacity(n)
  assert slam.direct_ba.kf.capacity == ref.kf.capacity
  assert len(slam.direct_ba._kf_valid_host) == ref.kf.capacity
  assert len(slam.direct_ba.last_active_in_ba_iteration) == ref.kf.capacity


def test_presized_live_loop_grows_no_store(monkeypatch):
  """(d) With max_ba_keyframes at least the run's keyframe count the live
  loop grows neither store (the counterpart of tests/test_pipelined.py's
  no-live-compiles case), and it still equals the run that grew."""
  plain = _run(_system(initial_keyframe_capacity=2, keyframe_interval=2))
  slam = _system(initial_keyframe_capacity=2, keyframe_interval=2)
  slam.prewarm(max_ba_keyframes=4)
  capacity = slam.direct_ba.kf.capacity
  surfel_capacity = slam.direct_ba.surfel_capacity
  grown = []
  for module in (kf_mod, direct_ba_mod.surfels_mod):
    real = module.grow
    monkeypatch.setattr(
        module, "grow",
        lambda store, cap, real=real: grown.append(cap) or real(store, cap))
  warmed = _run(slam)
  assert grown == []
  assert slam.direct_ba.keyframe_count == 3 and capacity == 4
  assert slam.direct_ba.kf.capacity == capacity
  assert slam.direct_ba.surfel_capacity == surfel_capacity
  _assert_same_run(plain, warmed)


def test_pipelined_prewarm_with_loop_detection():
  """(e) tests/test_pipelined.py:334: with loop detection the pipelined
  prewarm runs the device closure, leaves the map empty, and the run after
  it equals the run without."""
  kw = dict(pipelined_frontend=True, enable_loop_detection=True)
  plain = _run(_system(**kw))
  slam = _system(**kw)
  slam.prewarm(max_ba_keyframes=5)
  assert slam.direct_ba.keyframe_count == 0
  assert slam.last_frame_index == -1
  assert "device_closure_capacity_8" in slam.last_prewarm_breakdown
  _assert_same_run(plain, _run(slam))


def test_prewarm_self_calibration_leaves_the_calibration(monkeypatch):
  """(f) With optimize_intrinsics and max_ba_keyframes >= 10 the warm BA
  runs the intrinsics step (on a clone of the throwaway map) and the live
  calibration's tensors stay bitwise as they were."""
  slam = _system(optimize_intrinsics=True)
  calls = []
  real = DirectBA._optimize_intrinsics
  monkeypatch.setattr(
      DirectBA, "_optimize_intrinsics",
      lambda self, *a, **k: calls.append(self) or real(self, *a, **k))
  before = _map_state(slam)
  slam.prewarm(max_ba_keyframes=10)
  assert calls and all(ba is not slam.direct_ba for ba in calls)
  assert "ba_iteration_10_keyframes" in slam.last_prewarm_breakdown
  after = _map_state(slam)
  calibration = slice(len(after[0]) - 5, None)
  for x, y in zip(before[0][calibration], after[0][calibration]):
    assert torch.equal(x, y)
  # Only the keyframe store's capacity changed (16 for 10 keyframes).
  assert slam.direct_ba.kf.capacity == 16


def _mesh_back_end(slam):
  """The fixture's back-end continued on a 2-shard CPU mesh."""
  ba = slam.direct_ba
  surfels, kf, host = ba.to_numpy()
  mesh = spmd.Mesh([torch.device("cpu")] * 2, (sharded_ba.SURFEL_AXIS,))
  return DirectBA.from_numpy(
      slam.config, slam.calibration.camera(), ba.color_camera(), surfels,
      kf, slam.calibration.clone(), host, device="cpu", mesh=mesh)


def _ba_state(ba):
  tensors = [*ba.kf, *ba.surfels, *ba.calibration.buffers(), ba.color_intr]
  return ([t.clone() for t in tensors],
          (ba._kf_valid_host.tolist(), ba.last_active_in_ba_iteration.tolist(),
           ba.ba_iteration_count))


@pytest.mark.parametrize("mesh", [False, True], ids=["one_device", "mesh2"])
@pytest.mark.parametrize("use_pcg", [False, True], ids=["alternating", "pcg"])
def test_ba_on_a_clone_leaves_the_original(sequential, mesh, use_pcg):
  """(g) A BA iteration with both intrinsics flags on a clone (which
  writes poses, surfels and the calibration) leaves the original bitwise
  as it was."""
  ba = _mesh_back_end(sequential["slam"]) if mesh else \
      sequential["slam"].direct_ba
  before = _ba_state(ba)
  clone = ba.clone_for_prewarm()
  clone.config = dataclasses.replace(clone.config, use_pcg=use_pcg)
  with Timing.isolated() as stats:
    clone.bundle_adjustment(
        optimize_depth_intrinsics=True, optimize_color_intrinsics=True,
        max_iterations=1, active_keyframe_window_start=0,
        active_keyframe_window_end=ba.keyframe_count - 1,
        increase_ba_iteration_count=False)
  # The clone ran the solver its config names: one PCG solve, or none.
  counted = stats.get("BA PCG inner iterations")
  assert len(counted.samples if counted else []) == (1 if use_pcg else 0)
  _assert_same_state(before, _ba_state(ba))
  moved = _ba_state(clone)[0]
  assert not all(torch.equal(x, y) for x, y in zip(before[0], moved))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("tum80"))
  return tum_synth.write_tum_dataset(
      out, tum_synth.straight_trajectory(FRAMES), width=W,
      height=H)


def test_cli_prewarm_exports_the_same_trajectory(dataset, tmp_path):
  """(h) --prewarm --prewarm_keyframes 4 on the CLI: rc 0, and the
  trajectory file equals the run without the flags."""
  base = [dataset, "--device", "cpu", "--sequential_ba",
          "--no_loop_detection", "--keyframe_interval", "4",
          "--num_scales", "3", "--max_depth", "5.0", "--restrict_fps_to",
          "0", "--quiet"]
  plain, warmed = str(tmp_path / "plain.txt"), str(tmp_path / "warm.txt")
  assert port_main.main([*base, "--export_poses", plain]) == 0
  assert port_main.main([*base, "--prewarm", "--prewarm_keyframes", "4",
                         "--export_poses", warmed]) == 0
  with open(plain) as f, open(warmed) as g:
    text = f.read()
    assert text == g.read()
  assert len(text.splitlines()) == FRAMES


def test_no_pallas_preprocess_is_refused_on_cuda():
  """The one configuration the port refuses: the plain preprocess chain on
  a CUDA device, where it is only the kernel's test reference."""
  config = _config(use_pallas_preprocess=False)
  with pytest.raises(NotImplementedError, match="no_pallas_preprocess"):
    check_supported(config, torch.device("cuda"))
  check_supported(config, torch.device("cpu"))
