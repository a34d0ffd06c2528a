"""The port's pipelined front-end (badslam_tpu_torch/slam/pipelined.py)
against the JAX package's, on the CPU.

The fixture is the reference's tests/test_pipelined.py: three planes at
160x120, 12 frames along a slow twist, 3 scales, a keyframe every 4 frames.
Both packages get the same numpy inputs.

  * every function of slam/pipelined.py, the device SE(3) helpers and
    loop/device_closure.verify_and_close against the JAX package's;
  * the whole pipelined system against the JAX package's, per frame, with
    inline BA and with the joint PCG solver, and through both CLIs;
  * the property the port holds on a GPU, that the host never waits for the
    device inside the loop, as a CPU guard: every read funnel of
    torch.Tensor raises inside the loop (the one exempt read is
    utils/transfer.read_flag, the lagged poll's CPU branch), with inline
    BA, with the BA thread and across a device closure;
  * twins of the reference's other pipelined cases, and a dead BA thread.

Tolerances: trajectories per frame within 1e-4 m and 1e-4 rad, live surfel
counts within 1%, map medians within 1e-4 m. ``orthonormalize`` is exact to
float32 rounding (held at 1e-7 against a float64 polar factor); against the
JAX package's float32 SVD, whose own error reaches 1.06e-6 on these inputs,
it is held at 2e-6 (ROADMAP queue 3, P13).
"""

import contextlib
import os
import sys
import threading

import numpy as np
import pytest
import torch

import badslam_tpu.main as jax_main
import jax.numpy as jnp
from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.eval import ate_rmse
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.loop import device_closure as jdevice_closure
from badslam_tpu.models.keyframes import KeyframeStore as JaxKeyframeStore
from badslam_tpu.slam import pipelined as jpipelined
from badslam_tpu.slam.system import BadSlam as JaxBadSlam
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu.utils import tum_synth
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.io import ply
from badslam_tpu_torch.io import state as state_io
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.loop import device_closure
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.slam import direct_ba as direct_ba_mod
from badslam_tpu_torch.slam import pipelined
from badslam_tpu_torch.slam.system import BadSlam, BAThreadError
from badslam_tpu_torch.utils import synthetic, transfer, tum_synth

W, H = 160, 120
N_FRAMES = 12
LIMIT = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread for this module: its frames are small, and the
  suite's worker processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


# --- the read guard ---

READ_FUNNELS = ("item", "__bool__", "__int__", "__float__", "__index__",
                "tolist", "numpy", "__array__")


@contextlib.contextmanager
def forbid_host_reads():
  """Raises on every read of a tensor's values into the host: the
  torch.Tensor funnels above, and ``cpu()`` / ``to("cpu")`` of a tensor
  that is not on the CPU. Only ``transfer.read_flag`` may read."""
  cls = torch.Tensor
  names = READ_FUNNELS + ("cpu", "to")
  own = {n: cls.__dict__[n] for n in names if n in cls.__dict__}
  real = {n: getattr(cls, n) for n in names}

  def funnel(name):
    def guarded(self, *args, **kwargs):
      if sys._getframe(1).f_code is transfer.read_flag.__code__:
        return real[name](self, *args, **kwargs)
      raise AssertionError(f"Tensor.{name}: a host read inside the loop")
    return guarded

  def cpu(self, *args, **kwargs):
    if self.device.type != "cpu":
      raise AssertionError("Tensor.cpu of a device tensor inside the loop")
    return real["cpu"](self, *args, **kwargs)

  def to(self, *args, **kwargs):
    target = torch._C._nn._parse_to(*args, **kwargs)[0]
    if (target is not None and target.type == "cpu"
        and self.device.type != "cpu"):
      raise AssertionError("Tensor.to(cpu) of a device tensor inside the "
                           "loop")
    return real["to"](self, *args, **kwargs)

  for n in READ_FUNNELS:
    setattr(cls, n, funnel(n))
  cls.cpu, cls.to = cpu, to
  try:
    yield
  finally:
    for n in names:
      if n in own:
        setattr(cls, n, own[n])
      else:
        delattr(cls, n)


def test_read_guard_fires_on_every_funnel():
  """The guard must catch each funnel, or the loop tests are vacuous; the
  poll's CPU read passes."""
  x = torch.ones(3)
  reads = [lambda: x.sum().item(), lambda: bool(x.sum()),
           lambda: int(x.sum()), lambda: float(x.sum()),
           lambda: [0, 1, 2][x.sum().long()], lambda: x.tolist(),
           lambda: x.numpy(), lambda: np.asarray(x),
           lambda: torch.ones(3, device="meta").cpu(),
           lambda: torch.ones(3, device="meta").to("cpu")]
  for read in reads:
    with pytest.raises(AssertionError):
      with forbid_host_reads():
        read()
  with forbid_host_reads():
    assert transfer.read_flag(x.sum() > 0)
    assert x.to(torch.float64).dtype == torch.float64
  assert x.sum().item() == 3.0   # the funnels are back


# --- the fixture of tests/test_pipelined.py ---

def _world():
  rng = np.random.default_rng(7)
  normals = []
  for _ in range(3):
    n = rng.uniform(-1, 1, 3).astype(np.float32)
    n[2] = -1.0
    normals.append(n / np.linalg.norm(n))
  return np.asarray(normals)


def _trajectory(n, step=0.004, rot_step=0.0012):
  return [np.asarray(jse3.exp(jnp.asarray(
      [step * i, 0.4 * step * i, -0.2 * step * i,
       rot_step * i, -0.5 * rot_step * i, 0.3 * rot_step * i],
      jnp.float32))) for i in range(n)]


def _config(**kw):
  base = dict(
      keyframe_interval=4, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1,
      initial_keyframe_capacity=8, initial_surfel_capacity=1 << 15,
      enable_loop_detection=False, parallel_ba=False)
  base.update(kw)
  return base


def _videos(traj, **kw):
  port = synthetic.make_synthetic_video(synthetic.default_test_camera(W, H),
                                        traj, _world(), **kw)
  ref = jsynthetic.make_synthetic_video(jsynthetic.default_test_camera(W, H),
                                        traj, _world(), **kw)
  for pf, jf in zip(port.frames, ref.frames):
    np.testing.assert_array_equal(pf.depth_raw(), jf.depth_raw())
    np.testing.assert_array_equal(pf.rgb(), jf.rgb())
  return port, ref


def _translation_errors(video, traj):
  return np.asarray([np.linalg.norm(
      video.frames[i].global_T_frame[:3, 3] - traj[i][:3, 3])
      for i in range(len(traj))])


def _assert_poses(a, b, limit=LIMIT):
  """(N, 4, 4) pose stacks agree within ``limit`` m and rad."""
  a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
  assert np.abs(a[:, :3, 3] - b[:, :3, 3]).max() <= limit
  rel = np.linalg.inv(b.astype(np.float64)) @ a
  rot = se3.log(torch.from_numpy(rel.astype(np.float32)))[:, 3:].norm(dim=-1)
  assert float(rot.max()) <= limit, rot


def _run_port(video, guarded=True, frames=N_FRAMES, **kw):
  """The port's pipelined system over ``frames`` frames, the loop under
  the read guard; returns (slam, the guard's error or None)."""
  slam = BadSlam(BadSlamConfig(**_config(pipelined_frontend=True, **kw)),
                 video, device="cpu")
  error = None
  try:
    with forbid_host_reads() if guarded else contextlib.nullcontext():
      for i in range(frames):
        slam.process_frame(i)
      slam._drain_pl_ba()
  except AssertionError as e:
    error = e
  finally:
    slam.stop_ba_thread_and_wait()
  slam.finalize_pipelined()
  return slam, error


@pytest.fixture(scope="module")
def systems():
  """Both packages' pipelined systems on the fixture, with inline BA and
  with use_pcg; the port's also with the BA thread, and its host
  front-end."""
  traj = _trajectory(N_FRAMES)
  out = {"traj": traj}
  for name, kw in (("inline", {}), ("pcg", {"use_pcg": True})):
    pvideo, jvideo = _videos(traj)
    slam, error = _run_port(pvideo, **kw)
    ref = JaxBadSlam(JaxConfig(**_config(pipelined_frontend=True, **kw)),
                     jvideo)
    for i in range(N_FRAMES):
      ref.process_frame(i)
    ref.finalize_pipelined()
    out[name] = dict(port=slam, jax=ref, port_video=pvideo,
                     jax_video=jvideo, error=error)
  pvideo = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  before = set(threading.enumerate())
  slam, error = _run_port(pvideo, pipelined_concurrent_ba=True,
                          parallel_ba=True)
  out["concurrent"] = dict(port=slam, port_video=pvideo, error=error,
                           threads_left=[t for t in threading.enumerate()
                                         if t not in before and t.is_alive()])
  hvideo = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  host = BadSlam(BadSlamConfig(**_config()), hvideo, device="cpu")
  for i in range(N_FRAMES):
    host.process_frame(i)
  out["host"] = dict(port=host, port_video=hvideo)
  return out


@pytest.mark.parametrize("name", ["inline", "pcg"])
def test_pipelined_system_matches_jax_per_frame(systems, name):
  run = systems[name]
  assert run["error"] is None, run["error"]
  port, ref = run["port"], run["jax"]
  _assert_poses([f.global_T_frame for f in run["port_video"].frames],
                [np.asarray(f.global_T_frame)
                 for f in run["jax_video"].frames])
  assert port.keyframe_frame_indices == ref.keyframe_frame_indices
  assert port.direct_ba.keyframe_count == 3
  ps, js = port.direct_ba.surfel_count, ref.direct_ba.surfel_count
  assert ps > 500 and abs(ps - js) <= 0.01 * js
  _assert_poses(port.direct_ba.kf.global_T_frame[:3].numpy(),
                np.asarray(ref.direct_ba.kf.global_T_frame)[:3])
  errs = _translation_errors(run["port_video"], systems["traj"])
  assert errs.max() < 5e-3, errs


def test_pipelined_concurrent_ba_reads_nothing_and_tracks(systems):
  """The BA thread runs the iterations; the guard covers both threads."""
  run = systems["concurrent"]
  assert run["error"] is None, run["error"]
  assert not run["threads_left"]
  slam = run["port"]
  assert slam._pl_ba_thread is None and slam.direct_ba.keyframe_count == 3
  assert slam.direct_ba.surfel_count > 500
  errs = _translation_errors(run["port_video"], systems["traj"])
  assert errs.max() < 5e-3, errs


def test_pipelined_matches_host_frontend(systems):
  """The two front-ends share the tracking math but anchor the frames
  between keyframes differently, so they are held to the truth: the
  pipelined error within twice the host one's (or 2 mm)."""
  errs_h = _translation_errors(systems["host"]["port_video"],
                               systems["traj"])
  errs_p = _translation_errors(systems["inline"]["port_video"],
                               systems["traj"])
  assert errs_p.max() < max(2.0 * errs_h.max(), 2e-3), (errs_h, errs_p)
  assert (systems["inline"]["port"].keyframe_frame_indices
          == systems["host"]["port"].keyframe_frame_indices)


# --- slam/pipelined.py, function by function ---

def _rand_pose(rng, scale=0.05):
  return np.asarray(jse3.exp(jnp.asarray(
      rng.normal(size=6).astype(np.float32) * scale)))


@pytest.mark.parametrize("hist_n", [0, 1, 2, 3])
@pytest.mark.parametrize("motion_model", [True, False])
def test_predict_matches_jax(hist_n, motion_model):
  rng = np.random.default_rng(hist_n)
  hist = np.stack([_rand_pose(rng) for _ in range(3)])
  for h in (hist, np.where(np.arange(3)[:, None, None] == 2, np.nan, hist)
            .astype(np.float32)):
    p1, p2 = pipelined._predict(torch.from_numpy(h), hist_n, motion_model)
    j1, j2 = jpipelined._predict(jnp.asarray(h), hist_n, motion_model)
    np.testing.assert_allclose(p1.numpy(), np.asarray(j1), atol=2e-6)
    np.testing.assert_allclose(p2.numpy(), np.asarray(j2), atol=2e-6)
  # An absurd prediction falls back to the last relative pose.
  far = hist.copy()
  far[2, 0, 3] = 20.0
  p1, _ = pipelined._predict(torch.from_numpy(far), 2, True)
  j1, _ = jpipelined._predict(jnp.asarray(far), 2, True)
  np.testing.assert_allclose(p1.numpy(), np.asarray(j1), atol=2e-6)


@pytest.fixture(scope="module")
def frame_pair():
  """Two preprocessed frames of the fixture (0 and 2) and a black one, from
  the port's plain preprocess chain, and a port system to track with."""
  traj = _trajectory(3)
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  slam = BadSlam(BadSlamConfig(**_config(pipelined_frontend=True)), video,
                 device="cpu")
  base, tracked = slam.preprocess_frame(0), slam.preprocess_frame(2)
  black = tracked._replace(raw_depth=torch.zeros_like(tracked.raw_depth))
  return slam, base, tracked, black


def _tracker(slam, base, tracked, transfer_free=True):
  def track(est1, est2):
    return slam._track_pairwise(
        slam.calibration, base.depth, base.normals, base.intensity,
        tracked.raw_depth, tracked.normals, tracked.intensity, est1, est2,
        transfer_free=transfer_free)
  return track


def test_transfer_free_odometry_equals_host_odometry(frame_pair):
  """The done flag holds the pose after convergence: the pose and the
  residual count are the host loop's, bit for bit."""
  slam, base, tracked, _ = frame_pair
  init = torch.eye(4)
  host = _tracker(slam, base, tracked, False)(init, init)
  free = _tracker(slam, base, tracked, True)(init, init)
  assert torch.equal(host[0], free[0]) and torch.equal(host[1], free[1])
  assert int(host[1]) > 1000


def test_track_frame_matches_jax(frame_pair):
  """track_frame with a tracked frame, with force_fail, and with a black
  frame that trips the failure gate through its residual count."""
  slam, base, tracked, black = frame_pair
  cfg = slam.config
  calib = slam.calibration
  rng = np.random.default_rng(3)
  hist = np.stack([np.eye(4, dtype=np.float32), _rand_pose(rng, 0.002),
                   _rand_pose(rng, 0.002)])
  for frame, force in ((tracked, False), (tracked, True), (black, False)):
    traj_p = torch.eye(4).repeat(4, 1, 1)
    hist_p, fail_p = pipelined.track_frame(
        _tracker(slam, base, frame), torch.from_numpy(hist), 2, traj_p, 3,
        torch.zeros(()), force, use_motion_model=True,
        min_resid=max(50, (W * H) // 100),
        max_speed=float(cfg.max_translation_per_frame))
    hist_j, traj_j, fail_j = jpipelined.track_frame(
        *(jnp.asarray(t.numpy()) for t in (
            base.depth, base.normals, base.intensity, frame.raw_depth,
            frame.normals, frame.intensity, calib.depth_intr, calib.a,
            calib.cfactor, calib.baseline_fx)),
        jnp.asarray(hist), jnp.tile(jnp.eye(4, dtype=jnp.float32), (4, 1, 1)),
        jnp.asarray(3, jnp.int32), jnp.zeros((), jnp.float32),
        jnp.asarray(1.0 if force else 0.0, jnp.float32),
        hist_n=2, width=W, height=H, cell_size=calib.cell_size,
        num_scales=cfg.num_scales, use_depth_residuals=True,
        use_descriptor_residuals=True, use_motion_model=True,
        convergence_threshold=cfg.odometry_convergence_threshold,
        residual_type="gradient_xy", min_resid=max(50, (W * H) // 100),
        max_speed=float(cfg.max_translation_per_frame))
    _assert_poses(hist_p.numpy(), np.asarray(hist_j))
    _assert_poses(traj_p.numpy(), np.asarray(traj_j))
    assert float(fail_p) == float(fail_j)
    failed = force or frame is black
    assert float(fail_p) == (1.0 if failed else 0.0)
    if failed:   # the last relative pose holds
      np.testing.assert_array_equal(hist_p[2].numpy(), hist[2])


def test_keyframe_pose_edge_weight_rebase_match_jax():
  rng = np.random.default_rng(11)
  poses = np.stack([_rand_pose(rng, 0.3) for _ in range(5)])
  hist = np.stack([_rand_pose(rng, 0.01) for _ in range(3)])
  np.testing.assert_allclose(
      pipelined.keyframe_pose(torch.from_numpy(poses), 3,
                              torch.from_numpy(hist)).numpy(),
      np.asarray(jpipelined.keyframe_pose(jnp.asarray(poses),
                                          jnp.asarray(3, jnp.int32),
                                          jnp.asarray(hist))), atol=2e-6)
  np.testing.assert_allclose(
      pipelined.rebase_history(torch.from_numpy(hist)).numpy(),
      np.asarray(jpipelined.rebase_history(jnp.asarray(hist))), atol=2e-6)
  for fail in (0.0, 1.0):
    weights = torch.ones(6)
    out = pipelined.record_edge_weight(weights, 4, torch.tensor(fail))
    jout, jacc = jpipelined.record_edge_weight(
        jnp.ones((6,), jnp.float32), jnp.asarray(4, jnp.int32),
        jnp.asarray(fail, jnp.float32))
    assert out is weights   # written in place
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    assert float(jacc) == 0.0
  assert pipelined.WEAK_EDGE_WEIGHT == jpipelined.WEAK_EDGE_WEIGHT


def test_finalize_matches_jax():
  rng = np.random.default_rng(5)
  n = 7
  rel = np.stack([_rand_pose(rng, 0.02) for _ in range(n)])
  kf = np.stack([_rand_pose(rng, 0.5) for _ in range(3)])
  slots = np.asarray([0, 0, 0, 1, 1, 2, -1], np.int32)
  port = pipelined.PipelinedState(n, torch.device("cpu"))
  port.traj_rel = torch.from_numpy(rel)
  port.traj_slot = slots.copy()
  ref = jpipelined.PipelinedState(n)
  ref.traj_rel = jnp.asarray(rel)
  ref.traj_slot = slots.copy()
  got = pipelined.finalize(port, torch.from_numpy(kf), [0, 3, 5], 5)
  want = jpipelined.finalize(ref, jnp.asarray(kf), [0, 3, 5], 5)
  assert sorted(got) == sorted(want) == [0, 1, 2, 3, 4, 5]
  for i in got:
    np.testing.assert_allclose(got[i], want[i], atol=1e-6)


# --- the device SE(3) helpers ---

@pytest.mark.parametrize("off", [0.0, 1e-6, 1e-4, 1e-3])
def test_orthonormalize_matches_the_svd(off):
  rng = np.random.default_rng(int(off * 1e7) + 1)
  for _ in range(40):
    T = np.array(_rand_pose(rng, 0.5))
    T[:3, :3] += rng.uniform(-off, off, (3, 3)).astype(np.float32)
    got = se3.orthonormalize(torch.from_numpy(T)).numpy()
    u, _, vt = np.linalg.svd(T[:3, :3].astype(np.float64))
    assert np.abs(got[:3, :3] - u @ vt).max() <= 1e-7
    want = np.asarray(jse3.orthonormalize(jnp.asarray(T)))
    assert np.abs(got - want).max() <= 2e-6   # ROADMAP queue 3, P13
    np.testing.assert_array_equal(got[:3, 3], T[:3, 3])


def test_average_poses_and_quaternions_match_jax():
  rng = np.random.default_rng(9)
  Ts = np.stack([_rand_pose(rng, 0.05) for _ in range(3)])
  np.testing.assert_allclose(
      se3.average_poses(torch.from_numpy(Ts)).numpy(),
      np.asarray(jse3.average_poses(jnp.asarray(Ts))), atol=1e-6)
  R = np.stack([_rand_pose(rng, 1.0)[:3, :3] for _ in range(16)])
  q = se3.matrix_to_quaternion(torch.from_numpy(R))
  np.testing.assert_allclose(
      q.numpy(), np.asarray(jse3.matrix_to_quaternion(jnp.asarray(R))),
      atol=1e-6)
  np.testing.assert_allclose(
      se3.quaternion_to_matrix(q).numpy(),
      np.asarray(jse3.quaternion_to_matrix(jnp.asarray(q.numpy()))),
      atol=1e-6)


# --- the device loop closure ---

def _drift_trajectory():
  traj = [np.asarray(jse3.exp(jnp.asarray(
      [0.003 * i, 0.001 * i, 0, 0.0008 * i, 0, 0], jnp.float32)))
      for i in range(10)]
  traj.append(traj[0].copy())
  return traj


DRIFT = (0.0, 0.0, 0.0, 0.06, 0.08)


@pytest.fixture(scope="module")
def closure():
  """tests/test_pipelined.py's drifted map: 10 frames, drift put into the
  device poses of keyframes 3 and 4, then the revisit of frame 0 under the
  read guard. Records the device program's inputs and result."""
  traj = _drift_trajectory()
  cam = synthetic.default_test_camera(W, H)
  video = synthetic.make_synthetic_video(cam, traj, _world(),
                                         texture_kind="checker")
  cfg = BadSlamConfig(**_config(
      pipelined_frontend=True, keyframe_interval=2,
      enable_loop_detection=True, initial_surfel_capacity=1 << 14))
  detector = LoopDetector(cfg, cam, recent_exclude=2)
  slam = BadSlam(cfg, video, device="cpu", loop_detector=detector)
  calls = []
  real = device_closure.verify_and_close

  def recording(*args):
    result = real(*args)
    calls.append((args, result))
    return result

  device_closure.verify_and_close = recording
  error = None
  try:
    for i in range(10):
      slam.process_frame(i)
    slam._drain_pl_ba()
    poses = slam.direct_ba.kf.global_T_frame.numpy().copy()
    for s, d in enumerate(DRIFT):
      poses[s][0, 3] += d
    slam.direct_ba.kf = slam.direct_ba.kf._replace(
        global_T_frame=torch.from_numpy(poses))
    planned = slam.num_planned_ba_iterations
    try:
      with forbid_host_reads():
        slam.process_frame(10, force_keyframe=True)
        slam._drain_pl_ba()
    except AssertionError as e:
      error = e
    pending = [e.reason for e in detector.events]
    debt = slam._pl_ba_repair_debt
    planned = (planned, slam.num_planned_ba_iterations)
    slam.finalize_pipelined()
  finally:
    device_closure.verify_and_close = real
    slam.stop_ba_thread_and_wait()
  return dict(slam=slam, detector=detector, video=video, traj=traj,
              calls=calls, error=error, pending=pending, debt=debt,
              planned=planned)


def test_device_closure_applied_on_drifted_map(closure):
  run = closure
  assert run["error"] is None, run["error"]
  assert run["pending"][-1] == "device-pending"
  event = run["detector"].events[-1]
  assert event.applied, event.reason
  assert event.matched_slot == 0 and event.reason == "closed"
  assert run["detector"].num_loops_closed == 1
  err = np.linalg.norm(run["video"].frames[10].global_T_frame[:3, 3]
                       - run["traj"][10][:3, 3])
  assert err < 0.04, f"revisit error {err:.3f} m (the drift was 0.08 m)"


def test_inline_run_owes_no_repair_iterations(closure):
  """The repair iterations are owed to the BA thread's queue only where a
  BA thread runs; an inline run plans them and owes nothing. The closing
  frame plans the closure's repair budget and the new keyframe's, and
  runs one iteration."""
  assert closure["debt"] == 0 and closure["slam"]._pl_ba_repair_debt == 0
  budget = closure["slam"].config.max_num_ba_iterations_per_keyframe
  before, after = closure["planned"]
  assert after == before + 2 * budget - 1, (before, after, budget)


def _jax_verify(args, cfg):
  """The JAX package's verify_and_close on the port call's inputs."""
  (poses, kf_depth, _track, depth_intr, baseline_fx, cur, old, nxt, prv,
   init, pts, mask, proj, ei, ej, w, kf_w, loop) = args
  return jdevice_closure.verify_and_close(
      cfg["kf"], *(jnp.asarray(t) for t in cfg["calib"]),
      *(jnp.asarray(s, jnp.int32) for s in (cur, old, nxt, prv)),
      jnp.asarray(init.numpy()), jnp.asarray(pts.numpy()),
      jnp.asarray(mask.numpy()), jnp.asarray(np.asarray(proj, np.float32)),
      jnp.asarray(ei.numpy().astype(np.int32)),
      jnp.asarray(ej.numpy().astype(np.int32)), jnp.asarray(w.numpy()),
      jnp.asarray(kf_w.numpy()),
      *(jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64
                    else t.numpy()) for t in loop),
      width=W, height=H, cell_size=2, num_scales=3,
      use_depth_residuals=True, use_descriptor_residuals=True,
      convergence_threshold=cfg["threshold"], residual_type="gradient_xy")


def test_verify_and_close_matches_jax(closure):
  """One state, the drifted map at the revisit: the true candidate (the
  recorded call) and a false one (keyframe 2 as the match, from the
  identity), through both packages' device programs."""
  run = closure
  slam = run["slam"]
  args, result = run["calls"][-1]
  kf = slam.direct_ba.kf
  jkf = JaxKeyframeStore(**{
      name: jnp.asarray(getattr(kf, name).numpy()) for name in kf._fields})
  jkf = jkf._replace(global_T_frame=jnp.asarray(args[0].numpy()))
  calib = slam.calibration
  cfg = dict(kf=jkf, threshold=slam.config.odometry_convergence_threshold,
             calib=[t.numpy() for t in (calib.depth_intr, calib.a,
                                        calib.cfactor, calib.baseline_fx)])
  false_args = list(args)
  false_args[6:9] = [2, 3, 1]
  false_args[9] = torch.eye(4)
  false_result = device_closure.verify_and_close(*false_args)
  for a, got in ((args, result), (false_args, false_result)):
    want = _jax_verify(a, cfg)
    for flag in ("applied", "consistent", "ba_enough", "depth_sane"):
      assert bool(getattr(got, flag)) == bool(getattr(want, flag)), flag
    assert abs(float(got.avg_px) - float(want.avg_px)) <= 1e-3
    _assert_poses(got.global_T_frame.numpy()[:6],
                  np.asarray(want.global_T_frame)[:6])
    for name in ("loop_ei", "loop_ej", "loop_w", "loop_count"):
      np.testing.assert_array_equal(getattr(got, name).numpy(),
                                    np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.loop_Z.numpy(), np.asarray(want.loop_Z),
                               atol=LIMIT)
  assert bool(result.applied) and not bool(false_result.applied)


# --- twins of the reference's other pipelined cases ---

def test_pipelined_loop_detection_uses_host_images():
  """Detection features come from the dataset's host images, equal to the
  JAX package's; the database gets one entry per keyframe."""
  traj = _trajectory(N_FRAMES)
  pvideo, jvideo = _videos(traj)
  slam, error = _run_port(pvideo, enable_loop_detection=True,
                          parallel_loop_detection=False)
  assert error is None, error
  assert not slam.loop_detector.parallel
  entries = [e for e in slam.loop_detector.entries if e is not None]
  assert len(entries) == slam.direct_ba.keyframe_count == 3
  assert _translation_errors(pvideo, traj).max() < 5e-3
  ref = JaxBadSlam(JaxConfig(**_config(pipelined_frontend=True)), jvideo)
  for i in slam.keyframe_frame_indices:
    got = slam._host_detection_images(i, None)
    want = ref._host_detection_images(i, None)
    for g, w in zip(got, want):
      assert g.dtype == np.float32
      np.testing.assert_array_equal(g, np.asarray(w, np.float32))


def test_pipelined_state_save_resume(tmp_path):
  """save_state mid-run writes the device trajectory into the snapshot
  first; a pipelined resume restarts at constant position from the
  restored base keyframe and keeps tracking."""
  traj = _trajectory(N_FRAMES)
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  slam = BadSlam(BadSlamConfig(**_config(pipelined_frontend=True)), video,
                 device="cpu")
  for i in range(8):
    slam.process_frame(i)
  path = str(tmp_path / "state.npz")
  state_io.save_state(path, slam)
  assert _translation_errors(video, traj[:8]).max() < 5e-3

  video2 = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  slam2 = BadSlam(BadSlamConfig(**_config(pipelined_frontend=True)), video2,
                  device="cpu")
  state_io.load_state(path, slam2)
  assert slam2.pipelined_state.base_slot == slam2.base_kf_index == 1
  assert slam2.pipelined_state.hist_n == 1
  with forbid_host_reads():
    for i in range(8, N_FRAMES):
      slam2.process_frame(i)
  slam2.finalize_pipelined()
  assert _translation_errors(video2, traj).max() < 5e-3


def test_pipelined_mapping_only_uses_dataset_poses():
  """--no_pose_estimation: the keyframes take the dataset's poses (without
  tracking, composing from the base keyframe would put every keyframe onto
  the first)."""
  traj = _trajectory(8)
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  for i, T in enumerate(traj):
    video.frames[i].global_T_frame = np.asarray(T, np.float32)
  slam, error = _run_port(video, frames=8, estimate_poses=False,
                          keyframe_interval=2)
  assert error is None, error
  kf_poses = slam.direct_ba.kf.global_T_frame.numpy()
  for slot, fi in enumerate(slam.keyframe_frame_indices):
    np.testing.assert_allclose(kf_poses[slot], traj[fi], atol=1e-4)


BLACKOUT = range(10, 15)
N_BLACKOUT = 24


def test_black_frames_do_not_derail_the_pipelined_system():
  """tests/test_blackout.py's pipelined case: frames 10-14 are black (a
  covered lens); the min-residual gate holds the pose through them, the
  post-blackout segment tracks the true relative motion, keyframes keep
  coming and the map has real surfels."""
  cam = synthetic.default_test_camera(W, H)
  traj = tum_synth.loop_trajectory(N_BLACKOUT, radius=0.08)
  video = synthetic.make_heightmap_video(cam, traj)
  for i in BLACKOUT:
    video.frames[i]._rgb = np.zeros((H, W, 3), np.uint8)
    video.frames[i]._depth = np.zeros((H, W), np.uint16)
  slam = BadSlam(BadSlamConfig(**_config(
      pipelined_frontend=True, initial_surfel_capacity=1 << 14)), video,
      device="cpu")
  with forbid_host_reads():
    for i in range(N_BLACKOUT):
      slam.process_frame(i)
  slam.finalize_pipelined()
  est = np.stack([video.frames[i].global_T_frame for i in range(N_BLACKOUT)])
  assert np.isfinite(est).all()
  for i in list(BLACKOUT)[1:]:
    delta = np.linalg.norm(est[i][:3, 3] - est[i - 1][:3, 3])
    assert delta < 8e-3, f"frame {i} moved {delta * 1e3:.1f} mm"
  post = slice(max(BLACKOUT) + 3, N_BLACKOUT)
  gt = np.stack(traj)
  est_rel = np.linalg.inv(est[post.start]) @ est[post]
  gt_rel = np.linalg.inv(gt[post.start]) @ gt[post]
  assert np.abs(est_rel[:, :3, 3] - gt_rel[:, :3, 3]).max() < 5e-3
  assert slam.direct_ba.keyframe_count >= 5
  assert slam.direct_ba.surfel_count > 100


# --- the CLI ---

CLI = ["--keyframe_interval", "4", "--max_num_ba_iterations_per_keyframe",
       "3", "--sparsification", "2", "--num_scales", "4", "--max_depth",
       "5.0", "--restrict_fps_to", "0", "--quiet", "--pipelined_frontend"]
CLI_FRAMES = 16


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
  out = str(tmp_path_factory.mktemp("tum160"))
  return tum_synth.write_tum_dataset(
      out, tum_synth.straight_trajectory(CLI_FRAMES), width=W, height=H)


def _cli_outputs(tmp_path, name):
  return (str(tmp_path / f"{name}.txt"), str(tmp_path / f"{name}.ply"))


# The fixture's configuration on the command line (the stores start at the
# CLI's default capacities).
FIXTURE_CLI = [
    "--keyframe_interval", "4", "--num_scales", "3", "--max_depth", "5.0",
    "--sparsification", "2",
    "--min_observation_count_while_bootstrapping_1", "1",
    "--min_observation_count_while_bootstrapping_2", "1",
    "--min_observation_count", "1", "--no_loop_detection",
    "--restrict_fps_to", "0", "--quiet", "--pipelined_frontend"]


def test_cli_pipelined_matches_jax(tmp_path):
  """--pipelined_frontend through both CLIs on the fixture written as a TUM
  dataset: trajectory, live surfels and the exported map's distance to the
  planes."""
  traj = _trajectory(N_FRAMES)
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  data = tum_synth.write_tum_video(str(tmp_path / "data"), video, traj)
  out = {}
  for name, main, extra in (
      ("port", port_main.main, ["--device", "cpu"]),
      ("jax", jax_main.main, [])):
    poses, cloud = _cli_outputs(tmp_path, name)
    assert main([data, *FIXTURE_CLI, *extra, "--export_poses", poses,
                 "--export_point_cloud", cloud]) == 0
    out[name] = (read_tum_trajectory(poses)[1],
                 ply.load_point_cloud_ply(cloud)[0])
  (poses_p, pos_p), (poses_j, pos_j) = out["port"], out["jax"]
  assert poses_p.shape == poses_j.shape == (N_FRAMES, 4, 4)
  _assert_poses(poses_p, poses_j)
  assert len(pos_p) > 1000 and abs(len(pos_p) - len(pos_j)) <= 0.01 * len(
      pos_j)

  def plane_median(pos):
    return float(np.median(np.abs(pos @ _world().T + 2.5).min(axis=1)))

  assert plane_median(pos_p) < 1e-3
  assert abs(plane_median(pos_p) - plane_median(pos_j)) <= LIMIT
  assert np.abs(poses_p[:, :3, 3] - np.stack(traj)[:, :3, 3]).max() < 5e-3


@pytest.mark.parametrize("flags", [
    ["--pipelined_concurrent_ba"], ["--use_pcg"], []],
    ids=["concurrent_ba", "pcg", "loop_detection"])
def test_cli_pipelined_modes_run(dataset, tmp_path, flags):
  """The port's CLI with the BA thread, with the joint PCG solver, and with
  loop detection on (inline): exports, accuracy, no thread left."""
  poses, cloud = _cli_outputs(tmp_path, "port")
  before = set(threading.enumerate())
  assert port_main.main([dataset, *CLI, *flags, "--device", "cpu",
                         "--export_poses", poses, "--export_point_cloud",
                         cloud]) == 0
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
  _, est = read_tum_trajectory(poses)
  _, gt = read_tum_trajectory(os.path.join(dataset, "groundtruth.txt"))
  assert est.shape == (CLI_FRAMES, 4, 4) and np.isfinite(est).all()
  assert ate_rmse(est[:, :3, 3], gt[:CLI_FRAMES, :3, 3])[0] < 2e-3
  pos, _, _ = ply.load_point_cloud_ply(cloud)
  assert len(pos) > 1000
  assert synthetic.surfel_map_error(pos)["median_abs_m"] < 1e-3


def test_dead_pipelined_ba_thread_is_raised(dataset, monkeypatch):
  """An error in an iteration on the pipelined BA thread is raised on the
  main thread, and the CLI ends with it (a non-zero exit for python -m),
  with no thread left."""
  real = direct_ba_mod.DirectBA.bundle_adjustment
  calls = []

  def failing(self, *args, **kwargs):
    if threading.current_thread().name == "pl_ba_thread":
      calls.append(1)
      if len(calls) == 2:
        raise FloatingPointError("injected into one BA iteration")
    return real(self, *args, **kwargs)

  monkeypatch.setattr(direct_ba_mod.DirectBA, "bundle_adjustment", failing)
  before = set(threading.enumerate())
  with pytest.raises(BAThreadError, match="injected") as info:
    port_main.main([dataset, *CLI, "--pipelined_concurrent_ba",
                    "--no_loop_detection", "--device", "cpu"])
  assert isinstance(info.value.__cause__, FloatingPointError)
  assert len(calls) == 2
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
