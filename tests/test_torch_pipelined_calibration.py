"""Self-calibration under the port's pipelined front-end against the JAX
package's, on the CPU.

The fixture of tests/test_torch_pipelined.py (three planes at 160x120, 12
frames, 3 scales) with a keyframe at every frame, so that the intrinsics
step runs from the tenth keyframe on: alternated
(models/intrinsics_opt.py) and as unknowns of the joint PCG solve
(models/pcg.py), each in DirectBA's transfer-free mode with the loop under
the read guard; and with the pipelined BA thread, which hands the front-end
each calibration it changes.

Tolerances: trajectories per frame within 1e-4 m and 1e-4 rad, live surfel
counts within 1%. The calibration after 12 keyframes of this scene is held
to the JAX package's within 3e-3 px for both cameras' intrinsics, 5e-4 for
the deformation ``a`` and 5e-4 for the cfactor grid (ROADMAP queue 3, P14:
here the port's host front-end lies up to 4.1e-3 px, and its cfactor grid
7.0e-3, from the JAX package's host front-end; the pipelined runs lie
closer). ``python -m tests.test_torch_pipelined_calibration`` prints these
gaps for both front-ends.
"""

import threading

import numpy as np
import pytest
import torch

from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.slam.system import BadSlam as JaxBadSlam
from badslam_tpu_torch.utils import synthetic
from tests.test_torch_pipelined import (H, N_FRAMES, W, _assert_poses,
                                        _config, _run_port, _trajectory,
                                        _translation_errors, _videos, _world)

SELF_CALIBRATION = dict(optimize_intrinsics=True, keyframe_interval=1)
INTRINSICS_PX = 3e-3
A_LIMIT = 5e-4
CFACTOR_LIMIT = 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def _initial_intrinsics():
  cam = synthetic.default_test_camera(W, H)
  return np.asarray([cam.fx, cam.fy, cam.cx, cam.cy], np.float32)


@pytest.mark.parametrize("use_pcg", [False, True], ids=["alternated", "pcg"])
def test_pipelined_self_calibration_matches_jax(use_pcg):
  kw = dict(SELF_CALIBRATION, use_pcg=use_pcg)
  traj = _trajectory(N_FRAMES)
  pvideo, jvideo = _videos(traj)
  slam, error = _run_port(pvideo, **kw)
  assert error is None, error
  ref = JaxBadSlam(JaxConfig(**_config(pipelined_frontend=True, **kw)),
                   jvideo)
  for i in range(N_FRAMES):
    ref.process_frame(i)
  ref.finalize_pipelined()

  _assert_poses([f.global_T_frame for f in pvideo.frames],
                [np.asarray(f.global_T_frame) for f in jvideo.frames])
  assert slam.direct_ba.keyframe_count == N_FRAMES
  ps, js = slam.direct_ba.surfel_count, ref.direct_ba.surfel_count
  assert ps > 500 and abs(ps - js) <= 0.01 * js
  assert _translation_errors(pvideo, traj).max() < 5e-3

  port, jba = slam.direct_ba, ref.direct_ba
  depth, color = port.calibration.depth_intr.numpy(), port.color_intr.numpy()
  # The intrinsics step ran and moved a camera well past the tolerance (the
  # joint solve moves the color camera here, the depth camera little).
  assert np.abs(np.stack([depth, color]) - _initial_intrinsics()).max() > (
      10 * INTRINSICS_PX)
  np.testing.assert_allclose(depth, np.asarray(jba.depth_intr), rtol=0,
                             atol=INTRINSICS_PX)
  np.testing.assert_allclose(color, np.asarray(jba.color_intr), rtol=0,
                             atol=INTRINSICS_PX)
  assert abs(float(port.calibration.a) - float(jba.a)) <= A_LIMIT
  np.testing.assert_allclose(port.calibration.cfactor.numpy(),
                             np.asarray(jba.cfactor), rtol=0,
                             atol=CFACTOR_LIMIT)
  assert np.abs(port.calibration.cfactor.numpy()).max() > 0
  # The front-end reads the calibration BA wrote (one object inline).
  assert slam.calibration is port.calibration


def test_pipelined_ba_thread_hands_the_calibration_over(monkeypatch):
  """With the BA thread, each calibration its intrinsics step writes is
  published, and the next frame's preprocessing and odometry take it;
  the read guard covers both threads."""
  traj = _trajectory(N_FRAMES)
  video = synthetic.make_synthetic_video(
      synthetic.default_test_camera(W, H), traj, _world())
  from badslam_tpu_torch.slam.system import BadSlam
  published, taken = [], []
  real_publish = BadSlam._publish_calibration
  real_take = BadSlam._frame_calibration

  def publish(self):
    published.append(True)
    real_publish(self)

  def take(self):
    calibration = real_take(self)
    taken.append(calibration)
    return calibration

  monkeypatch.setattr(BadSlam, "_publish_calibration", publish)
  monkeypatch.setattr(BadSlam, "_frame_calibration", take)
  before = set(threading.enumerate())
  slam, error = _run_port(video, pipelined_concurrent_ba=True,
                          parallel_ba=True, **SELF_CALIBRATION)
  assert error is None, error
  assert not [t for t in threading.enumerate()
              if t not in before and t.is_alive()]
  assert slam._pl_ba_thread is None
  assert published, "no intrinsics step ran on the BA thread"
  # The front-end's calibration is its first frame's clone until it takes
  # a published snapshot: a second object is one.
  handed = [c for c in taken if c is not taken[0]]
  assert handed, "no frame took a published calibration"
  moved = np.abs(handed[-1].depth_intr.numpy() - _initial_intrinsics())
  assert moved.max() > 10 * INTRINSICS_PX
  assert _translation_errors(video, traj).max() < 5e-3


def _gaps(pipelined: bool, use_pcg: bool) -> dict:
  """Both packages on the fixture with self-calibration, through the
  pipelined or the host front-end: the calibrations' largest gaps."""
  from badslam_tpu_torch.config import BadSlamConfig
  from badslam_tpu_torch.slam.system import BadSlam
  kw = dict(SELF_CALIBRATION, use_pcg=use_pcg, pipelined_frontend=pipelined)
  pvideo, jvideo = _videos(_trajectory(N_FRAMES))
  slam = BadSlam(BadSlamConfig(**_config(**kw)), pvideo, device="cpu")
  ref = JaxBadSlam(JaxConfig(**_config(**kw)), jvideo)
  for i in range(N_FRAMES):
    slam.process_frame(i)
    ref.process_frame(i)
  if pipelined:
    slam.finalize_pipelined()
    ref.finalize_pipelined()
  port, jba = slam.direct_ba, ref.direct_ba
  return {
      "depth_px": float(np.abs(port.calibration.depth_intr.numpy()
                               - np.asarray(jba.depth_intr)).max()),
      "color_px": float(np.abs(port.color_intr.numpy()
                               - np.asarray(jba.color_intr)).max()),
      "a": abs(float(port.calibration.a) - float(jba.a)),
      "cfactor": float(np.abs(port.calibration.cfactor.numpy()
                              - np.asarray(jba.cfactor)).max())}


if __name__ == "__main__":
  # The measurement behind P14: JAX_PLATFORMS=cpu python -m
  # tests.test_torch_pipelined_calibration
  torch.set_num_threads(1)
  for front in ("pipelined", "host"):
    for pcg in (False, True):
      print(front, "joint" if pcg else "alternated",
            _gaps(front == "pipelined", pcg), flush=True)
