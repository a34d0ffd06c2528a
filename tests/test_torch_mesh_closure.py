"""Loop closures with the back-end sharded: ``BadSlam(..., mesh=...)`` on a
virtual 2-shard CPU mesh through ``tests/test_mesh_system.py``'s closure
scenario (11 frames at 160x120, drift put into the stored poses of
keyframes 3 and 4, then the revisit of frame 0), on the host front-end
(the host closure) and on the pipelined one (the device closure program,
under the read guard), each held to the port's own single-device run: the
closure applied, the revisit within a quarter of the drift, the trajectory
within 1e-4 m and the surfel count within 1% + 16.

Two shards, not four: the closure plans ten repair iterations per keyframe,
and every sharded iteration repeats its per-keyframe launches once per
shard, so four shards would take this file past its time.
"""

import contextlib

import numpy as np
import pytest
import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic
from tests.test_torch_mesh_system import (W, H, _assert_matches, _config,
                                          make_mesh)
from tests.test_torch_pipelined import forbid_host_reads


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)

CLOSURE_CONFIG = dict(keyframe_interval=2, initial_keyframe_capacity=8,
                      enable_loop_detection=True)
DRIFT = (0.0, 0.0, 0.0, 0.06, 0.08)


def _closure_run(mesh, pipelined):
  """tests/test_mesh_system.py's closure scenario: 10 frames, drift put
  into the stored poses of keyframes 3 and 4, then the revisit of frame 0
  (under the read guard on the pipelined front-end)."""
  step = np.asarray([0.003, 0.001, 0, 0.0008, 0, 0], np.float32)
  traj = [se3.exp(torch.from_numpy(i * step)).numpy() for i in range(10)]
  traj.append(traj[0].copy())
  cam = synthetic.default_test_camera(W, H)
  video = synthetic.make_synthetic_video(
      cam, traj, synthetic.plane_world_normals(), texture_kind="checker")
  cfg = _config(pipelined_frontend=pipelined, **CLOSURE_CONFIG)
  detector = LoopDetector(cfg, cam, recent_exclude=2)
  slam = BadSlam(cfg, video, device="cpu", loop_detector=detector, mesh=mesh)
  for i in range(10):
    slam.process_frame(i)
  if pipelined:
    slam._drain_pl_ba()
  poses = slam.direct_ba.kf.global_T_frame.numpy().copy()
  for s, d in enumerate(DRIFT):
    poses[s][0, 3] += d
  slam.direct_ba.kf = slam.direct_ba.kf._replace(
      global_T_frame=torch.from_numpy(poses))
  slam.base_kf_global_T_frame = poses[4]
  with forbid_host_reads() if pipelined else contextlib.nullcontext():
    slam.process_frame(10, force_keyframe=True)
    if pipelined:
      slam._drain_pl_ba()
  slam.finalize_pipelined()
  slam.stop_ba_thread_and_wait()
  return slam, detector, traj


@pytest.mark.parametrize("pipelined", [False, True],
                         ids=["host_closure", "device_closure"])
def test_loop_closure_applies_under_mesh(pipelined):
  """An applied closure with the back-end sharded: on the host front-end
  the host closure, on the pipelined one the device closure program; both
  repair the drift as the single-device run does."""
  single, _, traj = _closure_run(None, pipelined)
  meshed, detector, _ = _closure_run(make_mesh(2), pipelined)
  assert meshed.direct_ba.mesh is not None
  event = detector.events[-1]
  assert event.applied and event.reason == "closed", event.reason
  err = np.linalg.norm(meshed.rgbd_video.frames[10].global_T_frame[:3, 3]
                       - traj[10][:3, 3])
  assert err < 0.25 * DRIFT[-1], err
  _assert_matches(meshed, single, n=11)
