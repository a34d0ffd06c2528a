"""A loop closure through the trained-vocabulary retrieval path, in the port
alone (CPU, 160x120): the twin of the reference's
tests/test_loop_closure.py::test_loop_closure_applied_at_bow_scale, held to
that test's own gates.

The camera creeps away from the start for 70 frames (35 keyframes, so the
BoW vocabulary and its inverted file replace the signature short list), a
sensor blackout over frames 40-55 holds the pose while the camera moves on
(the tracking-failure gate, through the ``_tracking_failure_injected``
seam), which leaves an offset of ~4 cm in every later keyframe, and frames
70-72 revisit the start. With BA off only the closures (retrieval, RANSAC,
refinement, the weak-edge pose graph) can repair it. Gates: the vocabulary
is the active path, at least one closure is applied, the blackout's
odometry edges carry WEAK_EDGE_WEIGHT, and the last revisit's position lies
within 0.02 m of the truth (the reference's run ends 0.0181 m away, the
port's 0.0190 m: a margin of 1 mm).
"""

import numpy as np
import pytest
import torch

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.slam.system import WEAK_EDGE_WEIGHT, BadSlam
from badslam_tpu_torch.utils import synthetic


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  """One intra-op thread for this module: its frames are small, and the
  suite's worker processes share the cores."""
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


AWAY = 70
BLACKOUT = range(40, 56)


def _pose(tangent) -> np.ndarray:
  return se3.exp(torch.tensor(tangent, dtype=torch.float32)).numpy()


class BlackoutSlam(BadSlam):
  def _tracking_failure_injected(self, frame_index):
    return frame_index in BLACKOUT


def test_loop_closure_applied_at_bow_scale_after_a_blackout():
  cam = synthetic.default_test_camera(160, 120)
  traj = [_pose([0.0022 * i, 0.0008 * i, 0, 0.0006 * i, 0, 0])
          for i in range(AWAY)]
  near0 = _pose([0.004, 0.001, 0, 0, 0, 0]) @ traj[0]
  traj += [near0, near0, traj[0].copy()]
  video = synthetic.make_synthetic_video(
      cam, traj, synthetic.plane_world_normals(), texture_kind="checker")
  cfg = BadSlamConfig(
      keyframe_interval=2, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1, min_observation_count=1,
      max_num_ba_iterations_per_keyframe=0,
      initial_keyframe_capacity=8, initial_surfel_capacity=1 << 14,
      parallel_ba=False)
  detector = LoopDetector(cfg, cam)
  slam = BlackoutSlam(cfg, video, device="cpu", loop_detector=detector)
  for i in range(AWAY):
    slam.process_frame(i)
  assert slam.direct_ba.keyframe_count == 35
  # The first revisit keyframe warms the temporal-consistency gate, the
  # second must close.
  for f in (AWAY, AWAY + 1, AWAY + 2):
    slam.process_frame(f, force_keyframe=(f != AWAY + 1))

  assert detector.vocab is not None, "the BoW vocabulary must be active"
  applied = [e for e in detector.events if e.applied]
  assert applied, [(e.matched_slot, e.reason) for e in detector.events]
  weak = [s for s, w in slam.keyframe_edge_weight.items()
          if w == WEAK_EDGE_WEIGHT]
  assert weak, "the blackout must leave weak odometry edges"
  err = np.linalg.norm(
      video.frames[AWAY + 2].global_T_frame[:3, 3] - traj[-1][:3, 3])
  assert err < 0.02, f"revisit pose error {err:.4f} m"
