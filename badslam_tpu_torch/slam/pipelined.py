"""The pipelined front-end: the per-frame state machine on the device.

Port of ``badslam_tpu/slam/pipelined.py``. The host front-end
(``BadSlam._process_frame``) reads the tracked pose back every frame: the
motion-model history, the failure gate and the keyframe bookkeeping run on
the host (bad_slam.cc:937-942). In the pipelined mode that state stays on
the device and the host never waits for the card from the first frame to
the last:

  * the constant-velocity history (<= 3 relative poses, bad_slam.cc:
    763-825) is a (3, 4, 4) device tensor, most recent last; the two
    predictions, their sanity guard, the tracking-failure gate and the SO(3)
    renormalization are device code;
  * each frame's pose is recorded relative to its base keyframe in a
    preallocated (N, 4, 4) device trajectory, written in place;
  * a keyframe's pose enters the store as a device tensor:
    store_pose[base_slot] @ relative, never read back;
  * bundle adjustment runs in ``DirectBA``'s transfer-free mode, one
    iteration per frame while budget remains (the parallel-BA thread's
    schedule, bad_slam.cc:1268-1289), inline or on a thread of its own;
  * loop-detection features come from the dataset's host images, and a
    closure runs as one device program (``loop/device_closure.py``).

``finalize`` makes the run's only blocking reads, the relative trajectory
and the keyframe poses, and composes each frame's global pose from its base
keyframe's final pose (the trajectory deformation of a pipelined run: the
reference interpolates keyframe pose changes onto the frames between them,
trajectory_deformation.cc:45-130; anchoring to the tracking base applies
exactly the base's change).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3, se3_np

# Pose-graph weight of an odometry edge into a keyframe made while the
# tracking-failure gate had fired (a constant-position guess, not a
# measurement): non-zero, so the edge still connects the graph, but a
# verified loop edge dominates it, and a later closure puts its correction
# there instead of spreading it along the whole trajectory.
WEAK_EDGE_WEIGHT = 0.05


class PipelinedState:
  """The front-end state on the device and its host bookkeeping."""

  def __init__(self, num_frames: int, device: torch.device):
    eye = torch.eye(4, dtype=torch.float32, device=device)
    self.hist = eye.repeat(3, 1, 1)     # base_kf_T_frame, most recent last
    self.hist_n = 0                     # valid entries, from the end
    self.traj_rel = eye.repeat(num_frames, 1, 1)
    # Base keyframe slot of each frame when it was tracked; -1 = untracked.
    self.traj_slot = np.full(num_frames, -1, np.int32)
    self.base_slot = -1
    # 1 once the tracking-failure gate fired since the last keyframe: the
    # gate fires on the device, so the host never reads it.
    self.fail_acc = torch.zeros((), dtype=torch.float32, device=device)
    # Per keyframe slot, the weight of the odometry edge from the previous
    # keyframe into it (WEAK_EDGE_WEIGHT where fail_acc was set), sized to
    # the keyframe store's capacity.
    self.edge_weight = None

  def ensure_edge_capacity(self, capacity: int, device: torch.device):
    """Size the edge weights to the keyframe capacity, on ``device``: the
    mesh's first device under a mesh, where JAX (:78-91) replicates them
    over the mesh; the port's closure computes on that one device."""
    if self.edge_weight is None:
      self.edge_weight = torch.ones(capacity, dtype=torch.float32,
                                    device=device)
    elif self.edge_weight.shape[0] < capacity:
      self.edge_weight = torch.cat([self.edge_weight, torch.ones(
          capacity - self.edge_weight.shape[0], dtype=torch.float32,
          device=device)])


def _sane_prediction(est: torch.Tensor, fallback: torch.Tensor
                     ) -> torch.Tensor:
  """The prediction's divergence guard: a non-finite or absurd prediction
  falls back; a sane one is re-orthonormalized (the motion model squares
  relative poses, doubling any rotation-block defect)."""
  bad = ~torch.isfinite(est).all() | (torch.linalg.norm(est[:3, 3]) > 10.0)
  return torch.where(bad, fallback, se3.orthonormalize(est))


def _predict(hist: torch.Tensor, hist_n: int, use_motion_model: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
  """Two constant-velocity hypotheses from the history (bad_slam.cc:
  763-825; hist[2] is the most recent relative pose)."""
  last = hist[2]
  if use_motion_model and hist_n >= 2:
    est1 = last @ se3.inverse(hist[1]) @ last
  else:
    est1 = last
  if use_motion_model and hist_n >= 3:
    prev_T_last = se3.inverse(hist[0]) @ hist[1]
    est2 = hist[1] @ prev_T_last @ prev_T_last
  else:
    est2 = est1
  fallback = torch.where(torch.isfinite(last).all(), last,
                         torch.eye(4, dtype=last.dtype, device=last.device))
  return _sane_prediction(est1, fallback), _sane_prediction(est2, fallback)


Tracker = Callable[[torch.Tensor, torch.Tensor],
                   Tuple[torch.Tensor, torch.Tensor]]


def track_frame(track: Tracker, hist: torch.Tensor, hist_n: int,
                traj_rel: torch.Tensor, frame_index: int,
                fail_acc: torch.Tensor, force_fail: bool, *,
                use_motion_model: bool, min_resid: int, max_speed: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
  """One frame of tracking on the device: prediction, ``track`` (the
  multi-scale pairwise tracking from two base_T_frame estimates to
  (base_T_frame, residual count)), renormalization, the failure gate, the
  history update and the trajectory entry, written into ``traj_rel`` in
  place. ``force_fail`` injects a failure (a covered lens shows exactly as
  the gate firing). Returns (hist', fail_acc'); fail_acc' is 1 once the gate
  fired since the last keyframe."""
  est1, est2 = _predict(hist, hist_n, use_motion_model)
  pose, n_resid = track(est1, est2)
  pose = se3.orthonormalize(pose)
  # Tracking-failure gate: too few associated pixels or an absurd
  # inter-frame speed hold the last relative pose.
  prev_rel = hist[2]
  speed = torch.linalg.norm(pose[:3, 3] - prev_rel[:3, 3])
  bad = (~torch.isfinite(pose).all() | (n_resid < min_resid)
         | (speed > max_speed))
  if force_fail:
    bad = torch.ones_like(bad)
  pose = torch.where(bad, prev_rel, pose)
  hist = torch.cat([hist[1:], pose[None]], dim=0)
  traj_rel[frame_index] = pose
  fail_acc = torch.maximum(fail_acc, bad.to(torch.float32))
  return hist, fail_acc


def keyframe_pose(kf_global_T_frame: torch.Tensor, base_slot: int,
                  hist: torch.Tensor) -> torch.Tensor:
  """A new keyframe's global pose: the base keyframe's current store pose
  composed with the tracked relative pose (bad_slam.cc:1029-1037, without
  the host round trip)."""
  return se3.orthonormalize(kf_global_T_frame[base_slot] @ hist[2])


def record_edge_weight(edge_weight: torch.Tensor, slot: int,
                       fail_acc: torch.Tensor) -> torch.Tensor:
  """Write the new keyframe's odometry-edge weight, in place:
  WEAK_EDGE_WEIGHT where the failure gate fired since the last keyframe.
  The caller resets fail_acc."""
  edge_weight[slot] = torch.where(fail_acc > 0, WEAK_EDGE_WEIGHT, 1.0)
  return edge_weight


def rebase_history(hist: torch.Tensor) -> torch.Tensor:
  """Rebase the history onto a new base keyframe (bad_slam.cc:1062-1075):
  every entry becomes relative to the latest frame, the new keyframe, whose
  own entry becomes the identity."""
  rebased = se3.orthonormalize(se3.inverse(hist[2]) @ hist)
  eye = torch.eye(4, dtype=hist.dtype, device=hist.device)
  return torch.cat([rebased[:2], eye[None]], dim=0)


def finalize(state: PipelinedState, kf_global_T_frame: torch.Tensor,
             keyframe_frame_indices: List[int], last_frame_index: int
             ) -> Dict[int, np.ndarray]:
  """The run's blocking reads: the relative trajectory and the keyframe
  poses, composed into {frame_index: (4, 4) global_T_frame} for every
  tracked frame; a keyframe's own frame takes its store pose."""
  rel = state.traj_rel.cpu().numpy()
  kf_poses = kf_global_T_frame.cpu().numpy()
  out = {}
  for i in range(last_frame_index + 1):
    s = state.traj_slot[i]
    if s >= 0:
      out[i] = se3_np.orthonormalize((kf_poses[s] @ rel[i]).astype(np.float32))
  for slot, fi in enumerate(keyframe_frame_indices):
    if fi <= last_frame_index:
      out[fi] = kf_poses[slot].astype(np.float32)
  return out
