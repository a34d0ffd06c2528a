"""Trajectory deformation: propagate keyframe pose changes to non-keyframes.

The port's own copy of ``badslam_tpu/loop/trajectory_deformation.py``
(trajectory_deformation.cc:33-130 of the original BAD SLAM,
``RememberKeyframePoses`` + ``ExtrapolateAndInterpolateKeyframePoseChanges``):
after BA moves keyframes, every non-keyframe frame is moved by the
slerp/lerp-interpolated delta of its neighboring keyframes (extrapolated by
the nearest keyframe outside the keyframe range). Per-frame 4x4 products on
the host, in numpy.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from badslam_tpu_torch.geometry import se3_np


def remember_keyframe_poses(kf_global_T_frame: np.ndarray) -> np.ndarray:
  """Stores frame_T_global per keyframe (trajectory_deformation.cc:33-42)."""
  return se3_np.inverse(np.asarray(kf_global_T_frame, np.float32))


def extrapolate_and_interpolate_keyframe_pose_changes(
    keyframe_frame_indices: Sequence[int],   # video frame index per keyframe
    original_kf_frame_T_global: np.ndarray,  # (K,4,4) from remember_...
    new_kf_global_T_frame: np.ndarray,       # (K,4,4) post-optimization
    frame_poses: List[np.ndarray],           # per-frame global_T_frame, mutated
    start_frame: int = 0,
    end_frame: int | None = None,
):
  """trajectory_deformation.cc:45-130. ``frame_poses`` is updated in place;
  keyframe frames themselves are expected to already carry their new poses
  (the caller sets them from the optimizer), so they are skipped here."""
  n_frames = len(frame_poses)
  if end_frame is None:
    end_frame = n_frames - 1
  end_frame = min(end_frame, n_frames - 1)
  kf_idx = list(keyframe_frame_indices)
  k = len(kf_idx)
  if k == 0:
    return

  original_kf_frame_T_global = np.asarray(original_kf_frame_T_global,
                                          np.float32)
  new_kf_global_T_frame = np.asarray(new_kf_global_T_frame, np.float32)

  prev_k = 0
  next_k = 0
  for f in range(start_frame, end_frame + 1):
    while next_k < k and kf_idx[next_k] <= f:
      prev_k = next_k
      next_k += 1

    if kf_idx[prev_k] == f:
      continue  # keyframe: already updated by the caller

    T_f = np.asarray(frame_poses[f], np.float32)

    def delta_via(kf_slot):
      old_kf_T_f = original_kf_frame_T_global[kf_slot] @ T_f
      return new_kf_global_T_frame[kf_slot] @ old_kf_T_f

    if next_k >= k or kf_idx[prev_k] > f:
      # Extrapolate via the nearest keyframe.
      frame_poses[f] = delta_via(prev_k)
    else:
      # Interpolate the per-frame delta between the two bracketing keyframes
      # (trajectory_deformation.cc:85-126: deltas expressed in the frame's own
      # coordinates, combined with slerp+lerp).
      f_T_global = se3_np.inverse(T_f)
      d_prev = f_T_global @ delta_via(prev_k)
      d_next = f_T_global @ delta_via(next_k)
      factor = (f - kf_idx[prev_k]) / float(kf_idx[next_k] - kf_idx[prev_k])
      d = se3_np.interpolate(d_prev, d_next, factor)
      frame_poses[f] = T_f @ d
