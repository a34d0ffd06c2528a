"""SLAM state snapshot and restore, and calibration files.

Port of ``badslam_tpu/io/state.py`` (io.{h,cc} of the original BAD SLAM):
  * SaveState (io.cc:38-183): magic and version, the motion model, the
    configuration, all frame poses, the cameras, the cfactor image, the depth
    parameters, keyframe metadata, the persistent surfel attributes, the BA
    counters;
  * LoadState (io.cc:185-705): restores them and re-creates the keyframes'
    image data, and the loop detector's database, from the dataset;
  * SaveCalibration / LoadCalibration (io.h:66-74): three text files (depth
    intrinsics, color intrinsics, depth deformation), center convention on
    disk.

The formats are the reference's, name for name: one ``.npz`` archive with
its array names, ``MAGIC`` and ``VERSION``, and its three text files. A file
written by either package loads in the other. Keyframe images are not
stored; ``load_state`` re-creates them through the receiving system's
``preprocess_frame``, so on a GPU the fused preprocess kernel runs once per
restored keyframe. The PLY writer is ``io/ply.py``.

Loading writes the calibration in place (see ``models/calibration.py``).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.models import surfels as surfels_mod

MAGIC = "BADSLAM_TPU"
VERSION = 1


def _set(dst: torch.Tensor, values) -> None:
  """Overwrite a device tensor in place with host values of its shape."""
  src = torch.from_numpy(np.array(values, np.float32)).reshape(dst.shape)
  dst.copy_(src.to(dst.device))


def save_state(path: str, slam) -> None:
  """Snapshot the full SLAM state of a BadSlam system to one .npz file.
  Under parallel BA the BA thread is first left idle with every queued
  keyframe registered (``BadSlam.quiesce``); a pipelined run first writes
  its device trajectory into the video (``finalize_pipelined``)."""
  slam.quiesce()
  slam.finalize_pipelined()
  ba = slam.direct_ba
  calib = ba.calibration
  kf = {name: t.cpu().numpy() for name, t in ba.kf._asdict().items()
        if name in ("global_T_frame", "frame_index", "activation", "covis",
                    "valid")}
  slots = np.flatnonzero(kf["valid"])
  s = ba.surfels
  valid = s.valid

  frames = slam.rgbd_video.frames
  np.savez_compressed(
      path,
      magic=np.asarray(MAGIC),
      version=np.asarray(VERSION),
      config=np.asarray(json.dumps(dataclasses.asdict(slam.config))),
      # Motion model history (bad_slam.h base_kf_tr_frame_).
      base_kf_tr_frame=np.stack(slam.base_kf_tr_frame).astype(np.float32)
      if slam.base_kf_tr_frame else np.zeros((0, 4, 4), np.float32),
      base_kf_index=np.asarray(
          -1 if slam.base_kf_index is None
          else int(np.searchsorted(slots, slam.base_kf_index))),
      base_kf_global_T_frame=slam.base_kf_global_T_frame.astype(np.float32),
      last_frame_index=np.asarray(slam.last_frame_index),
      # Trajectory.
      frame_poses=np.stack(
          [f.global_T_frame for f in frames]).astype(np.float32),
      frame_timestamps=np.asarray(
          [f.depth_timestamp for f in frames], np.float64),
      # Cameras and depth parameters.
      depth_intr=calib.depth_intr.cpu().numpy(),
      color_intr=ba.color_intr.cpu().numpy(),
      depth_size=np.asarray(ba.depth_size),
      color_size=np.asarray(ba.color_size),
      a=calib.a.cpu().numpy(),
      cfactor=calib.cfactor.cpu().numpy(),
      baseline_fx=calib.baseline_fx.cpu().numpy(),
      cell_size=np.asarray(ba.cell_size),
      # Keyframe metadata, compacted to the valid slots (deleted slots are
      # dropped; covisibility and activation are re-indexed with them).
      kf_global_T_frame=kf["global_T_frame"][slots],
      kf_frame_index=kf["frame_index"][slots],
      kf_activation=kf["activation"][slots],
      kf_covis=kf["covis"][np.ix_(slots, slots)],
      keyframe_frame_indices=np.asarray(
          [slam.keyframe_frame_indices[i] for i in slots], np.int64),
      # Surfels: the persistent attributes of the valid ones (io.cc:141-166).
      surfel_pos=s.pos[valid].cpu().numpy(),
      surfel_normal=s.normal[valid].cpu().numpy(),
      surfel_radius_sq=s.radius_sq[valid].cpu().numpy(),
      surfel_color=s.color[valid].cpu().numpy(),
      surfel_desc=s.desc[valid].cpu().numpy(),
      # BA counters.
      ba_iteration_count=np.asarray(ba.ba_iteration_count),
      num_planned_ba_iterations=np.asarray(slam.num_planned_ba_iterations),
      last_active_in_ba_iteration=ba.last_active_in_ba_iteration[slots],
  )


def load_state(path: str, slam) -> None:
  """Restore a snapshot into a freshly constructed BadSlam system whose
  rgbd_video is the one the snapshot was taken with."""
  data = np.load(path, allow_pickle=False)
  if str(data["magic"]) != MAGIC:
    raise ValueError(f"Not a {MAGIC} state file: {path}")
  if int(data["version"]) != VERSION:
    raise ValueError(f"Unsupported state version {int(data['version'])}")

  ba = slam.direct_ba
  if ba.keyframe_count != 0 or ba.surfel_count != 0:
    raise ValueError(
        "load_state requires a freshly-constructed system: the receiving "
        f"map already holds {ba.keyframe_count} keyframes / "
        f"{ba.surfel_count} surfels (keyframe slots and loop-detector "
        "entries are assigned densely from 0 on load)")

  # A cfactor grid of the wrong resolution would corrupt every calibrated
  # depth: the geometry-critical settings must be the receiving system's.
  if int(data["cell_size"]) != ba.cell_size:
    raise ValueError(
        f"snapshot cell_size {int(data['cell_size'])} != configured "
        f"{ba.cell_size}")
  if tuple(int(v) for v in data["depth_size"]) != tuple(ba.depth_size):
    raise ValueError(
        f"snapshot depth size {tuple(data['depth_size'])} != dataset "
        f"{tuple(ba.depth_size)}")
  if tuple(int(v) for v in data["color_size"]) != tuple(ba.color_size):
    raise ValueError(
        f"snapshot color size {tuple(data['color_size'])} != dataset "
        f"{tuple(ba.color_size)}")

  # Trajectory.
  frame_poses = data["frame_poses"]
  for i, f in enumerate(slam.rgbd_video.frames[: len(frame_poses)]):
    f.global_T_frame = frame_poses[i]

  # Cameras and depth parameters, before any keyframe is preprocessed.
  calib = ba.calibration
  _set(calib.depth_intr, data["depth_intr"])
  _set(ba.color_intr, data["color_intr"])
  _set(calib.a, data["a"])
  _set(calib.cfactor, data["cfactor"])
  _set(calib.baseline_fx, data["baseline_fx"])

  # Keyframes: metadata from the snapshot (compacted to valid slots, so the
  # slots are assigned densely in its order), images by preprocessing.
  # add_keyframe keeps the host mirrors of count and validity.
  slam.keyframe_frame_indices = [int(v) for v in
                                 data["keyframe_frame_indices"]]
  kf_poses = data["kf_global_T_frame"]
  n_kf = int(kf_poses.shape[0])
  for slot in range(n_kf):
    frame_index = int(data["kf_frame_index"][slot])
    processed = slam.preprocess_frame(frame_index)
    idx = ba.add_keyframe(
        processed.depth, processed.normals, processed.radius_sq,
        processed.intensity, processed.rgb, kf_poses[slot], frame_index)
    assert idx == slot, f"keyframe slot mismatch on load: {idx} != {slot}"
    if slam.loop_detector is not None:
      # The detector's database from the same images, as LoadState does
      # (io.cc:521), so that later keyframes can close against the map.
      slam.loop_detector.add_to_database(
          idx, processed.intensity.cpu().numpy(),
          processed.depth.cpu().numpy())
  # Overwrite covisibility and activation with the snapshot's.
  k = ba.kf.capacity
  covis = np.zeros((k, k), bool)
  src = data["kf_covis"]
  m = min(k, src.shape[0])
  covis[:m, :m] = src[:m, :m]
  act = np.zeros((k,), np.int32)
  act[:m] = data["kf_activation"][:m]
  ba.kf = ba.kf._replace(covis=torch.from_numpy(covis).to(ba.device),
                         activation=torch.from_numpy(act).to(ba.device))

  # Surfels: the live ones, packed from slot 0.
  n = int(data["surfel_pos"].shape[0])
  cap = ba.surfels.capacity
  while cap < n:
    cap *= 2

  def fill(values, dtype):
    out = np.zeros((cap,) + values.shape[1:], dtype)
    out[:n] = values
    return out

  mask = np.zeros((cap,), bool)
  mask[:n] = True
  ba.surfels = surfels_mod.from_numpy(dict(
      pos=fill(data["surfel_pos"], np.float32),
      normal=fill(data["surfel_normal"], np.float32),
      radius_sq=fill(data["surfel_radius_sq"], np.float32),
      color=fill(data["surfel_color"], np.float32),
      desc=fill(data["surfel_desc"], np.float32),
      valid=mask, active=mask.copy(), count=n), ba.device)
  # The store was replaced: the host's upper bound on the watermark must
  # follow it (the count caches are keyed on the tensors and refresh).
  ba._watermark_bound = n

  # Motion model and counters.
  hist = data["base_kf_tr_frame"]
  slam.base_kf_tr_frame = [hist[i] for i in range(len(hist))]
  slam.frame_tr_base_kf = [se3_np.inverse(h).astype(np.float32)
                           for h in slam.base_kf_tr_frame]
  bki = int(data["base_kf_index"])
  slam.base_kf_index = None if bki < 0 else bki
  if slam.base_kf_index is not None and slam.base_kf_index < n_kf:
    # The odometry's base-keyframe images, from the dataset.
    slam.base_kf_images = slam.preprocess_frame(
        slam.keyframe_frame_indices[slam.base_kf_index])
  slam.base_kf_global_T_frame = data["base_kf_global_T_frame"]
  slam.last_frame_index = int(data["last_frame_index"])
  ba.ba_iteration_count = int(data["ba_iteration_count"])
  slam.num_planned_ba_iterations = int(data["num_planned_ba_iterations"])
  laba = data["last_active_in_ba_iteration"]
  ba.last_active_in_ba_iteration[: len(laba)] = laba

  # A pipelined resume restarts the device state machine at constant
  # position from the restored base keyframe: a snapshot holds no device
  # history, and one identity entry is the motion model's reset at a
  # keyframe. The frames before the snapshot keep their restored poses.
  if slam._pipelined and slam.base_kf_index is not None:
    slam.pipelined_state.base_slot = slam.base_kf_index
    slam.pipelined_state.hist_n = 1


# --- calibration files (io.h:66-74) ---


def save_calibration(base_path: str, slam) -> None:
  """Three text files like the original: <base>.depth_intrinsics.txt,
  <base>.color_intrinsics.txt, <base>.deformation.txt."""
  ba = slam.direct_ba
  calib = ba.calibration
  di = calib.depth_intr.cpu().numpy()
  ci = ba.color_intr.cpu().numpy()
  with open(base_path + ".depth_intrinsics.txt", "w") as f:
    # The files carry the center convention of calibration.txt.
    f.write(f"{di[0]} {di[1]} {di[2] - 0.5} {di[3] - 0.5}\n")
  with open(base_path + ".color_intrinsics.txt", "w") as f:
    f.write(f"{ci[0]} {ci[1]} {ci[2] - 0.5} {ci[3] - 0.5}\n")
  np.savetxt(base_path + ".deformation.txt",
             np.concatenate([[float(calib.a)],
                             calib.cfactor.cpu().numpy().ravel()]))


def load_calibration(base_path: str, slam) -> None:
  ba = slam.direct_ba
  calib = ba.calibration
  for name, dst in (("depth", calib.depth_intr), ("color", ba.color_intr)):
    with open(f"{base_path}.{name}_intrinsics.txt") as f:
      fx, fy, cx, cy = (float(v) for v in f.readline().split()[:4])
    _set(dst, [fx, fy, cx + 0.5, cy + 0.5])
  deform = np.loadtxt(base_path + ".deformation.txt")
  _set(calib.a, deform[0])
  _set(calib.cfactor, deform[1:])
