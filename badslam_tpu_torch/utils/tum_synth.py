"""Synthetic TUM-format datasets: textured sequences of the heightmap world
on disk.

Port of ``badslam_tpu/utils/tum_synth.py``. It writes a dataset directory in
the layout that ``io.dataset.load_tum_dataset`` (and the original's
ReadTUMRGBDDatasetAssociatedAndCalibrated) reads:

  calibration.txt    "fx fy cx cy" (center convention)
  associated.txt     "rgb_ts rgb/NNNNNN.png depth_ts depth/NNNNNN.png"
  groundtruth.txt    TUM trajectory "ts tx ty tz qx qy qz qw"
  rgb/NNNNNN.png     8-bit grey as RGB
  depth/NNNNNN.png   16-bit raw depth (depth_scaling * metres)

The world is ``synthetic.render_heightmap``'s, so depth and photometric
residuals agree across views; the default trajectory is a closed loop that
revisits its start pose. Frames render on a thread pool of
``synthetic.RENDER_WORKERS`` threads (numpy's array loops release the
interpreter lock) and are written in order.

  python -m badslam_tpu_torch.utils.tum_synth out_dir [--frames N]
      [--size WxH] [--trajectory loop|straight] [--noise] [--occlusions]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import os
import zlib
from typing import List, Optional

import numpy as np
import torch
from PIL import Image

from badslam_tpu_torch.geometry import se3, se3_np
from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.io.dataset import RGBDVideo
from badslam_tpu_torch.utils import synthetic


def loop_trajectory(num_frames: int, radius: float = 0.25,
                    wobble: float = 0.03, loops: float = 1.0,
                    look_jitter: float = 0.06) -> List[np.ndarray]:
  """A closed horizontal circle above the heightmap with a gentle look
  around: the camera ends where it started, after ``loops`` circles. Poses
  are global_T_frame, the camera looking roughly along +z."""
  out = []
  for i in range(num_frames):
    s = loops * 2.0 * np.pi * i / num_frames
    pos = np.array([radius * np.sin(s), radius * (1.0 - np.cos(s)),
                    wobble * np.sin(2.0 * s)], np.float64)
    yaw = look_jitter * np.sin(3.0 * s)
    pitch = look_jitter * np.cos(2.0 * s) * 0.7
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    T = np.eye(4)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = pos
    out.append(T.astype(np.float32))
  return out


def straight_trajectory(num_frames: int, step=None) -> List[np.ndarray]:
  """The constant-twist trajectory of the odometry-only benchmark
  configuration: frame i is exp(i * step), by the port's SE(3)
  exponential."""
  if step is None:
    step = [0.002, 0.0008, -0.0005, 0.0005, -0.00025, 0.0004]
  step = np.asarray(step, np.float64)
  return [se3.exp(torch.as_tensor(i * step, dtype=torch.float32)).numpy()
          for i in range(num_frames)]


def apply_sensor_noise(depth: np.ndarray, intensity: np.ndarray,
                       rng: np.random.Generator,
                       depth_sigma=(0.0012, 0.0019),
                       dropout: float = 0.002,
                       intensity_sigma: float = 2.0 / 255.0,
                       exposure_jitter: float = 0.02):
  """Kinect-class RGB-D sensor noise (the axial model of Khoshelham and
  Elberink 2012): depth sigma s0 + s1 (z - 0.4)^2 metres, random invalid
  dropouts, intensity noise and a per-frame exposure gain. The writer
  quantizes to u16 and u8 afterwards as for a clean frame."""
  z = depth
  sigma = depth_sigma[0] + depth_sigma[1] * np.square(
      np.maximum(z - 0.4, 0.0))
  z = np.where(z > 0.0, z + rng.normal(size=z.shape) * sigma, 0.0)
  z = np.where(rng.random(z.shape) < dropout, 0.0, z)
  gain = 1.0 + rng.uniform(-exposure_jitter, exposure_jitter)
  i = np.clip(intensity * gain
              + rng.normal(size=intensity.shape) * intensity_sigma, 0.0, 1.0)
  return z.astype(np.float32), i.astype(np.float32)


def write_tum_dataset(
    out_dir: str,
    trajectory: List[np.ndarray],
    width: int = 640,
    height: int = 480,
    depth_scaling: float = 5000.0,
    fps: float = 30.0,
    seed: int = 5,
    z_distance: float = 1.0,
    z_variation: float = 0.05,
    camera: Optional[PinholeCamera] = None,
    sensor_noise: bool = False,
    occlusions: bool = False,
    quiet: bool = False,
    texture_period: Optional[float] = None,
    blackout_windows: Optional[List] = None,
) -> str:
  """Render the heightmap world along ``trajectory`` and write the dataset;
  returns ``out_dir``. ``sensor_noise``: ``apply_sensor_noise`` with a
  generator seeded per frame. ``occlusions``: ``synthetic.occlusion_boxes``
  in the world. ``blackout_windows``: (start, end) frame ranges written as
  a covered lens, all-zero RGB and all-zero (invalid) depth, so that a run
  meets the failure through its own mechanisms. Rendering is skipped when
  ``out_dir`` already holds a complete dataset of the same parameters (its
  ``.generator_stamp``)."""
  cam = camera or synthetic.default_test_camera(width, height)
  # The stamp names the trajectory's content, not only its length: two
  # trajectories of one length must not alias to one cached dataset.
  traj_hash = zlib.crc32(np.round(np.stack(trajectory), 9).tobytes())
  stamp = (f"{len(trajectory)} {traj_hash:08x} {int(cam.width)}x"
           f"{int(cam.height)} {depth_scaling} {fps} {seed} {z_distance} "
           f"{z_variation}"
           f" {float(cam.fx)},{float(cam.fy)},{float(cam.cx)},{float(cam.cy)}"
           f"{' noise' if sensor_noise else ''}"
           f"{' occlusions' if occlusions else ''}"
           f"{f' period={texture_period}' if texture_period else ''}"
           f"{f' blackout={blackout_windows}' if blackout_windows else ''}")
  stamp_path = os.path.join(out_dir, ".generator_stamp")
  if os.path.exists(stamp_path):
    with open(stamp_path) as f:
      if f.read().strip() == stamp:
        return out_dir

  boxes = synthetic.occlusion_boxes(seed, z_distance) if occlusions else None

  def images(i: int):
    T = trajectory[i]
    if any(s <= i < e for (s, e) in (blackout_windows or [])):
      return (np.zeros((cam.height, cam.width, 3), np.uint8),
              np.zeros((cam.height, cam.width), np.uint16))
    depth, inten = synthetic.render_heightmap(
        cam, T, z_distance=z_distance, z_variation=z_variation, seed=seed,
        raw_to_float_depth=1.0 / depth_scaling, boxes=boxes,
        texture_period=texture_period)
    if sensor_noise:
      rng = np.random.default_rng(1000003 * seed + i)
      depth, inten = apply_sensor_noise(depth, inten, rng)
    u8 = np.clip(np.floor(inten * 255.0 + 0.5), 0, 255).astype(np.uint8)
    return (np.stack([u8, u8, u8], axis=-1),
            np.floor(depth * depth_scaling + 0.5).astype(np.uint16))

  with concurrent.futures.ThreadPoolExecutor(
      min(synthetic.RENDER_WORKERS, os.cpu_count() or 1)) as pool:
    _write_tum(out_dir, cam, trajectory,
               pool.map(images, range(len(trajectory))), fps, quiet)
  with open(stamp_path, "w") as f:
    f.write(stamp + "\n")
  return out_dir


def write_tum_video(out_dir: str, video: RGBDVideo,
                    trajectory: List[np.ndarray], fps: float = 30.0) -> str:
  """Write an in-memory RGBDVideo (``synthetic.make_synthetic_video``'s) as
  a TUM dataset, with ``trajectory`` as groundtruth.txt; the depth PNGs
  hold the video's raw counts, so load it with ``--depth_scaling``
  1 / ``video.raw_to_float_depth``."""
  images = ((f.rgb(), f.depth_raw()) for f in video.frames)
  return _write_tum(out_dir, video.depth_camera, trajectory, images, fps,
                    quiet=True)


def _write_tum(out_dir: str, cam: PinholeCamera, trajectory, images,
               fps: float, quiet: bool) -> str:
  os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
  os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
  with open(os.path.join(out_dir, "calibration.txt"), "w") as f:
    # The file carries the center convention; the loader adds 0.5 back.
    f.write(f"{float(cam.fx)} {float(cam.fy)} "
            f"{float(cam.cx) - 0.5} {float(cam.cy) - 0.5}\n")
  assoc_lines, gt_lines = [], []
  for i, (T, (rgb, depth_u16)) in enumerate(zip(trajectory, images)):
    Image.fromarray(rgb).save(os.path.join(out_dir, f"rgb/{i:06d}.png"))
    Image.fromarray(depth_u16).save(
        os.path.join(out_dir, f"depth/{i:06d}.png"))
    if not quiet and (i + 1) % 50 == 0:
      print(f"  rendered {i + 1}/{len(trajectory)} frames", flush=True)
    ts = i / fps
    assoc_lines.append(f"{ts:.6f} rgb/{i:06d}.png {ts:.6f} depth/{i:06d}.png")
    q = se3_np.matrix_to_quaternion(T[:3, :3])
    t = T[:3, 3]
    gt_lines.append(f"{ts:.6f} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                    f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")
  with open(os.path.join(out_dir, "associated.txt"), "w") as f:
    f.write("\n".join(assoc_lines) + "\n")
  with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
    f.write("\n".join(gt_lines) + "\n")
  return out_dir


def main(argv=None) -> int:
  p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
  p.add_argument("out_dir")
  p.add_argument("--frames", type=int, default=500)
  p.add_argument("--size", default="640x480")
  p.add_argument("--trajectory", choices=["loop", "straight"], default="loop")
  p.add_argument("--radius", type=float, default=0.25)
  p.add_argument("--depth_scaling", type=float, default=5000.0)
  p.add_argument("--seed", type=int, default=5)
  p.add_argument("--noise", action="store_true",
                 help="apply the Kinect-class sensor-noise model")
  p.add_argument("--occlusions", action="store_true",
                 help="add floating occluder boxes (depth discontinuities, "
                      "occlusion shadows; synthetic.occlusion_boxes)")
  args = p.parse_args(argv)
  w, h = (int(v) for v in args.size.split("x"))
  if args.trajectory == "loop":
    traj = loop_trajectory(args.frames, radius=args.radius)
  else:
    traj = straight_trajectory(args.frames)
  write_tum_dataset(args.out_dir, traj, width=w, height=h,
                    depth_scaling=args.depth_scaling, seed=args.seed,
                    sensor_noise=args.noise, occlusions=args.occlusions)
  print(f"wrote {args.frames} frames to {args.out_dir}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
