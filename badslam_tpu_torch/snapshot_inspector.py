"""State-snapshot inspector: summarize, render and export a saved SLAM state.

Port of ``badslam_tpu/snapshot_inspector.py``, the headless counterpart of
the original GUI's inspection surfaces (the main window's status displays,
gui_main_window.h:98-160; the keyframe dialog; the render window's map
view). It works on a ``--save_state`` snapshot of either package
(``io/state.py``), with no dataset and no SLAM run:

  python -m badslam_tpu_torch.snapshot_inspector state.npz
  python -m badslam_tpu_torch.snapshot_inspector state.npz --render out/ \\
      [--render_mode normals] [--device cpu]
  python -m badslam_tpu_torch.snapshot_inspector state.npz \\
      --export_point_cloud map.ply --export_poses traj.txt

The summary and the exports are numpy on the host. ``--render`` renders on
``--device``: the CUDA device unless ``--device cpu`` asks otherwise; it
fails where no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.io.state import MAGIC

_ACTIVATION_NAMES = {0: "active", 1: "covisible-active", 2: "inactive"}


def summarize(npz) -> str:
  """The snapshot's summary, one fact per line: version, the configuration's
  fields that differ from the defaults, trajectory, keyframes, surfels,
  cameras, depth deformation and BA counters."""
  lines = []
  version = int(npz["version"])
  lines.append(f"badslam_tpu state snapshot v{version}")

  cfg = json.loads(str(npz["config"]))
  defaults = BadSlamConfig()
  nondefault = {k: v for k, v in cfg.items()
                if getattr(defaults, k, None) != v}
  lines.append(f"config: {len(cfg)} fields, non-default: "
               f"{json.dumps(nondefault, sort_keys=True)}")

  fp = npz["frame_poses"]
  t = fp[:, :3, 3]
  seg = np.linalg.norm(np.diff(t, axis=0), axis=1) if len(t) > 1 else [0.0]
  lines.append(
      f"trajectory: {len(fp)} frames, path length {np.sum(seg):.3f} m, "
      f"bbox {np.ptp(t, axis=0).round(3).tolist()} m")

  kf_poses = npz["kf_global_T_frame"]
  act = npz["kf_activation"]
  act_hist = {_ACTIVATION_NAMES.get(a, str(a)): int((act == a).sum())
              for a in np.unique(act)}
  covis = npz["kf_covis"]
  lines.append(
      f"keyframes: {len(kf_poses)} (activation {act_hist}); covisibility "
      f"mean degree {covis.sum(axis=1).mean():.1f}"
      if len(kf_poses) else "keyframes: 0")

  pos = npz["surfel_pos"]
  if len(pos):
    r = np.sqrt(np.maximum(npz["surfel_radius_sq"], 0.0))
    lines.append(
        f"surfels: {len(pos)}, radius median {np.median(r) * 1e3:.1f} mm, "
        f"bbox {np.ptp(pos, axis=0).round(3).tolist()} m")
  else:
    lines.append("surfels: 0")

  di = npz["depth_intr"]
  ci = npz["color_intr"]
  dw, dh = npz["depth_size"]
  cw, ch = npz["color_size"]
  lines.append(f"depth camera {dw}x{dh} fx={di[0]:.2f} fy={di[1]:.2f} "
               f"cx={di[2]:.2f} cy={di[3]:.2f}")
  lines.append(f"color camera {cw}x{ch} fx={ci[0]:.2f} fy={ci[1]:.2f} "
               f"cx={ci[2]:.2f} cy={ci[3]:.2f}")
  cf = npz["cfactor"]
  lines.append(
      f"depth deformation: a={float(npz['a']):.6f}, cfactor {cf.shape} "
      f"range [{cf.min():.5f}, {cf.max():.5f}], "
      f"baseline_fx={float(npz['baseline_fx']):.2f}")
  lines.append(
      f"BA: {int(npz['ba_iteration_count'])} iterations run, "
      f"{int(npz['num_planned_ba_iterations'])} planned pending")
  return "\n".join(lines)


def render_snapshot(npz, out_dir: str, mode: str = "color",
                    splat_half_extent_in_pixels: float = 3.0,
                    every: int = 1, device="cuda") -> int:
  """Render the snapshot's surfel map from every ``every``-th keyframe's
  viewpoint into ``out_dir`` (kf_<frame>_{color,depth}.png) on ``device``;
  returns the number of viewpoints."""
  import torch

  from badslam_tpu_torch import render
  from badslam_tpu_torch.geometry import se3
  from badslam_tpu_torch.models import surfels as surfels_mod

  dev = torch.device(device)
  os.makedirs(out_dir, exist_ok=True)
  n = len(npz["surfel_pos"])
  s = surfels_mod.create(max(n, 1), dev)
  if n:
    host = lambda name: torch.from_numpy(np.array(npz[name])).to(dev)
    s = s._replace(pos=host("surfel_pos"), normal=host("surfel_normal"),
                   radius_sq=host("surfel_radius_sq"),
                   color=host("surfel_color"), desc=host("surfel_desc"),
                   valid=torch.ones((n,), dtype=torch.bool, device=dev),
                   active=torch.ones((n,), dtype=torch.bool, device=dev),
                   count=torch.full((), n, dtype=torch.int32, device=dev))
  colors = render.surfel_display_colors(s, mode)
  cw, ch = (int(v) for v in npz["color_size"])
  intr = torch.from_numpy(np.array(npz["color_intr"], np.float32)).to(dev)

  rendered = 0
  kf_poses = npz["kf_global_T_frame"]
  kf_frames = npz["kf_frame_index"]
  for k in range(len(kf_poses)):
    if k % max(1, every) != 0:
      continue
    f_T_g = se3.inverse(torch.from_numpy(
        np.array(kf_poses[k], np.float32)).to(dev))
    depth, color, _ = render.render_surfel_splats(
        s.pos, colors, s.valid, f_T_g, intr, ch, cw,
        splat_half_extent_in_pixels)
    stem = os.path.join(out_dir, f"kf_{int(kf_frames[k]):06d}")
    render.save_preview_png(stem + "_color.png", render.color_to_u8(color))
    render.save_depth_png(stem + "_depth.png", depth.cpu().numpy())
    rendered += 1
  return rendered


def main(argv=None) -> int:
  p = argparse.ArgumentParser(
      description="Inspect a badslam_tpu state snapshot")
  p.add_argument("state", help="path to a --save_state .npz snapshot")
  p.add_argument("--render", default=None,
                 help="render keyframe-viewpoint previews into this dir")
  p.add_argument("--render_mode", default="color",
                 choices=["color", "normals", "descriptors", "activation"])
  p.add_argument("--splat_half_extent_in_pixels", type=float, default=3.0)
  p.add_argument("--render_every", type=int, default=1)
  p.add_argument("--export_point_cloud", default=None)
  p.add_argument("--export_poses", default=None,
                 help="write the snapshot's trajectory in TUM format")
  p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                 help="where --render computes; cuda fails when no CUDA "
                      "device is visible, it never falls back to the CPU")
  args = p.parse_args(argv)

  npz = np.load(args.state, allow_pickle=False)
  if str(npz["magic"]) != MAGIC:
    raise ValueError(f"{args.state}: not a badslam_tpu state snapshot")
  if args.render and args.device == "cuda":
    import torch
    if not torch.cuda.is_available():
      raise SystemExit(
          "no CUDA device is visible (torch.cuda.is_available() is False); "
          "--render runs on the GPU unless --device cpu is given")
  print(summarize(npz))

  if args.export_point_cloud:
    from badslam_tpu_torch.io.ply import save_point_cloud_ply
    col = np.clip(npz["surfel_color"] * 255.0, 0, 255).astype(np.uint8)
    save_point_cloud_ply(args.export_point_cloud, npz["surfel_pos"],
                         npz["surfel_normal"], col)
    print(f"wrote {len(col)} surfels to {args.export_point_cloud}")
  if args.export_poses:
    from badslam_tpu_torch.io.dataset import save_tum_trajectory
    save_tum_trajectory(args.export_poses,
                        npz["frame_timestamps"].tolist(),
                        list(npz["frame_poses"].astype(np.float64)))
    print(f"wrote {len(npz['frame_poses'])} poses to {args.export_poses}")
  if args.render:
    n = render_snapshot(npz, args.render, args.render_mode,
                        args.splat_half_extent_in_pixels, args.render_every,
                        args.device)
    print(f"rendered {n} keyframe previews into {args.render}")
  return 0


if __name__ == "__main__":
  raise SystemExit(main())
