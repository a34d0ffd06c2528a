"""Headless surfel splat renderer.

Port of ``badslam_tpu/render.py``. The original's OpenGL surfel viewer draws
every surfel as a depth-tested screen-space square of half-extent
``splat_half_extent_in_pixels`` (default 3.0, main.cc:285-287; geometry
shader render_window.cc:1363-1385), with display colors from
kernel_update_visualization.cu:40-100 (color, descriptor and activation
modes; normals at :75-79).

Here the z-buffer is a scatter over linearized pixel ids: per chunk of
surfels, the nearest depth of every pixel (``scatter_reduce`` "amin" into an
inf-filled buffer), then the largest surfel index among the surfels at that
depth ("amax" into a -1-filled buffer), so a tie inside a chunk goes to the
larger index whatever order the device runs the scatter in. The chunks
merge into the running z-buffer by a strict ``<``, so across chunks the
earlier chunk keeps a tied pixel. Chunking bounds the memory of the
(surfels x footprint) expansion: one chunk of 65,536 surfels at the default
half-extent is 65,536 x 81 taps.

``main.py --render_preview`` writes keyframe-viewpoint previews with it, and
``snapshot_inspector.py`` renders saved states.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import numpy as np
import torch
from PIL import Image

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models.surfels import SurfelStore

_RENDER_CHUNK = 1 << 16


def render_surfel_splats(
    pos: torch.Tensor,             # (N, 3) global surfel positions
    colors: torch.Tensor,          # (N, 3) float in [0, 1]
    valid: torch.Tensor,           # (N,) bool
    frame_T_global: torch.Tensor,  # (4, 4) camera-from-global
    intr: torch.Tensor,            # (4,) fx, fy, cx, cy (corner convention)
    height: int,
    width: int,
    splat_half_extent_in_pixels: float = 3.0,
    max_depth: float = math.inf,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
  """Rasterize surfels into (depth (H, W) f32, color (H, W, 3) f32, hit
  (H, W) bool) on the tensors' device.

  A surfel covers every pixel whose center lies within the screen-space
  square of half-extent ``splat_half_extent_in_pixels`` around its projected
  position (the splat shader's quad); the nearest covering surfel wins each
  pixel (the GL depth test). Surfels that are invalid, not in front of the
  camera or beyond ``max_depth`` draw nothing."""
  dev = pos.device
  h_ext = float(splat_half_extent_in_pixels)
  # Pixel px is covered iff |px + 0.5 - x| <= h, so within h + 0.5 index
  # units of floor(x) at worst.
  r = max(0, int(math.ceil(h_ext + 0.5)))
  offs = torch.arange(-r, r + 1, device=dev)
  f = 2 * r + 1
  n = pos.shape[0]
  n_pix = height * width
  zbuf = torch.full((n_pix,), math.inf, dtype=torch.float32, device=dev)
  ibuf = torch.full((n_pix,), -1, dtype=torch.int64, device=dev)

  fx, fy, cx, cy = intr[0], intr[1], intr[2], intr[3]
  # A projection farther out than this misses the image with every tap; the
  # clamp keeps the cast to an integer in range (a surfel just in front of
  # the camera projects to ~1e10, where x86 and CUDA cast differently).
  bound_x = float(width + 2 * r + 2)
  bound_y = float(height + 2 * r + 2)
  for start in range(0, n, _RENDER_CHUNK):
    p = pos[start:start + _RENDER_CHUNK]
    c = p.shape[0]
    local = se3.transform_points(frame_T_global, p)
    z = local[:, 2]
    ok = valid[start:start + c] & (z > 0.0) & (z <= max_depth)
    zs = torch.where(ok, z, 1.0)
    px = fx * local[:, 0] / zs + cx
    py = fy * local[:, 1] / zs + cy

    # The footprint: the pixel that holds the projected point and its
    # (2r+1)^2 neighbourhood, gated by the splat square around (px, py).
    bx = torch.floor(px.clamp(-bound_x, bound_x)).to(torch.int64)
    by = torch.floor(py.clamp(-bound_y, bound_y)).to(torch.int64)
    gx = bx[:, None] + offs[None, :]                      # (C, F)
    gy = by[:, None] + offs[None, :]
    cov_x = torch.abs(gx.to(torch.float32) + 0.5 - px[:, None]) <= h_ext
    cov_y = torch.abs(gy.to(torch.float32) + 0.5 - py[:, None]) <= h_ext
    in_x = (gx >= 0) & (gx < width)
    in_y = (gy >= 0) & (gy < height)
    cover = ((cov_x & in_x)[:, None, :] & (cov_y & in_y)[:, :, None]
             & ok[:, None, None])                          # (C, F, F)
    pix = gy[:, :, None] * width + gx[:, None, :]          # (C, F, F)
    pix = torch.where(cover, pix, n_pix).reshape(-1)       # dropped: n_pix

    z_e = z[:, None, None].expand(c, f, f).reshape(-1)
    i_e = torch.arange(start, start + c, device=dev)[:, None, None].expand(
        c, f, f).reshape(-1)
    zmin = torch.full((n_pix + 1,), math.inf, dtype=torch.float32,
                      device=dev).scatter_reduce_(0, pix, z_e, "amin")
    winner = (z_e == zmin[pix]) & (pix < n_pix)
    iwin = torch.full((n_pix + 1,), -1, dtype=torch.int64,
                      device=dev).scatter_reduce_(
                          0, pix, torch.where(winner, i_e, -1), "amax")
    zmin, iwin = zmin[:n_pix], iwin[:n_pix]

    better = zmin < zbuf
    zbuf = torch.where(better, zmin, zbuf)
    ibuf = torch.where(better, iwin, ibuf)

  hit = ibuf >= 0
  depth = torch.where(hit, zbuf, 0.0).reshape(height, width)
  color = torch.where(hit[:, None], colors[ibuf.clamp(min=0)], 0.0).reshape(
      height, width, 3)
  return depth, color, hit.reshape(height, width)


def surfel_display_colors(s: SurfelStore, mode: str = "color"
                          ) -> torch.Tensor:
  """Per-surfel (N, 3) display colors in [0, 1], as
  kernel_update_visualization.cu fills them: "color" the stored RGB (:99);
  "descriptors" (0.5 d1 + 0.5, 0.5 d2 + 0.5, 0.5) with the descriptors
  scaled from their [-180, 180] range (:67-72); "normals" 0.5 (n + 1)
  (:75-79); "activation" red for active and grey for inactive surfels (the
  GUI's activation coloring; its exact colors are a style choice)."""
  if mode == "color":
    return s.color
  if mode == "descriptors":
    # A true division: a division by a Python number becomes a product with
    # its reciprocal on CUDA.
    scale = torch.full((), 180.0, dtype=torch.float32, device=s.desc.device)
    d = torch.clamp(s.desc / scale, -1.0, 1.0)
    return torch.stack([0.5 * d[:, 0] + 0.5, 0.5 * d[:, 1] + 0.5,
                        torch.full_like(d[:, 0], 0.5)], dim=-1)
  if mode == "normals":
    return 0.5 * (s.normal + 1.0)
  if mode == "activation":
    act = s.active[:, None].to(torch.float32)
    red = torch.tensor([0.9, 0.2, 0.2], device=act.device)
    gray = torch.tensor([0.6, 0.6, 0.6], device=act.device)
    return act * red + (1.0 - act) * gray
  raise ValueError(f"unknown render mode: {mode}")


def color_to_u8(color: torch.Tensor) -> np.ndarray:
  """(H, W, 3) float colors in [0, 1] as host u8, by truncation."""
  return np.clip(color.cpu().numpy() * 255.0, 0, 255).astype(np.uint8)


def render_map(ba, frame_T_global, mode: str = "color",
               splat_half_extent_in_pixels: float = 3.0,
               resolution: Optional[Tuple[int, int]] = None,
               max_depth: float = math.inf,
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
  """Render a DirectBA's surfel map from a camera pose (camera-from-global,
  (4, 4)). Returns host arrays: depth (H, W) f32 metres, color (H, W, 3)
  u8, hit (H, W) bool. The color camera's intrinsics, unless
  ``resolution`` (height, width) overrides its size: then they scale by
  width and height apart, so that a target of another aspect keeps the
  whole field of view on both axes."""
  dev = ba.device
  if resolution is not None:
    height, width = resolution
    sx = width / ba.color_size[0]
    sy = height / ba.color_size[1]
    # Scaled in float64 on the host, then rounded once, as the reference.
    fx, fy, cx, cy = ba.color_intr.cpu().numpy().astype(np.float64)
    intr = torch.tensor([fx * sx, fy * sy, cx * sx, cy * sy],
                        dtype=torch.float32).to(dev)
  else:
    width, height = ba.color_size
    intr = ba.color_intr
  surfels = ba.surfels  # under a mesh, one gather of the sharded store
  colors = surfel_display_colors(surfels, mode)
  T = torch.as_tensor(frame_T_global, dtype=torch.float32).to(dev)
  depth, color, hit = render_surfel_splats(
      surfels.pos, colors, surfels.valid, T, intr, height, width,
      splat_half_extent_in_pixels, max_depth)
  return depth.cpu().numpy(), color_to_u8(color), hit.cpu().numpy()


def save_preview_png(path: str, color_u8: np.ndarray) -> None:
  Image.fromarray(color_u8).save(path)


def save_depth_png(path: str, depth_m: np.ndarray,
                   scale: float = 5000.0) -> None:
  """TUM-convention u16 depth PNG (metres x 5000 by truncation, 0 where no
  surfel was hit)."""
  raw = np.clip(depth_m * scale, 0, 65535).astype(np.uint16)
  Image.fromarray(raw).save(path)


def render_keyframe_previews(slam, out_dir: str, mode: str = "color",
                             splat_half_extent_in_pixels: float = 3.0,
                             every: int = 1, quiet: bool = True) -> int:
  """Render the map from every ``every``-th keyframe slot's viewpoint into
  ``out_dir`` as kf_<frame>_color.png and kf_<frame>_depth.png; returns
  the number of viewpoints rendered (the headless stand-in for the GUI's
  map view following the trajectory). In color mode the surfels' colors
  are refreshed from the keyframes first."""
  os.makedirs(out_dir, exist_ok=True)
  ba = slam.direct_ba
  if mode == "color" and ba.keyframe_count > 0:
    ba.assign_colors()
  kf = ba.kf
  valid = kf.valid.cpu().numpy()
  frame_idx = kf.frame_index.cpu().numpy()
  rendered = 0
  for k in range(int(kf.count)):
    if not valid[k] or k % max(1, every) != 0:
      continue
    f_T_g = se3.inverse(kf.global_T_frame[k])
    depth, color_u8, _ = render_map(
        ba, f_T_g, mode=mode,
        splat_half_extent_in_pixels=splat_half_extent_in_pixels)
    stem = os.path.join(out_dir, f"kf_{int(frame_idx[k]):06d}")
    save_preview_png(stem + "_color.png", color_u8)
    save_depth_png(stem + "_depth.png", depth)
    rendered += 1
    if not quiet:
      print(f"rendered {stem}")
  return rendered
