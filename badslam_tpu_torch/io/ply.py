"""Point-cloud export: binary little-endian PLY.

The writer ``badslam_tpu/io/state.py`` uses for ``--export_point_cloud``,
and a reader for files it wrote.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def _layout(normals: bool, colors: bool):
  fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
  props = ["property float x", "property float y", "property float z"]
  if normals:
    fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    props += ["property float nx", "property float ny", "property float nz"]
  if colors:
    fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    props += ["property uchar red", "property uchar green",
              "property uchar blue"]
  return fields, props


def save_point_cloud_ply(path: str, positions: np.ndarray,
                         normals: Optional[np.ndarray] = None,
                         colors: Optional[np.ndarray] = None) -> None:
  """Positions (M, 3), optional normals (M, 3) and u8 RGB colors (M, 3)."""
  n = len(positions)
  fields, props = _layout(normals is not None, colors is not None)
  header = "\n".join([
      "ply", "format binary_little_endian 1.0",
      f"element vertex {n}", *props, "end_header", ""])
  rec = np.zeros(n, dtype=fields)
  rec["x"], rec["y"], rec["z"] = positions.T.astype(np.float32)
  if normals is not None:
    rec["nx"], rec["ny"], rec["nz"] = normals.T.astype(np.float32)
  if colors is not None:
    rec["red"], rec["green"], rec["blue"] = colors.T.astype(np.uint8)
  with open(path, "wb") as f:
    f.write(header.encode("ascii"))
    rec.tofile(f)


def load_point_cloud_ply(path: str):
  """(positions, normals or None, colors or None) of a file written by
  ``save_point_cloud_ply``."""
  with open(path, "rb") as f:
    header = b""
    while not header.endswith(b"end_header\n"):
      line = f.readline()
      if not line:
        raise ValueError(f"{path}: no end_header")
      header += line
    lines = header.decode("ascii").splitlines()
    n = next(int(l.split()[-1]) for l in lines
             if l.startswith("element vertex"))
    names = [l.split()[-1] for l in lines if l.startswith("property")]
    fields, _ = _layout("nx" in names, "red" in names)
    rec = np.fromfile(f, dtype=fields, count=n)
  pos = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1)
  nrm = (np.stack([rec["nx"], rec["ny"], rec["nz"]], axis=-1)
         if "nx" in names else None)
  col = (np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1)
         if "red" in names else None)
  return pos, nrm, col
