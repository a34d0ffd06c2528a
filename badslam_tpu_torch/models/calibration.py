"""The carried depth calibration: what preprocessing and odometry read.

In the reference these are fields of ``DirectBA`` (``slam/direct_ba.py``:
``depth_intr``, ``a``, ``cfactor``, ``baseline_fx``, ``cell_size``,
``depth_size``; ``make_camera`` builds the depth camera from them).
Self-calibration updates them while the system runs, so they live on the
device as buffers of one module that the front-end and the back-end share,
and consumers read them through tensors, never as host floats. They are
written in place only (``copy_``): a camera made of views of ``depth_intr``,
and the preprocess kernel, which reads the buffers through their pointers at
every launch, then see the new values without being told.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.ops.depth_model import cfactor_shape


class DepthCalibration(nn.Module):
  """Depth intrinsics (fx, fy, cx, cy; corner convention), the global
  deformation ``a``, the per-cell ``cfactor`` grid and ``baseline_fx``."""

  depth_intr: torch.Tensor   # (4,)
  a: torch.Tensor            # ()
  cfactor: torch.Tensor      # (hc, wc)
  baseline_fx: torch.Tensor  # ()

  def __init__(self, depth_intr: torch.Tensor, a: torch.Tensor,
               cfactor: torch.Tensor, baseline_fx: torch.Tensor,
               cell_size: int, depth_size: Tuple[int, int]):
    super().__init__()
    width, height = depth_size
    if tuple(cfactor.shape) != cfactor_shape(height, width, cell_size):
      raise ValueError(
          f"cfactor shape {tuple(cfactor.shape)} does not match "
          f"{cfactor_shape(height, width, cell_size)} for a {width}x{height}"
          f" image with cell size {cell_size}")
    self.register_buffer("depth_intr", depth_intr.to(torch.float32))
    self.register_buffer("a", a.to(torch.float32).reshape(()))
    self.register_buffer("cfactor", cfactor.to(torch.float32))
    self.register_buffer("baseline_fx",
                         baseline_fx.to(torch.float32).reshape(()))
    self.cell_size = int(cell_size)
    self.depth_size = (int(width), int(height))

  @classmethod
  def from_numpy(cls, depth_intr, a, cfactor, baseline_fx, cell_size: int,
                 depth_size: Tuple[int, int],
                 device) -> "DepthCalibration":
    """From host arrays, e.g. the reference's ``DirectBA`` state
    (``np.asarray(ba.depth_intr)``, ``ba.a``, ``ba.cfactor``,
    ``ba.baseline_fx``), on ``device``: the caller always names it."""
    def t(v):
      return torch.from_numpy(np.array(v, np.float32)).to(device)
    return cls(t(depth_intr), t(a), t(cfactor), t(baseline_fx), cell_size,
               depth_size)

  @classmethod
  def initial(cls, camera: PinholeCamera, cell_size: int,
              depth_deformation_a: float, baseline_fx: float,
              device) -> "DepthCalibration":
    """The state a new map starts from (DirectBA.__init__): the camera's
    intrinsics, zero cfactor."""
    hc, wc = cfactor_shape(camera.height, camera.width, cell_size)
    intr = [float(camera.fx), float(camera.fy), float(camera.cx),
            float(camera.cy)]
    return cls.from_numpy(intr, depth_deformation_a,
                          np.zeros((hc, wc), np.float32), baseline_fx,
                          cell_size, (camera.width, camera.height), device)

  def clone(self) -> "DepthCalibration":
    """An independent copy on the same device."""
    return DepthCalibration(
        self.depth_intr.clone(), self.a.clone(), self.cfactor.clone(),
        self.baseline_fx.clone(), self.cell_size, self.depth_size)

  def camera(self) -> PinholeCamera:
    """The depth camera, with intrinsics as 0-d views of ``depth_intr``."""
    w, h = self.depth_size
    i = self.depth_intr
    return PinholeCamera(w, h, i[0], i[1], i[2], i[3])
