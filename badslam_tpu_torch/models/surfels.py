"""The surfel map: a fixed-capacity structure of arrays with a validity mask.

Port of ``badslam_tpu/models/surfels.py``. Attributes are separate tensors
of shape (N,) / (N, C) with capacity N and a boolean ``valid`` mask;
deletion and merging clear mask bits, ``compact`` re-packs. Capacity grows
by doubling from ``config.initial_surfel_capacity``.

The store is a NamedTuple and every function returns a new store: a field
that changes is a new tensor, a field that does not is shared with the old
store. A caller may therefore keep ``store.valid`` across an update (BA
does, to find the surfels an update created), and the identity of a field
tells whether it changed.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch


class SurfelStore(NamedTuple):
  """All per-surfel state. Leading dimension = capacity."""

  pos: torch.Tensor        # (N, 3) float32, global position
  normal: torch.Tensor     # (N, 3) float32, global unit normal
  radius_sq: torch.Tensor  # (N,) float32
  color: torch.Tensor      # (N, 3) float32 in [0, 1] (export only)
  desc: torch.Tensor       # (N, 2) float32 descriptor, within [-180, 180]
  valid: torch.Tensor      # (N,) bool
  active: torch.Tensor     # (N,) bool, the geometry optimization's set
  # () int32, the allocation watermark: slots [0, count) have been used and
  # append() writes at count. Deletion and merging clear ``valid`` bits
  # without lowering count (or append would overwrite live surfels);
  # compact() re-packs live surfels and resets count to their number.
  count: torch.Tensor

  @property
  def capacity(self) -> int:
    return self.pos.shape[0]

  @property
  def device(self) -> torch.device:
    return self.pos.device


_FIELDS = (("pos", (3,), torch.float32), ("normal", (3,), torch.float32),
           ("radius_sq", (), torch.float32), ("color", (3,), torch.float32),
           ("desc", (2,), torch.float32), ("valid", (), torch.bool),
           ("active", (), torch.bool))


def create(capacity: int, device) -> SurfelStore:
  fields = {name: torch.zeros((capacity,) + tail, dtype=dtype, device=device)
            for name, tail, dtype in _FIELDS}
  return SurfelStore(count=torch.zeros((), dtype=torch.int32, device=device),
                     **fields)


def from_numpy(arrays: Dict[str, np.ndarray], device) -> SurfelStore:
  """From host arrays named like the fields (e.g. the reference store's
  ``_asdict()`` through ``np.asarray``); dtypes are kept."""
  fields = {}
  for name, tail, dtype in _FIELDS:
    t = torch.from_numpy(np.array(arrays[name])).to(device)
    if t.dtype != dtype or tuple(t.shape[1:]) != tail:
      raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, expected "
                       f"{dtype} (N,{','.join(map(str, tail))})")
    fields[name] = t
  count = torch.from_numpy(np.array(arrays["count"], np.int32)).to(
      device).reshape(())
  return SurfelStore(count=count, **fields)


def to_numpy(s: SurfelStore) -> Dict[str, np.ndarray]:
  return {name: getattr(s, name).cpu().numpy() for name in s._fields}


def grow(s: SurfelStore, new_capacity: int) -> SurfelStore:
  """Re-allocate with a larger capacity; new slots are zero (invalid)."""
  pad = new_capacity - s.capacity
  assert pad >= 0

  def _pad(x):
    return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])], dim=0)

  return SurfelStore(count=s.count,
                     **{name: _pad(getattr(s, name)) for name, _, _ in _FIELDS})


def compact(s: SurfelStore) -> SurfelStore:
  """Move live surfels to the front, in their order
  (CompactSurfelsCUDAKernel semantics, as a stable sort on the invalid
  flag)."""
  order = torch.sort((~s.valid).to(torch.int32), stable=True).indices
  return SurfelStore(
      count=torch.sum(s.valid).to(torch.int32),
      **{name: getattr(s, name)[order] for name, _, _ in _FIELDS})


def used_size(s: SurfelStore) -> torch.Tensor:
  """Number of live surfels."""
  return torch.sum(s.valid).to(torch.int32)


def append(s: SurfelStore, new_pos, new_normal, new_radius_sq, new_color,
           new_desc, new_mask) -> SurfelStore:
  """Append a block of candidate surfels: candidates with new_mask=True go
  to slots [count, count + k) in their order, valid and active. Candidates
  that would overflow the capacity are dropped (the original logs "surfel
  count reached maximum", kernel_create_surfels.cc:162-165).

  The selected candidates are gathered with the mask before they are
  written (an out-of-range index is an error in PyTorch, not a dropped
  write), which reads their number back to the host."""
  capacity = s.capacity
  as_int = new_mask.to(torch.int32)
  dest = s.count + (torch.cumsum(as_int, dim=0) - as_int)
  write = new_mask & (dest < capacity)
  dest = dest[write].to(torch.int64)
  new_count = torch.clamp(s.count + torch.sum(as_int), max=capacity
                          ).to(torch.int32)

  def put(old, new):
    out = old.clone()
    out[dest] = new[write] if isinstance(new, torch.Tensor) else new
    return out

  return SurfelStore(
      pos=put(s.pos, new_pos),
      normal=put(s.normal, new_normal),
      radius_sq=put(s.radius_sq, new_radius_sq),
      color=put(s.color, new_color),
      desc=put(s.desc, new_desc),
      valid=put(s.valid, True),
      active=put(s.active, True),
      count=new_count,
  )
