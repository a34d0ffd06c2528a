"""Host-device transfers, and how a device loop ends.

The pipelined front-end (``slam/pipelined.py``) must never synchronize the
host with the card between its first and its last frame. Two kinds of
transfer remain on its path, and this module holds the only ways it makes
them:

  * ``to_device`` copies a host array to the device from page-locked memory
    without blocking (a plain ``torch.from_numpy(a).to(cuda)`` copies from
    pageable memory and waits for the stream);
  * ``LoopEnd`` ends a device loop whose stop condition is a device flag
    (a Gauss-Newton or conjugate-gradient loop's convergence).

Each such loop (odometry, the BA pose phase, the joint PCG) runs one body
whose state holds still once the flag is set (``torch.where(done, old,
new)``), and its ``transfer_free`` choice picks the ending here alone. The
host ending reads the flag at once, the one blocking read an iteration
makes, so the body runs only while the flag is clear and gives the plain
update. The poll ending queues a copy of the flag into page-locked memory
behind an event and stops at the first iteration at which an earlier copy
is known to have landed and says done; an event that has not completed yet
is asked again at the next iteration. The one or two iterations that run
past convergence change nothing, so both endings give the same result.

On the CPU there is nothing to wait for: ``to_device`` copies the array and
both endings read the flag at once, in ``read_flag``, the one read of a
tensor that the pipelined loop makes.

Inside ``parallel/spmd.shard_map`` the members of a collective group hold
the same flag (it comes from summed H/b or dot products), so each member
reads the same value. Under the poll they may see its copies land at
different iterations; an ending given the group's ``axis`` stops the loop
for all of them once one has seen the flag set (a host-side ``psum``), so
every member makes the same collectives.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from badslam_tpu_torch.parallel import spmd


def to_device(array, device: torch.device) -> torch.Tensor:
  """A device copy of a host array (its dtype kept). On a GPU the copy goes
  through page-locked memory and is queued on the current stream without
  the host waiting for it; the caching host allocator keeps the staging
  buffer until the copy has run."""
  host = torch.from_numpy(np.array(array, copy=True))
  if device.type != "cuda":
    return host.to(device)
  return host.pin_memory().to(device, non_blocking=True)


def read_flag(flag: torch.Tensor) -> bool:
  """The value of a 0-d bool tensor, on the host (from a GPU, the host
  waits for it)."""
  return bool(flag)


class LoopEnd:
  """How a device loop whose stop condition is a device flag ends.

  ``done(flag)`` is called once per iteration with that iteration's flag.
  With ``transfer_free`` false it reads the flag (the host ending);
  otherwise it polls copies of it without blocking and returns True once a
  copy of a set flag has been seen, by any member of the mesh group along
  ``axis`` when one is given (the poll ending). ``reads``: whether the host
  may read the device, so that a loop may read its counts once it ends."""

  def __init__(self, device: torch.device, transfer_free: bool, axis=None):
    self.reads = not transfer_free
    self._cuda = device.type == "cuda"
    self._axis = axis
    self._pending: List[Tuple[torch.cuda.Event, torch.Tensor]] = []

  def done(self, flag: torch.Tensor) -> bool:
    if self.reads:
      return read_flag(flag)
    seen = self._seen(flag)
    if self._axis is not None:
      seen = spmd.psum(int(seen), self._axis) > 0
    return seen

  def _seen(self, flag: torch.Tensor) -> bool:
    if not self._cuda:
      return read_flag(flag)
    staged = torch.empty((), dtype=torch.bool, pin_memory=True)
    staged.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    self._pending.append((event, staged))
    seen = False
    while self._pending and self._pending[0][0].query():
      _, landed = self._pending.pop(0)
      seen = seen or bool(landed)
    return seen
