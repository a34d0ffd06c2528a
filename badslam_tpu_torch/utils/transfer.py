"""Host-device transfers that do not make the host wait for the device.

The pipelined front-end (``slam/pipelined.py``) must never synchronize the
host with the card between its first and its last frame. Two kinds of
transfer remain on its path, and this module holds the only ways it makes
them:

  * ``to_device`` copies a host array to the device from page-locked memory
    without blocking (a plain ``torch.from_numpy(a).to(cuda)`` copies from
    pageable memory and waits for the stream);
  * ``DonePoll`` ends a device loop whose stop condition is a device flag
    (a Gauss-Newton loop's convergence): each iteration queues a copy of the
    flag into page-locked memory behind an event, and the loop stops at the
    first iteration at which an earlier copy is known to have landed and
    says done. The host never waits: an event that has not completed yet is
    asked again at the next iteration. The loop's state must hold still
    once the flag is set (``torch.where(done, old, new)``), so the one or
    two iterations that run past convergence change nothing, and the result
    equals a loop that stops at once.

On the CPU there is nothing to wait for: ``to_device`` copies the array and
``DonePoll`` reads the flag at once, in ``read_flag``, the one read of a
tensor that the pipelined loop makes.

Inside ``parallel/spmd.shard_map`` the members of a collective group hold
the same flag but may see its copies land at different iterations; a poll
given the group's ``axis`` ends the loop for all of them once one has seen
the flag set (a host-side ``psum``), so every member makes the same
collectives.
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
  """The value of a 0-d bool tensor on the CPU."""
  return bool(flag)


class DonePoll:
  """Asks, without blocking, whether a device loop's done flag was set.

  ``done(flag)`` is called once per iteration with that iteration's flag;
  it returns True once a copy of a set flag has been seen (by a member of
  the mesh group along ``axis``, when one is given)."""

  def __init__(self, device: torch.device, axis=None):
    self._cuda = device.type == "cuda"
    self._axis = axis
    self._pending: List[Tuple[torch.cuda.Event, torch.Tensor]] = []

  def done(self, flag: torch.Tensor) -> bool:
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
