"""Timer / Timing statistics registry.

Port of ``badslam_tpu/utils/timing.py`` (libvis Timing: tag -> count /
total / mean / min / max, exported by ``--export_final_timings``).

CUDA work is asynchronous, so ``Timing.time(...)`` measures the host wall
time of the block. With ``Timing.set_device_accurate(True)`` (CLI
``--device_accurate_timings``) every timed scope opens and closes with
``torch.cuda.synchronize()``, so its span covers exactly that phase's
device work. The synchronizations cost a host-device round trip each.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch


class _Stat:
  __slots__ = ("count", "total", "min", "max", "last", "samples")

  def __init__(self):
    self.count = 0
    self.total = 0.0
    self.min = float("inf")
    self.max = 0.0
    self.last = 0.0
    self.samples: List[float] = []

  def add(self, seconds: float):
    self.count += 1
    self.total += seconds
    self.min = min(self.min, seconds)
    self.max = max(self.max, seconds)
    self.last = seconds
    self.samples.append(seconds)

  @property
  def mean(self) -> float:
    return self.total / self.count if self.count else 0.0


class Timing:
  """Global tag -> statistics registry."""

  _stats: Dict[str, _Stat] = {}
  _lock = threading.Lock()
  _device_accurate: bool = False

  @classmethod
  def set_device_accurate(cls, on: bool):
    cls._device_accurate = on

  @classmethod
  def device_barrier(cls):
    if cls._device_accurate and torch.cuda.is_available():
      torch.cuda.synchronize()

  @classmethod
  def add_time(cls, tag: str, seconds: float):
    with cls._lock:
      cls._stats.setdefault(tag, _Stat()).add(seconds)

  @classmethod
  @contextlib.contextmanager
  def time(cls, tag: str):
    cls.device_barrier()  # earlier work must not bill to this phase
    start = time.perf_counter()
    try:
      yield
    finally:
      cls.device_barrier()  # this phase's queued work completes here
      cls.add_time(tag, time.perf_counter() - start)

  @classmethod
  def reset(cls):
    with cls._lock:
      cls._stats.clear()

  @classmethod
  def stats(cls) -> Dict[str, _Stat]:
    with cls._lock:
      return dict(cls._stats)

  @classmethod
  def print_timings(cls, sort_by_total: bool = True) -> str:
    """Report sorted by total time (libvis kSortByTotal)."""
    with cls._lock:
      items = sorted(
          cls._stats.items(),
          key=(lambda kv: -kv[1].total) if sort_by_total
          else (lambda kv: kv[0]))
    lines = ["Timing statistics (seconds):"]
    for tag, s in items:
      lines.append(
          f"  {tag:<42s} count {s.count:>6d}  total {s.total:>9.3f}"
          f"  mean {s.mean * 1e3:>8.2f}ms  min {s.min * 1e3:>8.2f}ms"
          f"  max {s.max * 1e3:>8.2f}ms")
    return "\n".join(lines)

  @classmethod
  def export_file(cls, path: str):
    """--export_final_timings."""
    with open(path, "w") as f:
      f.write(cls.print_timings() + "\n")
