"""Timer / Timing statistics registry: spans and counters by tag.

Port of ``badslam_tpu/utils/timing.py`` (libvis Timing: tag -> count /
total / mean / min / max, exported by ``--export_final_timings``), from any
thread.

A span, ``with Timing.time(tag):``, records per block:

  * the host wall time under ``tag``;
  * the calling thread's CPU time (``time.thread_time``) under
    ``"<tag> [cpu]"``, added together with the wall sample, so that the two
    tags keep the same sample count. Wall minus CPU is the time the thread
    was not on a core: waiting for the interpreter lock, a lock or
    condition of the program, or the OS (CUDA's spin wait for the device
    counts as CPU);
  * while a ``torch.profiler`` session runs, a profiler range named
    ``tag`` around the block, on the calling thread, so that a trace shows
    the program's phases on the kernels' clock. The range is an op of the
    host's timeline (``_RecordFunctionFast``), not a user annotation such
    as ``torch.profiler.record_function`` makes, which the profiler copies
    onto the device's timeline as if it were device work. With no session
    running none is built.

A counter, ``Timing.count(tag, n)``, records one sample of ``n``, a value
the host already knows. A tag is a span or a counter, never both.

CUDA work is asynchronous, so a span measures the host's time of the
block. With ``Timing.set_device_accurate(True)`` (CLI
``--device_accurate_timings``) every span opens and closes by waiting for
the calling thread's current CUDA stream, so that it covers that phase's
work on that stream: under parallel BA the frame's phases (on the main
thread's stream) and the BA thread's iterations (on its own stream) are
each timed without waiting for the other thread's work, although the two
share the device while both run. The waits cost a host-device round trip
each.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as autograd_profiler

CPU_SUFFIX = " [cpu]"


class _Stat:
  __slots__ = ("count", "total", "min", "max", "samples", "counter")

  def __init__(self, counter: bool):
    self.count = 0
    self.total = 0.0
    self.min = float("inf")
    self.max = 0.0
    self.samples: List[float] = []
    self.counter = counter   # samples are counts, not seconds

  def add(self, value: float):
    self.count += 1
    self.total += value
    self.min = min(self.min, value)
    self.max = max(self.max, value)
    self.samples.append(value)

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
    """Wait for the work queued so far on the calling thread's current
    stream (only that stream: the other thread's work is not this phase's).
    """
    if cls._device_accurate and torch.cuda.is_available():
      torch.cuda.current_stream().synchronize()

  @classmethod
  def _stat_locked(cls, tag: str, counter: bool) -> _Stat:
    s = cls._stats.get(tag)
    if s is None:
      s = cls._stats[tag] = _Stat(counter)
    elif s.counter != counter:
      raise ValueError(f"Timing tag {tag!r} is a "
                       f"{'counter' if s.counter else 'span'}, not a "
                       f"{'counter' if counter else 'span'}")
    return s

  @classmethod
  def add_time(cls, tag: str, seconds: float):
    with cls._lock:
      cls._stat_locked(tag, False).add(seconds)

  @classmethod
  def count(cls, tag: str, n: int = 1):
    """One sample of ``n`` under the counter ``tag``."""
    with cls._lock:
      cls._stat_locked(tag, True).add(n)

  @classmethod
  @contextlib.contextmanager
  def time(cls, tag: str):
    cls.device_barrier()  # earlier work must not bill to this phase
    # The Python flag, not torch._C._autograd._profiler_enabled(): that one
    # reads the calling thread's state, which a session that profiles all
    # threads leaves unset.
    span = (_RecordFunctionFast(tag)
            if autograd_profiler._is_profiler_enabled else None)
    if span is not None:
      span.__enter__()
    start, cpu_start = time.perf_counter(), time.thread_time()
    try:
      yield
    finally:
      cls.device_barrier()  # this phase's queued work completes here
      wall = time.perf_counter() - start
      cpu = time.thread_time() - cpu_start
      if span is not None:
        span.__exit__(None, None, None)
      with cls._lock:
        cls._stat_locked(tag, False).add(wall)
        cls._stat_locked(tag + CPU_SUFFIX, False).add(cpu)

  @classmethod
  @contextlib.contextmanager
  def isolated(cls):
    """Record the block's spans into a registry of their own, which the
    block gets, and put the earlier statistics back after it
    (``BadSlam.prewarm``: its warm frames are not the run's)."""
    with cls._lock:
      saved, cls._stats = cls._stats, {}
      block_stats = cls._stats
    try:
      yield block_stats
    finally:
      with cls._lock:
        cls._stats = saved

  @classmethod
  def reset(cls):
    with cls._lock:
      cls._stats.clear()

  @classmethod
  def stats(cls) -> Dict[str, _Stat]:
    with cls._lock:
      return dict(cls._stats)

  @classmethod
  def print_timings(cls) -> str:
    """Report sorted by total (libvis kSortByTotal): spans in seconds with
    their mean thread CPU time last on the line, counters as counts."""
    stats = cls.stats()
    spans = sorted(((t, s) for t, s in stats.items() if not s.counter),
                   key=lambda kv: -kv[1].total)
    counters = sorted(((t, s) for t, s in stats.items() if s.counter),
                      key=lambda kv: -kv[1].total)
    lines = ["Timing statistics (seconds):"]
    for tag, s in spans:
      if tag.endswith(CPU_SUFFIX) and tag[:-len(CPU_SUFFIX)] in stats:
        continue   # shown on its span's line
      cpu = stats.get(tag + CPU_SUFFIX)
      line = (f"  {tag:<42s} count {s.count:>6d}  total {s.total:>9.3f}"
              f"  mean {s.mean * 1e3:>8.2f}ms  min {s.min * 1e3:>8.2f}ms"
              f"  max {s.max * 1e3:>8.2f}ms")
      if cpu is not None:
        line += f"  cpu {cpu.mean * 1e3:>8.2f}ms"
      lines.append(line)
    if counters:
      lines.append("Counters:")
    for tag, s in counters:
      lines.append(
          f"  {tag:<42s} count {s.count:>6d}  total {s.total:>9g}"
          f"  mean {s.mean:>8.2f}  min {s.min:>8g}  max {s.max:>8g}")
    return "\n".join(lines)

  @classmethod
  def export_file(cls, path: str):
    """--export_final_timings."""
    with open(path, "w") as f:
      f.write(cls.print_timings() + "\n")
