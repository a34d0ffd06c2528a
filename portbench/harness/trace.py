"""The profiled sub-window: torch.profiler over a fixed run of frames, and
its reduction to launches, device-busy time, kernel times and idle gaps.

The profiler records the CPU ops of every thread (the BA and loop-detection
threads too) and, on a GPU, the kernels, copies and memsets of every
stream. The harness marks the profiled frames with one span on the main
thread; the reduction reads the raw events (``kineto_results``) without
building the profiler's event tree, which would take minutes for the
~14,000 launches of a frame. The arithmetic of launches and of the union of
device intervals is ``chip_smoke.py``'s (``profile_device``,
``sync_names``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from portbench.harness import stats

SPAN = "portbench.profiled_frames"
TOP = 10   # entries of each breakdown list
NAME_CHARS = 160   # a kernel's name in the breakdown, cut to this length


@dataclasses.dataclass
class TraceSummary:
  frames: int
  window_s: float          # the span's length
  busy_s: float            # union of device intervals inside the span
  launches: int            # cu*LaunchKernel* calls inside the span
  kernel_s: Dict[str, List[float]]   # device durations by kernel name
  device_ops: List[Tuple[str, float]]
  idle_gaps: List[Tuple[str, float]]


class Profiler:
  """Starts the profiler and the span; ``stop`` ends both."""

  def __init__(self, device):
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
      activities.append(ProfilerActivity.CUDA)
    self._prof = profile(activities=activities,
                         experimental_config=_ExperimentalConfig(
                             profile_all_threads=True))
    self._prof.start()
    self._span = torch.profiler.record_function(SPAN)
    self._span.__enter__()

  def stop(self):
    self._span.__exit__(None, None, None)
    self._prof.stop()   # waits for the device

  def summary(self, frames: int) -> Optional[TraceSummary]:
    return reduce_events(self._prof.profiler.kineto_results.events(), frames)


def _innermost(ops: List[Tuple[int, int, str]], points: List[int]
               ) -> List[str]:
  """For each of the sorted ``points``, the name of the innermost op of
  ``ops`` ((start, end, name) of one thread, so nested) that covers it,
  or "(python)" where none does."""
  ops = sorted(ops, key=lambda o: (o[0], -o[1]))
  out, stack, k = [], [], 0
  for p in points:
    while k < len(ops) and ops[k][0] <= p:
      while stack and stack[-1][1] < ops[k][0]:
        stack.pop()
      stack.append(ops[k])
      k += 1
    while stack and stack[-1][1] < p:
      stack.pop()
    out.append(stack[-1][2] if stack else "(python)")
  return out


def reduce_events(events, frames: int) -> Optional[TraceSummary]:
  """The summary of raw profiler events (objects with ``name()``,
  ``device_type()``, ``start_ns()``, ``end_ns()``, ``start_thread_id()``)
  inside the span ``SPAN``; None where the span is missing."""
  from torch.autograd import DeviceType
  events = list(events)
  spans = [e for e in events
           if e.name() == SPAN and e.device_type() == DeviceType.CPU]
  if len(spans) != 1:
    return None
  t0, t1 = spans[0].start_ns(), spans[0].end_ns()
  main_tid = spans[0].start_thread_id()
  device, host, launches = [], [], 0
  kernel_s: Dict[str, List[float]] = {}
  for e in events:
    name = e.name()
    if name == SPAN:
      continue
    s, en = e.start_ns(), e.end_ns()
    if e.device_type() == DeviceType.CUDA:
      if en <= t0 or s >= t1:
        continue
      s, en = max(s, t0), min(en, t1)
      device.append((s, en))
      kernel_s.setdefault(name, []).append((en - s) * 1e-9)
    elif t0 <= s <= t1:
      if name.startswith("cu") and "LaunchKernel" in name:
        launches += 1
      elif e.start_thread_id() == main_tid:
        host.append((s, en, name))
  busy = stats.merge(device)
  gaps, last = [], t0
  for s, e in busy + [[t1, t1]]:
    if s > last:
      gaps.append((last, s))
    last = max(last, e)
  names = _innermost(host, [(a + b) // 2 for a, b in gaps])
  idle: Dict[str, float] = {}
  for (a, b), name in zip(gaps, names):
    idle[name] = idle.get(name, 0.0) + (b - a) * 1e-9
  totals: Dict[str, float] = {}
  for k, v in kernel_s.items():
    totals[k[:NAME_CHARS]] = totals.get(k[:NAME_CHARS], 0.0) + sum(v)
  top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:TOP]
  return TraceSummary(
      frames=frames, window_s=(t1 - t0) * 1e-9,
      busy_s=sum(e - s for s, e in busy) * 1e-9, launches=launches,
      kernel_s=kernel_s, device_ops=top(totals), idle_gaps=top(idle))


def kernel_durations(summary: TraceSummary, fragment: str) -> List[float]:
  """Device seconds of each launch of the kernels whose name holds
  ``fragment``."""
  return [d for name, ds in summary.kernel_s.items() if fragment in name
          for d in ds]

