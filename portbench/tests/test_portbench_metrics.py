"""The metric arithmetic on synthetic samples: the window rate, the 95th
percentile over all frames, the union of device intervals and the trace's
reduction, the roofline count."""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from portbench.harness import roofline, runner, spec, stats, trace


def record(**kw):
  base = dict(device="cuda", setup_s=12.5, window_s=10.0,
              frame_s=[0.1] * 50, timing={}, ba_iterations=0,
              parallel_ba=False, loop_s={})
  base.update(kw)
  return runner.Record(**base)


def reader(name):
  return spec.load_reader(spec.ROOT, name)


def test_window_rate_counts_every_frame_over_the_window():
  r = record(frame_s=[0.2] * 37 + [1.0], window_s=8.4)
  assert reader("frames_per_s")(r) == pytest.approx(38 / 8.4)
  assert reader("setup_s")(r) == 12.5
  assert reader("ba_iterations_per_s")(r) is None
  r = record(parallel_ba=True, ba_iterations=21, window_s=7.0)
  assert reader("ba_iterations_per_s")(r) == pytest.approx(3.0)


def test_p95_over_all_frames():
  frames = [0.1] * 90 + [0.5] * 10
  # numpy's linear rule: rank 0.95 * 99 = 94.05 lies among the 0.5 s frames.
  assert reader("frame_ms_p95")(record(frame_s=frames)) == pytest.approx(
      np.percentile(np.array(frames) * 1e3, 95))
  assert stats.percentile([], 95) is None
  assert stats.percentile([3.0], 95) == 3.0
  assert stats.percentile([0.0, 10.0], 95) == pytest.approx(9.5)


def test_span_means_in_ms():
  r = record(timing={"Odometry": [0.2, 0.4], "Bundle adjustment": [1.0],
                     "BA thread iteration": [0.25, 0.35]},
             loop_s={"detect": [0.05, 0.15], "add": [0.001, 0.003]})
  assert reader("odometry_ms")(r) == pytest.approx(300.0)
  assert reader("ba_ms.seq")(r) == pytest.approx(1000.0)
  assert reader("ba_ms.threaded")(r) == pytest.approx(300.0)
  assert reader("loop_ms_per_keyframe")(r) == pytest.approx(102.0)
  assert reader("loop_ms_per_keyframe")(record()) is None


def test_union_of_intervals():
  iv = [(0, 10), (5, 12), (20, 30), (30, 31), (40, 41)]
  assert stats.merge(iv) == [[0, 12], [20, 31], [40, 41]]


class Ev:
  def __init__(self, name, dev, s, e, tid=1):
    self._v = (name, dev, s, e, tid)

  def name(self):
    return self._v[0]

  def device_type(self):
    return self._v[1]

  def start_ns(self):
    return self._v[2]

  def end_ns(self):
    return self._v[3]

  def start_thread_id(self):
    return self._v[4]


def test_trace_reduction():
  cpu, gpu = DeviceType.CPU, DeviceType.CUDA
  events = [
      Ev(trace.SPAN, cpu, 1000, 2000),
      Ev(trace.SPAN, gpu, 1000, 2000),          # the span's device twin
      Ev("cudaLaunchKernel", cpu, 1010, 1015),
      Ev("cuLaunchKernelEx", cpu, 1020, 1025, tid=2),   # another thread
      Ev("cudaLaunchKernel", cpu, 2500, 2510),  # after the span
      Ev("aten::mul", cpu, 1100, 1400),
      Ev("aten::item", cpu, 1500, 1900),
      Ev("kA", gpu, 900, 1100),                 # clipped to 1000-1100
      Ev("kA", gpu, 1050, 1200),
      Ev("Memcpy HtoD", gpu, 1600, 1700),
      Ev("kB", gpu, 1950, 2100),                # clipped to 1950-2000
  ]
  t = trace.reduce_events(events, frames=2)
  assert t.launches == 2
  assert t.window_s == pytest.approx(1000e-9)
  assert t.busy_s == pytest.approx((200 + 100 + 50) * 1e-9)
  assert dict(t.device_ops)["kA"] == pytest.approx(250e-9)
  # Gaps: 1200-1600 (mid 1400, the end of aten::mul: inside it),
  # 1700-1950 (mid 1825, in aten::item).
  idle = dict(t.idle_gaps)
  assert idle["aten::mul"] == pytest.approx(400e-9)
  assert idle["aten::item"] == pytest.approx(250e-9)
  assert trace.kernel_durations(t, "kA") == pytest.approx([100e-9, 150e-9])
  r = record(trace=t)
  assert reader("launches_per_frame")(r) == 1.0
  assert reader("device_idle_share")(r) == pytest.approx(65.0)
  assert reader("device_idle_share")(record(trace=t, device="cpu")) is None
  assert trace.reduce_events(events[2:], frames=2) is None


def test_roofline_count():
  raw = torch.zeros((8, 10))
  raw[2:6, 3:7] = 1.0     # 16 valid pixels, all within the cutoff
  b = roofline.preprocess_bound(raw, sigma_xy=0.5, radius_factor=2.0,
                                max_depth=3.0)
  # radius int(2 * 0.5 + 0.5) = 1: the center and 4 neighbours; valid
  # neighbours of a 4x4 block: 16 + 2 * (4 * 3) + 2 * (3 * 4) = 64 taps.
  ops = (64 * roofline.OPS_PER_TAP + 16 * roofline.OPS_PER_VALID_PIXEL
         + 16 * roofline.OPS_PER_CENTER_PIXEL)
  assert b["ops"] == ops
  assert b["bytes"] == 5 * 4 * 80
  assert b["bound_s"] == pytest.approx(max(
      ops / roofline.H100_FP32_OPS_PER_S,
      1600 / roofline.H100_BYTES_PER_S))
  r = record(trace=trace.TraceSummary(1, 1.0, 0.5, 10, {
      "void fused_depth_preprocess_kernel<3>": [2e-5, 4e-5]}, [], []),
      preprocess_bound_s=3e-6)
  assert reader("preprocess_roofline")(r) == pytest.approx(10.0)
  assert reader("preprocess_roofline")(record()) is None
