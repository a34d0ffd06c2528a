"""The readers of the program's counters and thread CPU spans on synthetic
records: the GN iterations per frame, the CPU shares of odometry and of the
BA thread, the keyframe hand-off, and the loop detector's time per keyframe
from its own spans; None where the program records no such tag (the
parent of these spans, sequential BA, no loop detection)."""

import pytest

from portbench.harness import runner, spec

NEW = ("odometry_gn_iterations", "odometry_cpu_share",
       "ba_cpu_share.threaded", "keyframe_handoff_ms",
       "loop_ms_per_keyframe.program")


def record(timing):
  return runner.Record(device="cuda", setup_s=12.5, window_s=10.0,
                       frame_s=[0.1] * 50, timing=timing, ba_iterations=0,
                       parallel_ba=True, loop_s={})


def reader(name):
  return spec.load_reader(spec.ROOT, name)


@pytest.mark.parametrize("name", NEW)
def test_none_where_the_program_records_nothing(name):
  # What a program without the counters and [cpu] spans records.
  old = {"Odometry": [0.2, 0.4], "BA thread iteration": [1.2],
         "Bundle adjustment": [1.0]}
  assert reader(name)(record(old)) is None
  assert reader(name)(record({})) is None


def test_gn_iterations_mean_per_tracked_frame():
  r = record({"Odometry GN iterations": [9, 12, 15, 8]})
  assert reader("odometry_gn_iterations")(r) == pytest.approx(11.0)


@pytest.mark.parametrize("name, tag", [
    ("odometry_cpu_share", "Odometry"),
    ("ba_cpu_share.threaded", "BA thread iteration")])
def test_cpu_share_is_summed_cpu_over_summed_wall(name, tag):
  r = record({tag: [0.2, 0.6], f"{tag} [cpu]": [0.1, 0.1]})
  assert reader(name)(r) == pytest.approx(25.0)
  # A span with no wall time reads nothing rather than dividing by zero.
  r = record({tag: [0.0], f"{tag} [cpu]": [0.0]})
  assert reader(name)(r) is None


def test_handoff_mean_in_ms_and_none_under_sequential_ba():
  r = record({"Keyframe hand-off wait": [0.3, 0.5, 1.0]})
  assert reader("keyframe_handoff_ms")(r) == pytest.approx(600.0)
  sequential = record({"Odometry": [0.1], "Bundle adjustment": [2.0]})
  assert reader("keyframe_handoff_ms")(sequential) is None


def test_loop_ms_per_keyframe_from_the_programs_spans():
  r = record({"Loop feature extraction": [0.004, 0.006],
              "Loop database query": [0.001, 0.003],
              "Loop result wait": [0.0005, 0.0015],
              "Loop verification": [0.02],
              "Loop feature extraction [cpu]": [9.0],
              "Loop query: sent to verification": [1]})
  # (0.010 + 0.004 + 0.002 + 0.020) s over 2 queries; siblings and
  # counters are not summed.
  assert reader("loop_ms_per_keyframe.program")(r) == pytest.approx(18.0)
  # Sequential detection has no result wait.
  r = record({"Loop feature extraction": [0.004],
              "Loop database query": [0.002]})
  assert reader("loop_ms_per_keyframe.program")(r) == pytest.approx(6.0)


def test_new_metrics_are_declared_where_their_tags_exist():
  bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
  entries = {m["name"]: m for m in bench["per_layer"]}
  assert set(NEW) <= set(entries)
  orbit = [m.name for m in spec.load_cell("defaults.orbit").per_layer]
  sweep = [m.name for m in spec.load_cell("seq_ba.sweep").per_layer]
  assert set(NEW) <= set(orbit)
  assert {"odometry_gn_iterations", "odometry_cpu_share"} <= set(sweep)
  assert not {"ba_cpu_share.threaded", "keyframe_handoff_ms",
              "loop_ms_per_keyframe.program"} & set(sweep)
