"""odometry_ms: mean of the program's ``Timing`` span "Odometry"
(``BadSlam.run_odometry``, host clock, no device barriers) over the
window's frames, the profiled ones left out. Layer ``slam.system``."""

from portbench.harness import stats


def read(record):
  m = stats.mean(record.timing.get("Odometry", []))
  return None if m is None else m * 1e3
