"""ba_ms.threaded: mean of the program's ``Timing`` span "BA thread
iteration" (one BA iteration on the BA thread, host clock) over the
window, the iterations that ended while the profiler ran left out. Layer
``slam.direct_ba``."""

from portbench.harness import stats


def read(record):
  m = stats.mean(record.timing.get("BA thread iteration", []))
  return None if m is None else m * 1e3
