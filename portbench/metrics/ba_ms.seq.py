"""ba_ms.seq: mean of the program's ``Timing`` span "Bundle adjustment"
(``DirectBA.bundle_adjustment`` called in the frame loop under sequential
BA) per call in the window, the profiled frames' calls left out. Layer
``slam.direct_ba``."""

from portbench.harness import stats


def read(record):
  m = stats.mean(record.timing.get("Bundle adjustment", []))
  return None if m is None else m * 1e3
