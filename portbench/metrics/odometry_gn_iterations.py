"""odometry_gn_iterations: mean of the program's counter "Odometry GN
iterations" (one sample per frame tracked by ``BadSlam.run_odometry``: the
frame-to-frame H/b evaluations its GN loops launched over all scales) over
the window's frames, the profiled ones left out. Layer
``models.odometry``."""

from portbench.harness import stats


def read(record):
  return stats.mean(record.timing.get("Odometry GN iterations", []))
