"""ba_keyframes_per_iteration: mean of the program's counter "BA
participating keyframes" (one sample per iteration of
``DirectBA.bundle_adjustment``, under either solver: the valid keyframes
that are active or covisible-active, whose poses and surfels the iteration
solves) over the window, the profiled frames' left out; None where the
program records no such counter. Layer ``slam.direct_ba``; the system's
size, lower is a smaller solve."""

from portbench.harness import stats


def read(record):
  return stats.mean(record.timing.get("BA participating keyframes", []))
