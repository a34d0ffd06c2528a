"""pcg_inner_iterations: mean of the program's counter "BA PCG inner
iterations" (one sample per joint PCG solve, ``models/pcg.pcg_solve``: the
conjugate-gradient steps it ran, at most ``pcg_max_inner_iterations``) over
the window's solves, the profiled frames' left out; None where the program
records no such counter (the alternating solver, or a program without it).
Layer ``models.pcg``."""

from portbench.harness import stats


def read(record):
  return stats.mean(record.timing.get("BA PCG inner iterations", []))
