"""pcg_ms.seq: mean of the program's ``Timing`` span "BA PCG" (the joint
step of ``DirectBA.bundle_adjustment`` under ``--use_pcg``: the PCG solve,
the delta's application and the normal re-estimation, one span per BA
iteration) over the window's BA iterations, the profiled frames' left out;
None where the BA runs the alternating solver. Layer ``models.pcg``."""

from portbench.harness import stats


def read(record):
  m = stats.mean(record.timing.get("BA PCG", []))
  return None if m is None else m * 1e3
