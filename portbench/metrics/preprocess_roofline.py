"""preprocess_roofline: the hand-written kernel ``fused_depth_preprocess``
(``csrc/fused_preprocess.cu``) as a share of its roofline: the least time
the H100 could take on the profiled frames' own depth
(``harness/roofline.preprocess_bound``: the larger of bytes over the memory
rate and float32 operations over the float32 peak) over the kernel's mean
device time per launch in the profiler's trace. Nothing to read without a
device trace."""

from portbench.harness import trace

KERNEL = "fused_depth_preprocess"


def read(record):
  if record.trace is None or record.preprocess_bound_s is None:
    return None
  launches = trace.kernel_durations(record.trace, KERNEL)
  if not launches:
    return None
  return 100.0 * record.preprocess_bound_s / (sum(launches) / len(launches))
