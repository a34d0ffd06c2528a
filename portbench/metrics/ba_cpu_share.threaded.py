"""ba_cpu_share.threaded: the BA thread's CPU time over the wall time of the
program's span "BA thread iteration", in percent (its sibling "BA thread
iteration [cpu]"), summed over the window, the iterations that ended while
the profiler ran left out. The rest is time the BA thread was not on a
core: waiting for the interpreter lock, a lock of the program, or the OS.
Layer ``slam.direct_ba``."""


def read(record):
  wall = sum(record.timing.get("BA thread iteration", []))
  cpu = record.timing.get("BA thread iteration [cpu]")
  if not cpu or wall <= 0:
    return None
  return 100.0 * sum(cpu) / wall
