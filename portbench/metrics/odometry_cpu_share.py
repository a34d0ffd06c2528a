"""odometry_cpu_share: the main thread's CPU time over the wall time of the
program's span "Odometry", in percent (its sibling "Odometry [cpu]", taken
with ``time.thread_time``), summed over the window's frames, the profiled
ones left out. The rest is time the thread was not on a core: waiting for
the interpreter lock, a lock of the program, or the OS. Layer
``slam.system``."""


def read(record):
  wall = sum(record.timing.get("Odometry", []))
  cpu = record.timing.get("Odometry [cpu]")
  if not cpu or wall <= 0:
    return None
  return 100.0 * sum(cpu) / wall
