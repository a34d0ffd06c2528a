"""ba_iterations_per_s: iterations the BA thread completed in the window
(the program's ``Timing`` span "BA thread iteration") over the window's
time. Nothing to read where BA runs in the frame loop."""


def read(record):
  if not record.parallel_ba:
    return None
  return record.ba_iterations / record.window_s
