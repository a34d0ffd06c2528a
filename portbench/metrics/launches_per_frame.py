"""launches_per_frame: kernel launches (the host's ``cu*LaunchKernel*``
calls, every thread) inside the profiled frames over their number. Nothing
to read without a device trace."""


def read(record):
  t = record.trace
  if t is None or record.device != "cuda" or not t.frames:
    return None
  return t.launches / t.frames
