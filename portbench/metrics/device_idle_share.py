"""device_idle_share: the share of the profiled frames' span in which no
kernel, copy or memset ran on the device (1 - the union of the device's
intervals over the span's length), in percent. Nothing to read without a
device trace."""


def read(record):
  t = record.trace
  if t is None or record.device != "cuda" or t.window_s <= 0:
    return None
  return 100.0 * (1.0 - t.busy_s / t.window_s)
