"""loop_ms_per_keyframe: the loop detector's host milliseconds per
keyframe: the mean of the harness's span from the start of a keyframe's
feature extraction to the end of its database query (on the detection
thread), plus the mean of its span around ``LoopDetector.add_keyframe``
(the result's hand-over, the verification and the closing, on the BA
thread), over the window, the spans that overlap the profiled frames left
out. Layer ``loop.detector``."""

from portbench.harness import stats


def read(record):
  detect = stats.mean(record.loop_s.get("detect", []))
  add = stats.mean(record.loop_s.get("add", []))
  if detect is None or add is None:
    return None
  return (detect + add) * 1e3
