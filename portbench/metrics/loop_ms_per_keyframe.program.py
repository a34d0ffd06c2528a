"""loop_ms_per_keyframe.program: the loop detector's host milliseconds per
keyframe from the program's own spans in ``loop/detector.py``: the sum of
"Loop feature extraction", "Loop database query" (both on the detection
thread under parallel detection), "Loop result wait" and "Loop
verification" (on the thread that registers the keyframe) over the window,
over the count of "Loop database query" spans (one per keyframe queried),
the spans of the profiled frames left out. The in-program twin of
``loop_ms_per_keyframe``, which the harness times from outside. Layer
``loop.detector``."""

SPANS = ("Loop feature extraction", "Loop database query",
         "Loop result wait", "Loop verification")


def read(record):
  queries = len(record.timing.get("Loop database query", []))
  if not queries:
    return None
  total = sum(sum(record.timing.get(tag, [])) for tag in SPANS)
  return 1e3 * total / queries
