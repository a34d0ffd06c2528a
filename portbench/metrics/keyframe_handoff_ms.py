"""keyframe_handoff_ms: mean of the program's span "Keyframe hand-off wait"
(parallel BA: a keyframe's host time from ``create_keyframe`` queueing it
to the BA thread taking it off the queue to register it) over the window,
the keyframes taken while the profiler ran left out; None under sequential
BA, which queues nothing. Layer ``slam.system``, the BA thread's queue."""

from portbench.harness import stats


def read(record):
  m = stats.mean(record.timing.get("Keyframe hand-off wait", []))
  return None if m is None else m * 1e3
