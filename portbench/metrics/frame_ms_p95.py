"""frame_ms_p95: the 95th percentile of every window frame's time, from the
call of ``process_frame`` to the return of ``end_frame``, with the frame's
pose on the host (host clock). Keyframe frames are a tenth of the frames,
so the 95th percentile lies inside theirs."""

from portbench.harness import stats


def read(record):
  p95 = stats.percentile(record.frame_s, 95.0)
  return None if p95 is None else p95 * 1e3
