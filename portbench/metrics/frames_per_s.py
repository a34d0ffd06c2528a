"""frames_per_s: every frame completed in the window over the window's
time (host clock). Layer: the frame loop (``BadSlam.process_frame`` +
``end_frame``)."""


def read(record):
  return len(record.frame_s) / record.window_s if record.window_s > 0 else None
