"""The benchmark of the PyTorch/CUDA port (``badslam_tpu_torch``): one run of
one cell:

  python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
      --trace <0|1>

It renders the cell's RGB-D video from the seed, maps the session before
the window, runs BAD SLAM on it (``BadSlam.process_frame`` +
``end_frame``, closed loop) for ``--seconds``, checks what the window
produced against the plain reference, and prints one JSON line: the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``. ``--control tf32``
runs the program with TF32 products instead, the control that the
correctness check must refuse. See ``portbench/README.md``.

Exit codes: 0 with a result; 2 where no CUDA device, or too few, is
visible; 3 where the JAX package or JAX was loaded; 1 on any other error.
"""

import time

T_PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The driver's JIT cache at a fixed path inside the checkout; the port
# builds its one library into build/kernels there itself.
os.environ["CUDA_CACHE_PATH"] = os.path.join(ROOT, "build", "portbench", "nv")
# A library that loads JAX by itself (transformers' Flax support) must not.
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "badslam_tpu")


def forbidden_modules(names=None) -> list:
  """The module names (default: every loaded one) whose top-level name,
  the part before the first dot, is one of ``FORBIDDEN``, compared whole:
  ``badslam_tpu_torch`` is not ``badslam_tpu``."""
  return sorted({name for name in (sys.modules if names is None else names)
                 if name.split(".")[0] in FORBIDDEN})


def parse_args(argv):
  p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
  p.add_argument("--workload", required=True)
  p.add_argument("--seed", type=int, required=True)
  p.add_argument("--seconds", type=float, required=True)
  p.add_argument("--trace", type=int, choices=(0, 1), default=0)
  p.add_argument("--control", choices=("tf32",), default=None)
  return p.parse_args(argv)


def result_line(cell, outcome, trace_on: bool, device, correct: bool,
                checks) -> dict:
  """The contract's last line."""
  import torch
  metrics = {}
  for m in (cell.per_layer if trace_on else cell.end_to_end):
    value = m.read(outcome.record)
    if value is not None:
      metrics[m.name] = {"value": value, "unit": m.unit}
  if device.type == "cuda":
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell.chips,
           "memory_peak_bytes": outcome.memory_peak_bytes}
  else:
    dev = {"platform": "cpu", "kind": "cpu", "count": 1,
           "memory_peak_bytes": 0}
  line = {"correct": correct, "attempted": outcome.attempted,
          "failed": int(outcome.readings.get("lost_frames", 0)),
          "metrics": metrics, "device": dev}
  summary = outcome.record.trace
  if trace_on and summary is not None and device.type == "cuda":
    dev["busy_s"] = summary.busy_s
    dev["window_s"] = summary.window_s
    line["breakdown"] = {"device_ops": [list(x) for x in summary.device_ops],
                         "idle_gaps": [list(x) for x in summary.idle_gaps]}
  # JSON has no infinity: a reading that could not be taken is null.
  line["checks"] = {name: {"value": v if math.isfinite(v) else None,
                           "limit": lim}
                    for name, v, lim in checks}
  return line


def run_cell(cell, seed: int, seconds: float, trace_on: bool, device,
             control=None, fault=None, t_start: float = T_PROCESS_START):
  """(correct, result line) of one run; the readings and limits are printed
  to standard error, the compared ones last."""
  from portbench.harness import runner
  from portbench.reference import judge
  outcome = runner.run(cell, seed, seconds, trace_on, device, t_start,
                       control=control, fault=fault)
  correct, checks = judge.judge(outcome.readings, cell.limits)
  if outcome.exhausted:
    correct = False
    print("portbench: the window ran out of frames: the mix needs more",
          file=sys.stderr)
  for name, v in sorted(outcome.notes.items()):
    print(f"note {name} {v!r}", file=sys.stderr)
  frame_ms = [1e3 * s for s in outcome.record.frame_s]
  inside = [frame_ms[k] for k in outcome.record.profiled
            if k < len(frame_ms)]
  outside = [v for k, v in enumerate(frame_ms)
             if k not in outcome.record.profiled]
  if inside and outside:
    # What the profiler costs the frames it covers.
    print(f"note frame_ms_mean_profiled {sum(inside) / len(inside)!r} "
          f"unprofiled {sum(outside) / len(outside)!r}", file=sys.stderr)
  for name, v in sorted(outcome.readings.items()):
    if name not in cell.limits:
      print(f"reading {name} {v!r}", file=sys.stderr)
  for name, v, lim in checks:
    print(f"check {name} {v!r} limit {lim!r} "
          f"{'ok' if v <= lim else 'FAILED'}", file=sys.stderr)
  return correct, result_line(cell, outcome, trace_on, device, correct,
                              checks)


def main(argv=None) -> int:
  args = parse_args(argv)
  import torch
  from portbench.harness import spec
  cell = spec.load_cell(args.workload)
  visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
  if visible < cell.chips:
    print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), "
          f"{visible} visible", file=sys.stderr)
    return 2
  import badslam_tpu_torch  # noqa: F401  (fails where the port is absent)
  _, line = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                     torch.device("cuda", 0), control=args.control)
  found = forbidden_modules()
  if found:
    print(f"portbench: loaded in this process: {', '.join(found)}",
          file=sys.stderr)
    return 3
  sys.stdout.flush()
  print(json.dumps(line), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
