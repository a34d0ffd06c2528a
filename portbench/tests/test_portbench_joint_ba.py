"""The plain reference of the joint BA step (``reference/joint_ba.py``) and
the ``seq_pcg`` configuration's cells: the reference stays clear of the
program and of JAX; the readers of the joint path's spans and counters;
the cells rehearsed on the CPU; and, on the card, the program's joint GN
system held against the reference at ``seq_pcg.orbit``'s own map.

The card comparison (``python -m pytest portbench/tests -m cuda -s -n 0``)
maps the cell's session (640x480, 25 keyframes) for two seeds, as a run's
set-up does, then compares the program's ``pcg_init`` (r, M),
``apply_hessian`` on three seeded random vectors and ``pcg_solve``'s step
with the reference, over every valid keyframe (the gauge the first) and
every valid surfel. Each tolerance is a share of the block's largest entry
(``TOLERANCES``, with its reason); the program with TF32 products and with
its descriptor weights dropped must leave one of them.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench.harness import runner, spec

ROOT = str(spec.ROOT)
RUN = importlib.util.spec_from_file_location(
    "portbench_run", os.path.join(ROOT, "portbench", "run.py"))
run = importlib.util.module_from_spec(RUN)
RUN.loader.exec_module(run)

CPU = torch.device("cpu")
SEED = 2**31 + 1515
NEW = ("pcg_ms.seq", "pcg_inner_iterations", "pcg_inner_ms",
       "ba_keyframes_per_iteration")
BLOCKS = ("poses", "spos", "sdesc")
# A share of the block's largest entry. r, M and H p: the program's float32
# rounding of its per-lane terms and of sums over 6-7 x 10^5 lanes against
# the reference's float64; 1.1e-6 at most was measured at the cell's map
# (H100, two seeds), 5e-7 at 160x120 (tests/test_torch_pcg_reference.py).
# The step: both run the same 30 CG iterations, the program in float32,
# whose rounding the iterations carry; 2.2e-4 and 8.5e-4 were measured.
# TF32 products move r by 10^3 of its size and M by 4e-4 or more, and
# dropped descriptor weights move every block by its size.
TOLERANCES = {"r": 1e-5, "M": 1e-5, "Hp": 1e-5, "delta": 1e-2}


def record(timing):
  return runner.Record(device="cuda", setup_s=60.0, window_s=51.0,
                       frame_s=[0.5] * 80, timing=timing, ba_iterations=0,
                       parallel_ba=False, loop_s={})


def reader(name):
  return spec.load_reader(spec.ROOT, name)


def test_joint_ba_imports_neither_jax_nor_program():
  out = subprocess.run(
      [sys.executable, "-c", "import portbench.reference.joint_ba, sys, json;"
       " print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
      cwd=ROOT, capture_output=True, text=True, timeout=300,
      env=dict(os.environ, PYTHONPATH=ROOT))
  assert out.returncode == 0, out.stderr
  top = set(json.loads(out.stdout.strip().splitlines()[-1]))
  assert "torch" in top
  for name in ("jax", "jaxlib", "flax", "badslam_tpu", "badslam_tpu_torch"):
    assert name not in top


@pytest.mark.parametrize("name", NEW)
def test_new_readers_read_nothing_where_the_program_records_nothing(name):
  # The alternating solver, or a program without the new tags.
  old = {"Odometry": [0.2], "Bundle adjustment": [2.0],
         "BA geometry optimization": [0.4]}
  assert reader(name)(record(old)) is None
  assert reader(name)(record({})) is None


def test_new_readers_on_the_joint_path():
  r = record({"BA PCG": [0.8, 1.2], "BA PCG [cpu]": [0.7, 1.1],
              "BA PCG inner loop": [0.6, 0.9],
              "BA PCG inner iterations": [20, 30],
              "BA participating keyframes": [25, 26, 27]})
  assert reader("pcg_ms.seq")(r) == pytest.approx(1000.0)
  assert reader("pcg_inner_iterations")(r) == pytest.approx(25.0)
  # 1.5 s over 50 iterations.
  assert reader("pcg_inner_ms")(r) == pytest.approx(30.0)
  assert reader("ba_keyframes_per_iteration")(r) == pytest.approx(26.0)
  # A loop that ran no iteration has no time an iteration.
  r = record({"BA PCG inner loop": [0.01], "BA PCG inner iterations": [0]})
  assert reader("pcg_inner_ms")(r) is None


def test_new_cells_and_metrics_are_declared():
  bench = spec.load_json(spec.ROOT / "BENCHMARK.json")
  pcg = [m.name for m in spec.load_cell("seq_pcg.orbit").per_layer]
  sweep = [m.name for m in spec.load_cell("defaults.sweep").per_layer]
  assert set(NEW) <= set(pcg)
  assert sweep == ["ba_keyframes_per_iteration"]
  for name in ("seq_pcg.orbit", "defaults.sweep"):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert cell.limits["kernel_max_abs"] == 0.0
    assert {m.name for m in cell.end_to_end} == {
        "frames_per_s", "frame_ms_p95", "setup_s"}
  config = runner.badslam_config(spec.load_cell("seq_pcg.orbit").config)
  assert config.use_pcg and not config.parallel_ba
  assert not config.enable_loop_detection
  assert config.pcg_max_inner_iterations == 30
  assert config.pcg_max_keyframe_count == 2500
  names = [c["name"] for c in bench["configs"]]
  assert names.index("seq_pcg") == len(names) - 1


# (cell, the metrics it must report, window seconds): the BA thread's
# iterations that end while the profiler runs are left out, and on a busy
# CPU one takes seconds, so the threaded cell's window is longer.
@pytest.mark.parametrize("cell_name, want, seconds", [
    ("seq_pcg.orbit", set(NEW), 8.0),
    ("defaults.sweep", {"ba_keyframes_per_iteration"}, 25.0)])
def test_cpu_rehearsal_reports_the_new_metrics(tiny_cell, cell_name, want,
                                               seconds):
  cell = tiny_cell(cell_name)
  correct, line = run.run_cell(cell, SEED, seconds, True, CPU)
  assert correct, line["checks"]
  assert want <= set(line["metrics"]), line["metrics"]
  for name in want:
    assert line["metrics"][name]["value"] > 0


# --- on the card: the program's joint system against the reference ---


def session_map(seed: int, device):
  """The program's BA back-end holding ``seq_pcg.orbit``'s session as the
  window starts: the run's set-up (``runner.run``'s steps 1-3)."""
  from badslam_tpu_torch.slam.system import BadSlam
  cell = spec.load_cell("seq_pcg.orbit")
  config = runner.badslam_config(cell.config)
  session = runner.session_indices(int(cell.config["session_frames"]),
                                   config.keyframe_interval)
  video, _, _ = runner.build_video(cell.config, cell.traffic, cell.generator,
                                   session, seed, 1.0, device)
  slam = BadSlam(config, video, device=device)
  for i in session:
    slam.process_frame(i)
    slam.end_frame()
  slam.stop_ba_thread_and_wait()
  return slam.direct_ba


def program_system(ba, slots, gauge, probes):
  """The program's (r, M, [H p], delta) of the map in ``ba``."""
  from badslam_tpu_torch.models import pcg
  args = (ba.surfels, ba.kf, ba.depth_camera(), ba.color_camera(),
          ba.calibration, gauge)
  r, M = pcg.pcg_init(*args, slots=slots)
  hp = [pcg.apply_hessian(p, *args, slots=slots) for p in probes]
  stats = {}
  delta = pcg.pcg_solve(*args, 30, slots=slots, stats=stats)
  return {"r": r, "M": M, "Hp": hp, "delta": delta,
          "iterations": stats["iterations"]}


def shares(got, want) -> dict:
  """{(quantity, block): largest difference over the block's largest
  entry}."""
  out = {}
  for q in ("r", "M", "delta"):
    for b in BLOCKS:
      g, w = getattr(got[q], b).double(), getattr(want[q], b).double()
      out[(q, b)] = float((g - w).abs().max() / w.abs().max())
  for b in BLOCKS:
    out[("Hp", b)] = max(
        float((getattr(g, b).double() - getattr(w, b)).abs().max()
              / getattr(w, b).abs().max())
        for g, w in zip(got["Hp"], want["Hp"]))
  return out


def beyond(found: dict) -> list:
  return [k for k, v in found.items() if not v <= TOLERANCES[k[0]]]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2**31 + 6101, 2**31 + 6102])
def test_program_joint_system_matches_reference_on_the_card(seed):
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device: the map is the cell's own, 640x480")
  from badslam_tpu_torch.models import cost, pcg
  from portbench.reference import joint_ba as ref
  device = torch.device("cuda", 0)
  ba = session_map(seed, device)
  ba.surfels = ba.surfels._replace(active=ba.surfels.valid)
  slots = [int(i) for i in torch.nonzero(ba.kf.valid).flatten()]
  gauge = slots[0]
  g = torch.Generator(device=device).manual_seed(seed)
  n, k = ba.surfels.capacity, ba.kf.capacity
  probes = [pcg.PCGVector(
      torch.randn(k, 6, generator=g, device=device),
      torch.randn(n, generator=g, device=device),
      torch.randn(n, 2, generator=g, device=device),
      torch.zeros(pcg.N_DINTR, device=device),
      torch.zeros(ba.calibration.cfactor.numel(), device=device),
      torch.zeros(pcg.N_CINTR, device=device)) for _ in range(3)]

  c = ba.calibration
  m = ref.JointMap.of(ba.surfels, ba.kf, c.depth_intr, ba.color_intr,
                      c.depth_size, ba.color_size, c.a, c.cfactor,
                      c.cell_size, c.baseline_fx)
  system = ref.System(m, slots, gauge)
  delta, iterations = system.solve(30)
  want = {"r": system.gradient(), "M": system.diagonal(),
          "Hp": [system.hessian_product(ref.Vector(*(x.double()
                                                      for x in p[:3])))
                 for p in probes],
          "delta": delta}
  lanes = sum(len(l.idx) for _, l in system.lanes)
  print(f"\nseed {seed}: {len(slots)} keyframes, {ba.surfel_count} surfels "
        f"(capacity {n}), {lanes} lanes; CG iterations: reference "
        f"{iterations}", file=sys.stderr)

  got = program_system(ba, slots, gauge, probes)
  found = shares(got, want)
  print(f"seed {seed}: program {got['iterations']} iterations; shares "
        f"{ {f'{q}.{b}': v for (q, b), v in found.items()} }",
        file=sys.stderr)
  assert not beyond(found), beyond(found)

  with runner.tf32(True):
    tf32 = program_system(ba, slots, gauge, probes)
  changed = any(not torch.equal(getattr(got[q], b), getattr(tf32[q], b))
                for q in ("r", "M", "delta") for b in BLOCKS)
  found_tf32 = shares(tf32, want)
  print(f"seed {seed}: TF32 changed the joint system: {changed}; shares "
        f"{ {f'{q}.{b}': v for (q, b), v in found_tf32.items()} }; beyond "
        f"{beyond(found_tf32)}", file=sys.stderr)
  if changed:
    assert beyond(found_tf32)

  real = cost.descriptor_weight
  cost.descriptor_weight = lambda r, scaling=1.0: torch.zeros_like(r)
  try:
    fault = program_system(ba, slots, gauge, probes)
  finally:
    cost.descriptor_weight = real
  found_fault = shares(fault, want)
  print(f"seed {seed}: descriptor weights dropped: beyond "
        f"{beyond(found_fault)}", file=sys.stderr)
  assert beyond(found_fault)
