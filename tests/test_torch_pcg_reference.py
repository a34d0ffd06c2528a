"""The port's joint solver (``badslam_tpu_torch.models.pcg``) against the
benchmark's plain reference of the same Gauss-Newton system
(``portbench/reference/joint_ba.py``: the Jacobians by autograd, the sums in
float64), on a seeded map of three textured keyframes at 160x120 (cell 4,
the port's ``multi_view_plane_keyframes``, every pose then moved by up to
2 mm and 1 mrad); and the joint path's ``Timing`` spans and counters.

Tolerances, each a share of the block's largest entry:
  * r, M and H p within 1e-5: the two differ by the port's float32 rounding
    of its per-lane terms and sums; 3.3e-8 to 5.0e-7 were measured here, so
    1e-5 leaves 20x room while a dropped term (the descriptor weights)
    moves its blocks by their whole size;
  * the CG step within 1e-3: both solves run the same loop and end test,
    the port in float32 and the reference in float64, and each stops up to
    3.8e-5 short of the exact step; their ends were 1.2e-5 apart (the end
    test can fall an iteration apart: 25 against 24 here);
  * the reference's CG run to convergence against its dense GN step
    (``torch.linalg.solve``) within 1e-9: both in float64, 1.5e-12
    measured.
"""

import dataclasses

import numpy as np
import pytest
import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.models import cost, pcg
from badslam_tpu_torch.slam.direct_ba import DirectBA
from badslam_tpu_torch.utils import synthetic
from badslam_tpu_torch.utils.timing import Timing
from portbench.reference import joint_ba as ref
from tests.test_torch_ba_fixtures import configs

W, H = 160, 120
KEYFRAMES = 3
GAUGE = 1
BLOCKS = ("poses", "spos", "sdesc")
PCG_SPANS = ("BA PCG", "BA PCG init", "BA PCG inner loop",
             "BA PCG normal re-estimation")
PCG_COUNTERS = ("BA PCG inner iterations", "BA PCG keyframe passes",
                "BA PCG terms recomputed")


def build_map(use_pcg: bool = False) -> DirectBA:
  """The port's DirectBA on the CPU holding the seeded map, every keyframe
  and surfel active."""
  cam = synthetic.default_test_camera(W, H)
  _, cfg = configs(sparse_surfel_cell_size=4, max_depth=20.0,
                   initial_keyframe_capacity=KEYFRAMES)
  ba = DirectBA(dataclasses.replace(cfg, use_pcg=use_pcg), cam, cam,
                device="cpu")
  views = synthetic.multi_view_plane_keyframes(
      cam, n_kf=KEYFRAMES, textured=True, t_range=0.1, seed=2)
  for i, (kf, T) in enumerate(views):
    ba.add_keyframe(kf.depth, kf.normals, kf.radius_sq, kf.intensity, kf.rgb,
                    torch.from_numpy(T), i)
  for i in range(KEYFRAMES):
    ba.create_surfels_for_keyframe(i, filter_new_surfels=True)
  ba.surfels = ba.surfels._replace(active=ba.surfels.valid)
  rng = np.random.default_rng(5)
  T = ba.kf.global_T_frame.clone()
  for i in range(KEYFRAMES):
    noise = np.concatenate([rng.uniform(-2e-3, 2e-3, 3),
                            rng.uniform(-1e-3, 1e-3, 3)]).astype(np.float32)
    T[i] = T[i] @ se3.exp(torch.from_numpy(noise))
  ba.kf = ba.kf._replace(global_T_frame=T)
  return ba


def joint_map(ba: DirectBA) -> ref.JointMap:
  c = ba.calibration
  return ref.JointMap.of(ba.surfels, ba.kf, c.depth_intr, ba.color_intr,
                         c.depth_size, ba.color_size, c.a, c.cfactor,
                         c.cell_size, c.baseline_fx)


@pytest.fixture(scope="module")
def state():
  ba = build_map()
  slots = list(range(KEYFRAMES))
  return ba, slots, ref.System(joint_map(ba), slots, GAUGE)


def port_args(ba):
  return (ba.surfels, ba.kf, ba.depth_camera(), ba.color_camera(),
          ba.calibration, GAUGE)


def share(got, want) -> float:
  """The largest difference over the block's largest entry."""
  got, want = got.double(), want.double()
  return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("block", BLOCKS)
def test_pcg_init_matches_reference(state, block):
  ba, slots, system = state
  r, M = pcg.pcg_init(*port_args(ba), slots=slots)
  r_ref, M_ref = system.gradient(), system.diagonal()
  assert float(getattr(r_ref, block).abs().max()) > 0
  assert share(getattr(r, block), getattr(r_ref, block)) < 1e-5
  assert share(getattr(M, block), getattr(M_ref, block)) < 1e-5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_apply_hessian_matches_reference(state, seed):
  ba, slots, system = state
  g = torch.Generator().manual_seed(seed)
  n = ba.surfels.capacity
  p = pcg.PCGVector(torch.randn(KEYFRAMES, 6, generator=g),
                    torch.randn(n, generator=g),
                    torch.randn(n, 2, generator=g), torch.zeros(pcg.N_DINTR),
                    torch.zeros(ba.calibration.cfactor.numel()),
                    torch.zeros(pcg.N_CINTR))
  h = pcg.apply_hessian(p, *port_args(ba), slots=slots)
  want = system.hessian_product(ref.Vector(*(x.double() for x in p[:3])))
  for block in BLOCKS:
    assert share(getattr(h, block), getattr(want, block)) < 1e-5, block
  # The gauge keyframe's rows are held fixed in both.
  assert float(h.poses[GAUGE].abs().max()) == 0.0
  assert float(want.poses[GAUGE].abs().max()) == 0.0


def test_pcg_solve_matches_reference(state):
  ba, slots, system = state
  with Timing.isolated() as stats:
    delta = pcg.pcg_solve(*port_args(ba), 30, slots=slots)
  want, iterations = system.solve(30)
  assert abs(stats["BA PCG inner iterations"].samples[0] - iterations) <= 3
  for block in BLOCKS:
    assert share(getattr(delta, block), getattr(want, block)) < 1e-3, block


def test_reference_cg_reaches_its_dense_step(state):
  _, _, system = state
  dense = system.dense_step()
  converged, iterations = system.solve(iterations=2000, threshold=1e-30)
  assert iterations < 2000
  for block in BLOCKS:
    assert share(getattr(converged, block), getattr(dense, block)) < 1e-9
  # Thirty steps stop short of it, by a little.
  short, _ = system.solve(30)
  assert 0 < share(short.poses, dense.poses) < 1e-2


def test_dropped_descriptor_weights_are_caught(state, monkeypatch):
  """A planted fault: the port's descriptor weights set to 0. M's
  descriptor rows leave the tolerance by their whole size."""
  ba, slots, system = state
  monkeypatch.setattr(cost, "descriptor_weight",
                      lambda r, scaling=1.0: torch.zeros_like(r))
  r, M = pcg.pcg_init(*port_args(ba), slots=slots)
  assert share(M.sdesc, system.diagonal().sdesc) > 0.5
  assert share(r.sdesc, system.gradient().sdesc) > 0.5


def _recorded(ba: DirectBA, iterations: int = 2):
  with Timing.isolated() as stats:
    done, _ = ba.bundle_adjustment(max_iterations=iterations,
                                   min_iterations=iterations)
  return done, {tag: list(s.samples) for tag, s in stats.items()}


def _count_products(monkeypatch):
  """A list that gains one entry per Hessian-vector product, the work of
  one inner iteration."""
  calls = []
  real = pcg.apply_hessian

  def counted(*args, **kwargs):
    calls.append(1)
    return real(*args, **kwargs)

  monkeypatch.setattr(pcg, "apply_hessian", counted)
  return calls


def test_spans_and_counters_record_on_the_joint_path(monkeypatch):
  ba = build_map(use_pcg=True)
  products = _count_products(monkeypatch)
  done, stats = _recorded(ba)
  assert done == 2
  for tag in PCG_SPANS:
    assert len(stats[tag]) == done, tag
    assert len(stats[tag + " [cpu]"]) == done, tag
  for tag in PCG_COUNTERS:
    assert len(stats[tag]) == done, tag
  assert sum(stats["BA PCG inner iterations"]) == len(products)
  # The terms are held: one pass computes them, each inner iteration reads
  # them once more.
  assert stats["BA PCG terms recomputed"] == [0, 0]
  assert stats["BA PCG keyframe passes"] == [
      n + 1 for n in stats["BA PCG inner iterations"]]
  assert stats["BA participating keyframes"] == [KEYFRAMES] * done
  assert "BA geometry optimization" not in stats


def test_terms_recomputed_counts_every_pass_where_they_do_not_fit(
    monkeypatch):
  monkeypatch.setattr(pcg, "CPU_TERM_BUDGET_BYTES", 0)
  ba = build_map(use_pcg=True)
  _, stats = _recorded(ba, iterations=1)
  assert stats["BA PCG terms recomputed"] == stats["BA PCG keyframe passes"]
  assert stats["BA PCG terms recomputed"][0] > 1


@pytest.mark.parametrize("use_pcg", [False, True],
                         ids=["alternating", "joint"])
def test_participating_keyframes_count_under_both_solvers(use_pcg):
  ba = build_map(use_pcg=use_pcg)
  done, stats = _recorded(ba)
  assert stats["BA participating keyframes"] == [KEYFRAMES] * done
  assert ("BA PCG" in stats) == use_pcg
  assert ("BA geometry optimization" in stats) == (not use_pcg)


def test_mesh_records_one_sample_per_solve(monkeypatch):
  """Over a 2-shard CPU mesh every position runs the same loop; only the
  first records the joint step's spans and counters."""
  from badslam_tpu_torch.parallel import sharded_ba
  from badslam_tpu_torch.parallel.spmd import Mesh
  one = build_map(use_pcg=True)
  surfels, kf, host = one.to_numpy()
  cam = synthetic.default_test_camera(W, H)
  ba = DirectBA.from_numpy(one.config, cam, cam, surfels, kf,
                           one.calibration.clone(), host, "cpu",
                           mesh=Mesh(["cpu"] * 2, (sharded_ba.SURFEL_AXIS,)))
  products = _count_products(monkeypatch)
  done, stats = _recorded(ba, iterations=1)
  assert done == 1
  for tag in PCG_SPANS + PCG_COUNTERS + ("BA participating keyframes",):
    assert len(stats[tag]) == 1, tag
  # Each position made every product; one of them counted the iterations.
  assert len(products) % 2 == 0
  assert stats["BA PCG inner iterations"] == [len(products) // 2]
