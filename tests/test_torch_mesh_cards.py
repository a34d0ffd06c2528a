"""The mesh across cards: ``spmd``'s collectives, the replicas of the
keyframe stacks, ``BadSlam(..., mesh=...)``, two BA runs from one state and
the CLI's ``--mesh_devices`` on a mesh over real CUDA devices (up to four),
each held to numpy or to the same run on one card.

These are the paths that a virtual mesh over one device never takes: the
partials of a collective copied from the other cards to the group's first
card and its result copied back, the inputs split and copied to each card,
the replicas on the other cards and their row-wise updates when a keyframe
is added, and the CLI's mesh of cards.

Marked ``cuda``: each case skips where fewer than two cards are visible.
On a machine with several cards (no JAX needed):

    python -m pytest -o addopts="" --noconftest -p no:cacheprovider \\
        -m cuda tests/test_torch_mesh_cards.py -q

Gates: the collectives against numpy; each card's replica equal to the
source; the trajectory within 1e-4 m of the one-card run's and the surfel
count within 1% + 16 of it (``tests/test_torch_mesh_system.py``'s); two BA
runs over the cards from one state bitwise equal, for the alternating and
the PCG schemes; the CLI within 1e-4 m of its one-card run and 6e-3 m of
the true poses (``tests/test_io_and_cli.py:155``'s).
"""

import dataclasses

import numpy as np
import pytest
import torch

from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.parallel import sharded_ba, spmd
from badslam_tpu_torch.parallel.spmd import Mesh, P
from badslam_tpu_torch.slam.direct_ba import DirectBA
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic, tum_synth

pytestmark = pytest.mark.cuda

W, H = 160, 120
N_FRAMES = 9
TRAJECTORY_LIMIT = 1e-4
NEEDS_CARDS = "needs at least two CUDA devices"


def visible_cards():
  """Up to four visible CUDA devices, or none where fewer than two are."""
  count = torch.cuda.device_count() if torch.cuda.is_available() else 0
  return ([torch.device("cuda", i) for i in range(min(count, 4))]
          if count >= 2 else [])


@pytest.fixture(scope="module")
def cards():
  found = visible_cards()
  if not found:
    pytest.skip(NEEDS_CARDS)
  return found


def card_mesh(cards) -> Mesh:
  return Mesh(cards, (sharded_ba.SURFEL_AXIS,))


def test_collectives_across_cards(cards):
  """psum and pmax over the cards against numpy, each result on its
  worker's card, the sharded output on the cards in mesh order, the same
  bits in three calls."""
  n = len(cards)
  x = np.random.default_rng(0).standard_normal((n * 64, 3)).astype(
      np.float32)
  mesh = card_mesh(cards)

  def fn(xl):
    total = spmd.psum(xl.sum(dim=0), "surfels")
    biggest = spmd.pmax(xl.max(), "surfels")
    where = torch.tensor([[total.device.index, xl.device.index,
                           spmd.axis_index("surfels")]], device=xl.device)
    return total, biggest, where, xl * 2

  step = spmd.shard_map(fn, mesh, (P("surfels"),),
                        (P(), P(), P("surfels"), P("surfels")))
  runs = [step(torch.from_numpy(x).to(cards[0])) for _ in range(3)]
  total, biggest, where, doubled = runs[0]
  np.testing.assert_allclose(total.cpu().numpy(), x.sum(axis=0), rtol=1e-5,
                             atol=1e-5)
  assert float(biggest) == x.max()
  np.testing.assert_array_equal(
      np.asarray(where), [[c.index, c.index, i] for i, c in enumerate(cards)])
  assert [b.device for b in doubled.blocks()] == cards
  np.testing.assert_array_equal(np.asarray(doubled), 2 * x)
  for other in runs[1:]:
    assert torch.equal(other[0], total)


def test_replicas_follow_keyframe_additions(cards):
  """The other cards' replicas of the keyframe store equal the source after
  each added keyframe, and an addition copies the new slot of the image
  stacks, not the stacks."""
  cam = synthetic.default_test_camera(W, H)
  ba = DirectBA(BadSlamConfig(initial_keyframe_capacity=4,
                              initial_surfel_capacity=1 << 12),
                cam, cam, mesh=card_mesh(cards))
  depth, _ = synthetic.make_plane_scene(cam, seed=3, border=4)
  image = synthetic.preprocess_like_test_keyframe(
      depth, cam, intensity=synthetic.intensity_function_image(cam), cell=2)
  stacks = ("depth", "normals", "radius_sq", "intensity", "rgb")

  def add(i):
    ba.add_keyframe(image.depth * (1 + 0.01 * i), image.normals,
                    image.radius_sq, image.intensity, image.rgb,
                    np.eye(4, dtype=np.float32), 10 * i)

  def check_views():
    for card in cards[1:]:
      view = ba._view(card)
      for name in view.kf._fields:
        replica = getattr(view.kf, name)
        assert replica.device == card, name
        assert torch.equal(replica.cpu(), getattr(ba.kf, name).cpu()), name

  add(0)
  check_views()
  spmd.reset_collective_stats()
  add(1)
  check_views()
  copied = spmd.collective_stats()["replica_bytes"]
  slot = sum(getattr(ba.kf, s)[0].nbytes for s in stacks)
  small = sum(getattr(ba.kf, f).nbytes for f in ba.kf._fields
              if f not in stacks)
  others = len(cards) - 1
  assert others * slot <= copied <= others * (slot + small), (copied, slot)
  assert copied < others * ba.kf.capacity * slot


def _config(**overrides) -> BadSlamConfig:
  kwargs = dict(
      keyframe_interval=4, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1,
      initial_keyframe_capacity=8, initial_surfel_capacity=1 << 14,
      enable_loop_detection=False, parallel_ba=False)
  kwargs.update(overrides)
  return BadSlamConfig(**kwargs)


def _run_system(device, mesh):
  cam = synthetic.default_test_camera(W, H)
  video = synthetic.make_heightmap_video(
      cam, tum_synth.loop_trajectory(N_FRAMES, radius=0.08))
  slam = BadSlam(_config(), video, device=device, mesh=mesh)
  for i in range(N_FRAMES):
    slam.process_frame(i)
  slam.stop_ba_thread_and_wait()
  trajectory = np.stack([video.frames[i].global_T_frame
                         for i in range(N_FRAMES)])
  return slam, trajectory


@pytest.fixture(scope="module")
def system_runs(cards):
  """The heightmap loop world (9 frames, keyframes 0, 4 and 8, sequential
  BA) on one card and over the cards."""
  single = _run_system(cards[0], None)
  meshed = _run_system(None, card_mesh(cards))
  return single, meshed


def test_system_across_cards_matches_one_card(system_runs):
  (single, single_traj), (meshed, mesh_traj) = system_runs
  s, m = single.direct_ba, meshed.direct_ba
  assert m.mesh is not None and s.mesh is None
  assert m.keyframe_count == s.keyframe_count
  assert abs(m.surfel_count - s.surfel_count) <= 0.01 * s.surfel_count + 16
  diff = float(np.abs(mesh_traj[:, :3, 3] - single_traj[:, :3, 3]).max())
  assert diff < TRAJECTORY_LIMIT, diff
  assert m.mesh_gathers > 0


@pytest.mark.parametrize("use_pcg", [False, True],
                         ids=["alternating", "pcg_with_intrinsics"])
def test_ba_across_cards_is_bitwise_repeatable(system_runs, cards, use_pcg):
  """Two BA runs over the cards from the mesh run's map, its keyframe
  poses moved by a seeded perturbation (chip_smoke.py phase 8's), give the
  same bits in both stores and the calibration."""
  _, (meshed, _) = system_runs
  ba = meshed.direct_ba
  surfels, kf, host = ba.to_numpy()
  rng = np.random.default_rng(0)
  for i in range(1, ba.keyframe_count):
    kf["global_T_frame"][i, :3, 3] += rng.uniform(-1e-3, 1e-3, 3)
  config = dataclasses.replace(ba.config, use_pcg=use_pcg)
  results = []
  for _ in range(2):
    twin = DirectBA.from_numpy(config, ba.depth_camera(), ba.color_camera(),
                               surfels, kf, ba.calibration.clone(), host,
                               None, mesh=card_mesh(cards))
    outcome = twin.bundle_adjustment(
        optimize_depth_intrinsics=use_pcg, max_iterations=3,
        active_keyframe_window_start=0,
        active_keyframe_window_end=ba.keyframe_count - 1)
    s, k, _ = twin.to_numpy()
    results.append((outcome, s, k, twin.calibration.depth_intr.cpu()))
  (out_a, s_a, k_a, i_a), (out_b, s_b, k_b, i_b) = results
  assert out_a == out_b
  assert torch.equal(i_a, i_b)
  for a, b in ((s_a, s_b), (k_a, k_b)):
    for name in a:
      np.testing.assert_array_equal(a[name], b[name], err_msg=name)


def test_cli_mesh_devices_across_cards(cards, tmp_path):
  """``--mesh_devices N`` over the cards through main, against the same
  command line on one card: 6 frames, each within 1e-4 m of the one-card
  run and 6e-3 m of its true pose."""
  traj = tum_synth.straight_trajectory(6)
  data = tum_synth.write_tum_dataset(str(tmp_path / "data"), traj, W, H,
                                     quiet=True)
  poses = {}
  for name, extra in (("one", []), ("mesh", ["--mesh_devices",
                                             str(len(cards))])):
    poses[name] = str(tmp_path / f"poses_{name}.txt")
    assert port_main.main([
        data, "--device", cards[0].type, "--keyframe_interval", "2",
        "--num_scales", "3", "--max_depth", "5.0", "--sparsification", "2",
        "--min_observation_count_while_bootstrapping_1", "1",
        "--min_observation_count_while_bootstrapping_2", "1",
        "--min_observation_count", "1", "--no_loop_detection",
        "--sequential_ba", "--quiet", "--export_poses", poses[name]]
        + extra) == 0
  _, one = read_tum_trajectory(poses["one"])
  _, meshed = read_tum_trajectory(poses["mesh"])
  assert len(meshed) == 6
  assert float(np.abs(meshed[:, :3, 3] - one[:, :3, 3]).max()) < \
      TRAJECTORY_LIMIT
  for i in range(6):
    err = np.linalg.norm(meshed[i][:3, 3] - traj[i][:3, 3])
    assert err < 6e-3, f"frame {i} error {err}"
