"""The whole system with its back-end sharded: ``BadSlam(..., mesh=...)`` on
a virtual 4-shard CPU mesh, each case held to the port's own single-device
run of the same configuration (the port's single-device system is held to
the JAX package's by ``tests/test_torch_slice.py`` and the files after it).

The counterparts of ``tests/test_mesh_system.py``: the host front-end, the
pipelined front-end, parallel BA, concurrent pipelined BA, the state
snapshot from the mesh to one device and from one device to the mesh; then
the CLI's ``--mesh_devices`` (``tests/test_io_and_cli.py:155``). The loop
closures, the device closure among them, are in
``tests/test_torch_mesh_closure.py``. The JAX tests run 8 devices and 32
frames; these run 4 shards and 9 frames (keyframes 0, 4 and 8, so two BA
calls after the first keyframe; parallel BA 8 frames, whose BA thread runs
iterations on every frame) of the heightmap loop world at 160x120.

Gates: the trajectory within 1e-4 m of the single-device run's, the surfel
count within 1% + 16 of it. Parallel and concurrent runs are not repeatable
bit for bit (the threads' schedule); ``quiesce`` after every frame fixes the
order of the parallel BA thread's work.
"""

import contextlib

import numpy as np
import pytest
import torch

from badslam_tpu_torch import main as port_main
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.io import state as state_io
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.parallel import sharded_ba
from badslam_tpu_torch.parallel.spmd import Mesh
from badslam_tpu_torch.slam.system import BadSlam
from badslam_tpu_torch.utils import synthetic, tum_synth
from tests.test_torch_pipelined import forbid_host_reads

W, H = 160, 120
N_FRAMES = 9
TRAJECTORY_LIMIT = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
  before = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(before)


def make_mesh(n=4) -> Mesh:
  return Mesh(["cpu"] * n, (sharded_ba.SURFEL_AXIS,))


def _config(**overrides) -> BadSlamConfig:
  kwargs = dict(
      keyframe_interval=4, num_scales=3, max_depth=5.0,
      sparse_surfel_cell_size=2,
      min_observation_count_while_bootstrapping_1=1,
      min_observation_count_while_bootstrapping_2=1,
      min_observation_count=1,
      initial_keyframe_capacity=8, initial_surfel_capacity=1 << 14,
      enable_loop_detection=True, parallel_ba=False)
  kwargs.update(overrides)
  return BadSlamConfig(**kwargs)


def _video(n=N_FRAMES):
  cam = synthetic.default_test_camera(W, H)
  return synthetic.make_heightmap_video(
      cam, tum_synth.loop_trajectory(n, radius=0.08))


def _trajectory(slam, n=N_FRAMES):
  return np.stack([slam.rgbd_video.frames[i].global_T_frame
                   for i in range(n)])


def _run(mesh, frames=range(N_FRAMES), slam=None, quiesce=False,
         guard=False, **overrides):
  """Frames of the loop world through BadSlam.process_frame; a new system
  unless ``slam`` continues one."""
  if slam is None:
    slam = BadSlam(_config(**overrides), _video(), device="cpu", mesh=mesh)
  with forbid_host_reads() if guard else contextlib.nullcontext():
    for i in frames:
      slam.process_frame(i)
      if quiesce:
        slam.quiesce()
  slam.finalize_pipelined()
  slam.stop_ba_thread_and_wait()
  return slam


def _assert_matches(slam, single_slam, n=N_FRAMES):
  m, s = slam.direct_ba, single_slam.direct_ba
  assert s.mesh is None
  assert m.keyframe_count == s.keyframe_count
  assert abs(m.surfel_count - s.surfel_count) <= 0.01 * s.surfel_count + 16
  diff = np.abs(_trajectory(slam, n) - _trajectory(single_slam, n))
  assert diff.max() < TRAJECTORY_LIMIT, diff.max()


@pytest.fixture(scope="module")
def host_single():
  return _run(None)


def test_full_system_on_mesh_matches_single_device(host_single):
  """The host front-end with sequential BA and loop detection."""
  slam = _run(make_mesh())
  assert slam.direct_ba.mesh is not None
  _assert_matches(slam, host_single)
  assert slam.direct_ba.mesh_gathers > 0


def test_pipelined_system_on_mesh_matches_single_device():
  """The pipelined front-end, transfer-free BA, with no host read in the
  frame loop on the mesh either."""
  single = _run(None, pipelined_frontend=True)
  meshed = _run(make_mesh(), pipelined_frontend=True, guard=True)
  assert meshed.direct_ba.mesh is not None
  _assert_matches(meshed, single)


def test_parallel_ba_on_mesh_matches_single_device():
  """The BA thread drives the sharded back-end while the main thread
  tracks; quiesced after every frame on both sides."""
  frames = range(8)
  single = _run(None, frames, quiesce=True, parallel_ba=True)
  meshed = _run(make_mesh(), frames, quiesce=True, parallel_ba=True)
  assert meshed.direct_ba.mesh is not None
  _assert_matches(meshed, single, n=8)


def test_pipelined_concurrent_ba_on_mesh_matches_single_device():
  """The transfer-free BA thread and the frame loop both reach the mesh."""
  flags = dict(pipelined_frontend=True, pipelined_concurrent_ba=True)
  single = _run(None, **flags)
  meshed = _run(make_mesh(), **flags)
  assert meshed.direct_ba.mesh is not None
  _assert_matches(meshed, single)


# --- snapshots ---


def test_state_snapshot_from_mesh_to_single_device_and_back(tmp_path):
  """A state saved on the mesh resumes on one device, and a state saved on
  one device resumes on the mesh: frames 6-8 after the resume match the
  single-device save resumed on one device. The snapshot holds the
  single-device slot order either way."""
  half = range(6)
  rest = range(6, N_FRAMES)
  paths = {}
  for name, mesh in (("single", None), ("mesh", make_mesh())):
    slam = _run(mesh, frames=half)
    paths[name] = str(tmp_path / f"{name}.npz")
    state_io.save_state(paths[name], slam)

  resumed = {}
  for name, path, mesh in (("single", paths["single"], None),
                           ("mesh_to_single", paths["mesh"], None),
                           ("single_to_mesh", paths["single"], make_mesh())):
    slam = BadSlam(_config(), _video(), device="cpu", mesh=mesh)
    state_io.load_state(path, slam)
    resumed[name] = _run(mesh, frames=rest, slam=slam)
  assert resumed["single_to_mesh"].direct_ba.mesh is not None
  for name in ("mesh_to_single", "single_to_mesh"):
    _assert_matches(resumed[name], resumed["single"])


# --- the CLI ---


def test_cli_mesh_devices(tmp_path):
  """``--device cpu --mesh_devices 8`` through main: 6 frames with the
  back-end on 8 virtual shards, each frame within 6e-3 m of its true pose
  (tests/test_io_and_cli.py:155's dataset and flags)."""
  from tests.test_io_and_cli import _make_world, _write_tum_dataset
  from badslam_tpu.geometry import se3 as jse3
  import jax.numpy as jnp
  cam = synthetic.default_test_camera(W, H)
  traj = [np.asarray(jse3.exp(jnp.asarray(
      [0.003 * i, 0.001 * i, 0, 0.0008 * i, 0, 0], jnp.float32)))
      for i in range(6)]
  _write_tum_dataset(str(tmp_path), cam, traj, _make_world())
  poses_path = str(tmp_path / "poses.txt")
  assert port_main.main([
      str(tmp_path), "--device", "cpu", "--keyframe_interval", "2",
      "--num_scales", "3", "--max_depth", "5.0", "--sparsification", "2",
      "--min_observation_count_while_bootstrapping_1", "1",
      "--min_observation_count_while_bootstrapping_2", "1",
      "--min_observation_count", "1",
      "--no_loop_detection", "--sequential_ba", "--quiet",
      "--mesh_devices", "8", "--export_poses", poses_path]) == 0
  _, poses = read_tum_trajectory(poses_path)
  assert len(poses) == 6
  for i in range(6):
    err = np.linalg.norm(poses[i][:3, 3] - traj[i][:3, 3])
    assert err < 6e-3, f"frame {i} error {err}"


def test_cli_mesh_needs_as_many_cards(monkeypatch):
  """On CUDA, a mesh over more cards than are visible is refused with the
  visible count; the CLI offers no virtual mesh over one card."""
  monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  with pytest.raises(SystemExit, match=r"--mesh_devices 2: only 1 CUDA "
                                       r"device\(s\) visible"):
    port_main.build_mesh(2, "cuda")
  assert port_main.build_mesh(1, "cuda") is None
  mesh = port_main.build_mesh(8, "cpu")
  assert mesh.shape == {"surfels": 8}
  assert all(d == torch.device("cpu") for d in mesh.devices.flat)
