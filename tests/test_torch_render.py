"""The port's splat renderer (badslam_tpu_torch.render), its preview and
profiler flags on the CLI, and its snapshot inspector, against the JAX
package's on the CPU: the same numpy inputs go through both.

Tolerances: depth, hit masks, colors and surfel winners are equal, bit for
bit, wherever both renderers take the same inputs (the seeded clouds, the
chunk boundaries, the display modes, a map rendered from a given pose, the
snapshot renders). Keyframe previews are rendered from each package's own
inverse of the keyframe pose: in normals mode the PNGs are byte-equal; in
color mode, after each package's own ``assign_colors``, the color PNGs lie
within 1/255 (truncation of colors averaged in another order) and the depth
PNGs are byte-equal. The inspector's summary is equal line for line, its
PLY byte for byte; its trajectories hold equal timestamps and positions,
and rotations within 2e-7 (the JAX package's writer computes quaternions in
float32, the port's in float64).

On the card, chip_smoke.py (phase 30) holds the port's CUDA render of a map
to its CPU render, which these tests hold to JAX's: hit masks may differ in
at most 0.1% of the pixels and depth, where both hit, by at most 1 cm (a
splat edge moved by one ulp can hand a pixel to a neighbouring surfel).
"""

import copy
import glob
import gzip
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from badslam_tpu import render as jrender
from badslam_tpu import snapshot_inspector as jinspector
from badslam_tpu.io import state as jstate_io
from badslam_tpu.models import surfels as jsurfels
from badslam_tpu.slam.direct_ba import DirectBA as JaxDirectBA
from badslam_tpu_torch import main as port_main
from badslam_tpu_torch import render
from badslam_tpu_torch import snapshot_inspector
from badslam_tpu_torch.io import state as state_io
from badslam_tpu_torch.io.dataset import read_tum_trajectory
from badslam_tpu_torch.models import surfels as psurfels
from badslam_tpu_torch.utils import tum_synth
from tests.test_torch_ba_fixtures import (cameras, configs, perturbed_pose,
                                          plane_keyframe, port_from_jax)

torch.set_num_threads(2)


def _both(pos, col, valid, T, intr, h, w, half_extent, max_depth=np.inf):
  """(JAX's, the port's) render of the same numpy inputs, as numpy
  (depth, color, hit)."""
  j = jrender.render_surfel_splats(
      jnp.asarray(pos), jnp.asarray(col), jnp.asarray(valid), jnp.asarray(T),
      jnp.asarray(intr), h, w, half_extent, max_depth)
  p = render.render_surfel_splats(
      *(torch.from_numpy(np.array(x)) for x in (pos, col, valid, T, intr)),
      h, w, half_extent, max_depth)
  return tuple(np.asarray(x) for x in j), tuple(x.numpy() for x in p)


def _assert_equal_renders(j, p):
  """Hit masks, depth and color equal, bit for bit."""
  for name, a, b in zip(("depth", "color", "hit"), j, p):
    np.testing.assert_array_equal(b, a, err_msg=name)


def test_footprint_depth_test_and_masking_match_jax():
  """tests/test_render.py's case: two surfels on one pixel (the nearer
  wins), the splat square of half-extent 1.5, invalid and behind-camera
  surfels."""
  intr = np.array([100.0, 100.0, 32.0, 24.0], np.float32)
  pos = np.array([[0.0, 0.0, 2.0], [0.0, 0.0, 1.0], [0.1, 0.05, 1.5]],
                 np.float32)
  col = np.eye(3, dtype=np.float32)
  T = np.eye(4, dtype=np.float32)
  j, p = _both(pos, col, np.ones(3, bool), T, intr, 48, 64, 1.5)
  _assert_equal_renders(j, p)
  d, c, h = p
  assert d[24, 32] == 1.0 and c[24, 32].tolist() == [0.0, 1.0, 0.0]
  assert h[24, 30] and h[24, 33] and not h[24, 34] and not h[24, 29]
  assert h[22, 32] and h[25, 32] and not h[26, 32] and not h[21, 32]
  j, p = _both(pos, col, np.zeros(3, bool), T, intr, 48, 64, 1.5)
  _assert_equal_renders(j, p)
  assert not p[2].any()
  j, p = _both(np.array([[0.0, 0.0, -1.0]], np.float32), col[:1],
               np.ones(1, bool), T, intr, 48, 64, 1.5)
  _assert_equal_renders(j, p)
  assert not p[2].any()


def _seeded_cloud(n, seed):
  """``n`` surfels made from ``seed``: a volume in front of the camera,
  with exact ties (surfels i and i + 16 share a position), 10% invalid,
  some behind the camera, at z = 0, at depths near 0 (projections ~1e10
  and beyond float32 int range) and projecting far off the image."""
  rng = np.random.default_rng(seed)
  pos = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.2, 1.2, n),
                  rng.uniform(0.3, 4.0, n)], -1).astype(np.float32)
  pos[16:32] = pos[0:16]
  pos[32:40, 2] = -rng.uniform(0.1, 2.0, 8)
  pos[40:44, 2] = 0.0
  pos[44:48] = [[0.3, -0.2, 1e-9], [-0.4, 0.1, 1e-30], [1.0, 1.0, 1e-20],
                [-2.0, 0.5, 3e-10]]
  pos[48:56, 0] = rng.choice([-1.0, 1.0], 8) * rng.uniform(50.0, 1e6, 8)
  col = rng.uniform(0.0, 1.0, (n, 3)).astype(np.float32)
  valid = rng.uniform(size=n) > 0.1
  valid[:56] = True
  return pos, col, valid


@pytest.mark.parametrize("half_extent", [0.5, 1.5, 3.0, 4.2])
def test_seeded_cloud_matches_jax(half_extent):
  pos, col, valid = _seeded_cloud(3000, seed=11)
  T = np.asarray(perturbed_pose(np.random.default_rng(5), 0.05, 0.05),
                 np.float32)
  intr = np.array([96.0, 94.0, 60.25, 44.75], np.float32)
  j, p = _both(pos, col, valid, T, intr, 90, 120, half_extent)
  _assert_equal_renders(j, p)
  assert p[2].sum() > 1000


def test_near_zero_depth_and_off_image_surfels_draw_nothing():
  """Projections that no tap can bring into the image cover nothing in
  either package: the port clamps them before its integer cast, the JAX
  package relies on x86's out-of-range cast."""
  pos, col, valid = _seeded_cloud(64, seed=3)
  keep = np.zeros(64, bool)
  keep[44:56] = True
  T = np.eye(4, dtype=np.float32)
  intr = np.array([80.0, 80.0, 40.0, 30.0], np.float32)
  j, p = _both(pos, col, valid & keep, T, intr, 60, 80, 3.0)
  _assert_equal_renders(j, p)
  assert not p[2].any() and not j[2].any()
  # Straight ahead, a surfel at a depth near 0 draws, and is the nearest:
  # the 6 x 6 pixel centers within 3 px of (40, 30).
  near = np.array([[0.0, 0.0, 1e-9], [0.0, 0.0, 1.0]], np.float32)
  j, p = _both(near, col[:2], np.ones(2, bool), T, intr, 60, 80, 3.0)
  _assert_equal_renders(j, p)
  assert p[2].sum() == 36 and p[0][30, 40] == np.float32(1e-9)


def test_chunk_boundaries_keep_both_tie_rules(monkeypatch):
  """Chunks of 8 surfels in both packages (shapes used by no other call,
  since JAX caches its trace by shape). Inside a chunk the larger index
  wins a tie; across chunks the earlier chunk keeps the pixel."""
  monkeypatch.setattr(jrender, "_RENDER_CHUNK", 8)
  monkeypatch.setattr(render, "_RENDER_CHUNK", 8)
  pos, col, valid = _seeded_cloud(61, seed=7)
  pos[1] = pos[5] = [0.2, 0.1, 1.7]     # one chunk: 5 wins over 1
  pos[3] = pos[11] = [-0.3, 0.2, 1.7]   # two chunks: 3 keeps it over 11
  valid[[1, 3, 5, 11]] = True
  T = np.eye(4, dtype=np.float32)
  intr = np.array([70.0, 70.0, 37.0, 29.0], np.float32)
  j, p = _both(pos, col, valid, T, intr, 58, 74, 1.0)
  _assert_equal_renders(j, p)
  alone = np.zeros(61, bool)
  alone[[1, 3, 5, 11]] = True
  j, p = _both(pos, col, alone, T, intr, 58, 74, 1.0)
  _assert_equal_renders(j, p)
  for winner in (5, 3):
    x = int(np.floor(70.0 * pos[winner, 0] / pos[winner, 2] + 37.0))
    y = int(np.floor(70.0 * pos[winner, 1] / pos[winner, 2] + 29.0))
    np.testing.assert_array_equal(p[1][y, x], col[winner])


@pytest.mark.parametrize("mode",
                         ["color", "descriptors", "normals", "activation"])
def test_display_colors_match_jax(mode):
  rng = np.random.default_rng(4)
  n = 40
  arrays = {
      "pos": rng.normal(size=(n, 3)).astype(np.float32),
      "normal": rng.normal(size=(n, 3)).astype(np.float32),
      "radius_sq": rng.uniform(1e-6, 1e-4, n).astype(np.float32),
      "color": rng.uniform(0, 1, (n, 3)).astype(np.float32),
      "desc": rng.uniform(-250.0, 250.0, (n, 2)).astype(np.float32),
      "valid": rng.uniform(size=n) > 0.2,
      "active": rng.uniform(size=n) > 0.5,
      "count": np.int32(n)}
  j = jsurfels.SurfelStore(**{k: jnp.asarray(v) for k, v in arrays.items()})
  p = psurfels.from_numpy(arrays, "cpu")
  np.testing.assert_array_equal(
      render.surfel_display_colors(p, mode).numpy(),
      np.asarray(jrender.surfel_display_colors(j, mode)))


@pytest.fixture(scope="module")
def ba_pair():
  """A JAX DirectBA with two plane-scene keyframes (frames 0 and 7) and
  their surfels, and the port's DirectBA continuing from its state."""
  jcfg, _ = configs()
  jcam, _ = cameras()
  jba = JaxDirectBA(jcfg, jcam, jcam)
  kf, _ = plane_keyframe(seed=3)
  T2 = perturbed_pose(np.random.default_rng(9), 0.02, 0.01)
  for T, frame in ((np.eye(4, dtype=np.float32), 0), (T2, 7)):
    jba.add_keyframe(*(jnp.asarray(x) for x in kf), jnp.asarray(T), frame)
  jba.create_surfels_for_keyframe(0, filter_new_surfels=False)
  jba.create_surfels_for_keyframe(1, filter_new_surfels=False)
  assert jba.surfel_count > 1000
  return jba, port_from_jax(jba)


@pytest.mark.parametrize("resolution", [None, (60, 100)])
def test_render_map_matches_jax(ba_pair, resolution):
  """A map rendered from a given pose, at the color camera's size and at a
  size of another aspect (the intrinsics scaled per axis)."""
  jba, pba = ba_pair
  T = np.array(perturbed_pose(np.random.default_rng(2), 0.01, 0.01),
               np.float32)
  j = jrender.render_map(jba, T, mode="normals",
                         splat_half_extent_in_pixels=2.0,
                         resolution=resolution)
  p = render.render_map(pba, T, mode="normals",
                        splat_half_extent_in_pixels=2.0,
                        resolution=resolution)
  assert p[1].dtype == np.uint8
  _assert_equal_renders(j, p)
  assert p[2].mean() > 0.3


def _read_png(path):
  return np.asarray(Image.open(path))


@pytest.mark.parametrize("mode", ["normals", "color"])
def test_keyframe_previews_match_jax(ba_pair, tmp_path, mode):
  jba, _ = ba_pair
  # Color mode writes refreshed colors into the back-ends: use copies (the
  # JAX package's replaces its immutable store, so a shallow copy will do).
  jslam = types.SimpleNamespace(direct_ba=copy.copy(jba))
  pslam = types.SimpleNamespace(direct_ba=port_from_jax(jba))
  jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
  assert jrender.render_keyframe_previews(jslam, jdir, mode=mode) == 2
  assert render.render_keyframe_previews(pslam, pdir, mode=mode) == 2
  names = sorted(os.listdir(pdir))
  assert names == sorted(os.listdir(jdir)) == [
      "kf_000000_color.png", "kf_000000_depth.png", "kf_000007_color.png",
      "kf_000007_depth.png"]
  for name in names:
    a, b = _read_png(os.path.join(jdir, name)), _read_png(
        os.path.join(pdir, name))
    if mode == "color" and name.endswith("_color.png"):
      assert np.abs(a.astype(int) - b.astype(int)).max() <= 1, name
    else:
      with open(os.path.join(jdir, name), "rb") as f, open(
          os.path.join(pdir, name), "rb") as g:
        assert f.read() == g.read(), name
    assert (b > 0).any()


def test_cli_render_preview_and_profile_dir(tmp_path, capsys):
  """The port's CLI on the CPU with --render_preview (normals, every second
  keyframe slot) and --profile_dir: one preview pair per rendered keyframe
  at the color camera's size, and a gzipped Chrome trace that parses."""
  data = tum_synth.write_tum_dataset(
      str(tmp_path / "data"), tum_synth.straight_trajectory(5), width=96,
      height=72)
  previews, trace = str(tmp_path / "previews"), str(tmp_path / "trace")
  assert port_main.main([
      data, "--device", "cpu", "--keyframe_interval", "1",
      "--max_num_ba_iterations_per_keyframe", "1", "--sparsification", "2",
      "--num_scales", "3", "--max_depth", "5.0", "--sequential_ba",
      "--no_loop_detection", "--restrict_fps_to", "0",
      "--render_preview", previews, "--render_mode", "normals",
      "--render_every", "2", "--profile_dir", trace]) == 0
  out = capsys.readouterr().out
  assert f"Rendered 3 keyframe previews into {previews}" in out
  assert sorted(os.listdir(previews)) == [
      f"kf_{i:06d}_{kind}.png" for i in (0, 2, 4)
      for kind in ("color", "depth")]
  for i in (0, 2, 4):
    color = _read_png(os.path.join(previews, f"kf_{i:06d}_color.png"))
    depth = _read_png(os.path.join(previews, f"kf_{i:06d}_depth.png"))
    assert color.shape == (72, 96, 3) and depth.dtype == np.uint16
    assert (depth > 0).mean() > 0.5
  (path,) = glob.glob(os.path.join(trace, "badslam.*.pt.trace.json.gz"))
  assert f"Wrote profiler trace {path}" in out
  with gzip.open(path, "rt") as f:
    events = json.load(f)["traceEvents"]
  names = {e.get("name") for e in events}
  assert "aten::mm" in names or "aten::matmul" in names


class _SnapshotHolder:
  """What both packages' ``save_state`` read of a system, around a given
  back-end: 9 frames, keyframes at frames 0 and 7."""

  def __init__(self, ba, config):
    self.direct_ba = ba
    self.config = config
    poses = [np.asarray(perturbed_pose(np.random.default_rng(i), 0.01,
                                       0.01), np.float32) for i in range(9)]
    self.rgbd_video = types.SimpleNamespace(frames=[
        types.SimpleNamespace(global_T_frame=T, depth_timestamp=i / 30.0)
        for i, T in enumerate(poses)])
    self.base_kf_tr_frame = []
    self.base_kf_index = None
    self.base_kf_global_T_frame = np.eye(4, dtype=np.float32)
    self.last_frame_index = 8
    self.keyframe_frame_indices = [0, 7]
    self.num_planned_ba_iterations = 3
    self._pipelined = False

  def quiesce(self):
    pass

  def finalize_pipelined(self):
    pass


@pytest.fixture(scope="module")
def snapshots(ba_pair, tmp_path_factory):
  """The same state saved by each package: {package: path}."""
  jba, pba = ba_pair
  jcfg, pcfg = configs()
  out = tmp_path_factory.mktemp("snapshots")
  paths = {"jax": str(out / "jax.npz"), "port": str(out / "port.npz")}
  jstate_io.save_state(paths["jax"], _SnapshotHolder(jba, jcfg))
  state_io.save_state(paths["port"], _SnapshotHolder(pba, pcfg))
  return paths


def test_inspector_summary_and_exports_match_jax(snapshots, tmp_path,
                                                 capsys):
  outputs = {}
  for name, main in (("jax", jinspector.main),
                     ("port", snapshot_inspector.main)):
    ply, poses = str(tmp_path / f"{name}.ply"), str(tmp_path / f"{name}.txt")
    assert main([snapshots[name], "--export_point_cloud", ply,
                 "--export_poses", poses]) in (0, None)
    with open(ply, "rb") as f:
      out = capsys.readouterr().out.replace(ply, "PLY").replace(poses, "TXT")
      outputs[name] = (out, f.read(), read_tum_trajectory(poses))
  summary = outputs["port"][0].splitlines()
  assert summary == outputs["jax"][0].splitlines()
  assert summary[0] == "badslam_tpu state snapshot v1"
  assert summary[3].startswith("keyframes: 2 ")
  assert outputs["port"][1] == outputs["jax"][1]
  (ts_p, poses_p), (ts_j, poses_j) = outputs["port"][2], outputs["jax"][2]
  np.testing.assert_array_equal(ts_p, ts_j)
  np.testing.assert_array_equal(poses_p[:, :3, 3], poses_j[:, :3, 3])
  np.testing.assert_allclose(poses_p, poses_j, rtol=0, atol=2e-7)


@pytest.mark.parametrize("mode", ["color", "normals"])
def test_inspector_renders_match_jax(snapshots, tmp_path, mode):
  jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
  assert jinspector.render_snapshot(
      np.load(snapshots["jax"]), jdir, mode, 2.5) == 2
  assert snapshot_inspector.main([
      snapshots["port"], "--render", pdir, "--render_mode", mode,
      "--splat_half_extent_in_pixels", "2.5", "--device", "cpu"]) == 0
  names = sorted(os.listdir(pdir))
  assert names == sorted(os.listdir(jdir)) and len(names) == 4
  for name in names:
    with open(os.path.join(jdir, name), "rb") as f, open(
        os.path.join(pdir, name), "rb") as g:
      assert f.read() == g.read(), name


def test_inspector_render_needs_a_gpu_unless_cpu_is_asked(snapshots,
                                                         tmp_path):
  if torch.cuda.is_available():
    pytest.skip("a CUDA device is visible: the refusal cannot be shown")
  with pytest.raises(SystemExit, match="no CUDA device is visible"):
    snapshot_inspector.main([snapshots["port"], "--render",
                             str(tmp_path / "r")])
  assert not os.path.exists(tmp_path / "r")
