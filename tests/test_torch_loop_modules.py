"""The port's loop-closure modules against the JAX package's, on the same
numpy inputs (CPU, 160x120): RANSAC and Umeyama, the BoW vocabulary and the
inverted index, the pose graph, the depth-sanity gate, pose averaging and
the dataset's frame rate, the detector's feature extraction and retrieval
on a recorded sequence, and its detection thread.

Tolerances: RANSAC, Umeyama, the vocabulary tree, word lists, IDF, BoW
vectors, keyframe entries and retrieval results are equal bit for bit (both
packages run the same numpy and the same cv2); the inverted index equals
the dense L1 score within 1e-6; the pose graph's poses agree within 1e-5 m
and 1e-5 rad; the depth-sanity ratio within 1e-5 relative, its overlap
count exactly; averaged poses within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from badslam_tpu.config import BadSlamConfig as JaxConfig
from badslam_tpu.geometry import se3 as jse3
from badslam_tpu.geometry import se3_np as jse3_np
from badslam_tpu.loop import bow as jbow
from badslam_tpu.loop import device_closure as jclosure
from badslam_tpu.loop import ransac as jransac
from badslam_tpu.loop.detector import LoopDetector as JaxDetector
from badslam_tpu.loop.pose_graph import PoseGraphOptimizer as JaxGraph
from badslam_tpu.utils import synthetic as jsynthetic
from badslam_tpu_torch.config import BadSlamConfig
from badslam_tpu_torch.geometry import se3, se3_np
from badslam_tpu_torch.loop import bow, device_closure, ransac
from badslam_tpu_torch.loop.detector import LoopDetector
from badslam_tpu_torch.loop.pose_graph import PoseGraphOptimizer
from badslam_tpu_torch.utils import synthetic

torch.set_num_threads(2)

W, H = 160, 120
# The recorded sequence: 32 keyframes creeping away from the start, then
# two revisits of it (the temporal-consistency gate needs two consecutive
# queries), so that the trained-vocabulary path (>= 30 entries) runs.
AWAY = 32


def _pose(tangent) -> np.ndarray:
  return se3.exp(torch.tensor(tangent, dtype=torch.float32)).numpy()


@pytest.fixture(scope="module")
def sequence():
  """(intensity, metric depth) of the checker-textured plane world."""
  cam = synthetic.default_test_camera(W, H)
  normals = synthetic.plane_world_normals()
  traj = [_pose([0.012 * i, 0.004 * i, 0, 0.003 * i, 0, 0])
          for i in range(AWAY)]
  traj += [_pose([0.004, 0.001, 0, 0, 0, 0]), traj[0]]
  images = []
  for T in traj:
    depth = synthetic.render_planes(cam, T, normals,
                                    raw_to_float_depth=1.0 / 5000.0)
    images.append((synthetic.render_intensity(cam, T, depth, kind="checker"),
                   depth))
  return cam, images


def test_umeyama_and_ransac_equal_the_reference_bit_for_bit():
  rng = np.random.default_rng(0)
  T_gt = _pose(np.concatenate([rng.uniform(-1, 1, 3),
                               rng.uniform(-0.5, 0.5, 3)]))
  src = rng.uniform(-2, 2, (80, 3)).astype(np.float32)
  dst = src @ T_gt[:3, :3].T + T_gt[:3, 3]
  dst[:24] += rng.uniform(0.5, 2.0, (24, 3))
  np.testing.assert_array_equal(ransac.umeyama_alignment(src, dst),
                                jransac.umeyama_alignment(src, dst))
  T, inliers = ransac.ransac_3d3d(src, dst, np.random.default_rng(5))
  Tj, inliers_j = jransac.ransac_3d3d(src, dst, rng=np.random.default_rng(5))
  assert T is not None and T.dtype == Tj.dtype
  np.testing.assert_array_equal(T, Tj)
  np.testing.assert_array_equal(inliers, inliers_j)
  assert np.abs(T - T_gt).max() < 1e-3
  # Garbage: both refuse.
  noise = rng.uniform(-2, 2, (40, 3)).astype(np.float32)
  assert ransac.ransac_3d3d(src[:40], noise,
                            np.random.default_rng(1))[0] is None
  assert jransac.ransac_3d3d(src[:40], noise,
                             rng=np.random.default_rng(1))[0] is None


def test_vocabulary_equals_the_reference_numpy_backend(sequence):
  cam, images = sequence
  det = LoopDetector(BadSlamConfig(), cam)
  desc = np.concatenate([det._extract(i, *img).descriptors
                         for i, img in enumerate(images[:12])])
  assert len(desc) > 1000
  port = bow.BinaryVocabulary(branching=10, depth=3).fit(desc)
  ref = jbow.BinaryVocabulary(branching=10, depth=3,
                              backend="numpy").fit(desc)
  assert port.num_words == ref.num_words > 100
  assert port.children == ref.children
  assert len(port.centers) == len(ref.centers)
  for a, b in zip(port.centers, ref.centers):
    np.testing.assert_array_equal(a, b)
  words = [port.transform(desc[i::7]) for i in range(7)]
  for w, d in zip(words, (desc[i::7] for i in range(7))):
    np.testing.assert_array_equal(w, ref.transform(d))
  port.fit_idf(words)
  ref.fit_idf(words)
  np.testing.assert_array_equal(port.idf, ref.idf)
  for w in words:
    np.testing.assert_array_equal(port.bow_vector(w), ref.bow_vector(w))
  np.testing.assert_array_equal(
      bow.hamming_to_centers(np.unpackbits(desc[:50], axis=1),
                             port.centers[0]),
      jbow.hamming_to_centers(np.unpackbits(desc[:50], axis=1),
                              ref.centers[0]))


def test_inverted_index_equals_the_dense_l1_score_with_holes():
  rng = np.random.default_rng(3)
  words, entries = 97, 23

  def rand_bow():
    v = np.zeros(words, np.float32)
    idx = rng.choice(words, size=8, replace=False)
    v[idx] = rng.uniform(0.1, 1.0, 8).astype(np.float32)
    return v / v.sum()

  db = [rand_bow() for _ in range(entries)]
  index, ref = bow.InvertedIndex(words), jbow.InvertedIndex(words)
  for i, v in enumerate(db):
    hole = i == 7
    assert index.add(None if hole else v) == ref.add(None if hole else v) == i
  index.remove(11)
  ref.remove(11)
  q = rand_bow()
  got = index.query(q)
  np.testing.assert_array_equal(got, ref.query(q))
  want = bow.l1_score(q, np.stack(db))
  np.testing.assert_array_equal(want, jbow.l1_score(q, np.stack(db)))
  for i in range(entries):
    if i in (7, 11):
      assert got[i] == 0.0
    else:
      np.testing.assert_allclose(got[i], want[i], atol=1e-6)


def test_pose_graph_matches_the_reference_lm():
  """A drifted 8-keyframe chain with weak edges 3 and 4, a loop edge from
  the last keyframe to the first and one from 5 to 1."""
  k = 8
  rng = np.random.default_rng(2)
  gt = [np.asarray(jse3.exp(jnp.asarray(
      [0.1 * i, 0.05 * np.sin(0.6 * i), 0.0, 0.0, 0.0, 0.12 * i],
      jnp.float32))) for i in range(k)]
  drifted = [gt[0]]
  for i in range(1, k):
    z = np.linalg.inv(gt[i - 1]) @ gt[i]
    noise = np.asarray(jse3.exp(jnp.asarray(np.concatenate(
        [rng.normal(0, 0.01, 3), rng.normal(0, 0.004, 3)]), jnp.float32)))
    drifted.append((drifted[-1] @ z @ noise).astype(np.float32))
  drifted = np.stack(drifted)
  weights = np.ones(k - 1, np.float32)
  weights[2:4] = 0.05
  results = []
  for graph in (PoseGraphOptimizer(drifted, weights, "cpu"),
                JaxGraph(drifted, True, odometry_weights=weights)):
    graph.add_edge(k - 1, 0, (np.linalg.inv(gt[k - 1]) @ gt[0]).astype(
        np.float32))
    graph.add_edge(5, 1, (np.linalg.inv(gt[5]) @ gt[1]).astype(np.float32))
    results.append(graph.optimize())
  port, ref = results
  assert np.abs(port - drifted).max() > 1e-2  # the graph moved the chain
  np.testing.assert_allclose(port[:, :3, 3], ref[:, :3, 3], rtol=0,
                             atol=1e-5)
  rel = np.linalg.inv(ref.astype(np.float64)) @ port
  rot = se3.log(torch.from_numpy(rel.astype(np.float32)))[:, 3:].norm(dim=-1)
  assert float(rot.max()) <= 1e-5
  np.testing.assert_array_equal(port[0], drifted[0])  # the gauge


def _sanity_cases():
  cam = synthetic.default_test_camera(W, H)
  normals = synthetic.plane_world_normals()
  T0 = np.eye(4, dtype=np.float32)
  T1 = _pose([0.02, -0.01, 0.01, 0.01, -0.02, 0.005])
  d0 = synthetic.render_planes(cam, T0, normals)
  d1 = synthetic.render_planes(cam, T1, normals)
  intr = np.array([float(cam.fx), float(cam.fy), float(cam.cx),
                   float(cam.cy)], np.float32)
  true_rel = (np.linalg.inv(T0) @ T1).astype(np.float32)   # old_T_cur
  off = true_rel @ _pose([0.05, 0.0, 0.0, 0.0, 0.03, 0.0])
  # Every warped coordinate on a tie: a fronto-parallel plane at 2 m,
  # fx = 64 and a shift of 1/64 m put u at x + 0.5 exactly, so rounding
  # half to even and rounding half up sample different columns.
  flat = np.full((H, W), 2.0, np.float32)
  stripes = flat + 0.05 * (np.arange(W) % 2)[None, :].astype(np.float32)
  tie_intr = np.array([64.0, 64.0, 79.5, 59.5], np.float32)
  shift = np.eye(4, dtype=np.float32)
  shift[0, 3] = 1.0 / 64.0
  return [("true pose", d1, d0, true_rel, intr),
          ("offset pose", d1, d0, off, intr),
          ("ties", flat, stripes, shift, tie_intr)]


@pytest.mark.parametrize("case", [c[0] for c in _sanity_cases()])
def test_alignment_depth_sanity_matches_the_reference(case):
  _, cur, old, old_T_cur, intr = next(c for c in _sanity_cases()
                                      if c[0] == case)
  ratio, n = device_closure.alignment_depth_sanity(
      torch.from_numpy(cur), torch.from_numpy(old),
      torch.from_numpy(old_T_cur), torch.from_numpy(intr),
      torch.tensor(40.0))
  ratio_j, n_j = jclosure.alignment_depth_sanity(
      jnp.asarray(cur), jnp.asarray(old), jnp.asarray(old_T_cur),
      jnp.asarray(intr), jnp.asarray(40.0, jnp.float32))
  assert int(n) == int(n_j) > device_closure.DEPTH_SANITY_MIN_OVERLAP
  np.testing.assert_allclose(float(ratio), float(ratio_j), rtol=1e-5)
  if case == "true pose":
    assert float(ratio) < 0.2 * device_closure.DEPTH_SANITY_RATIO
  if case == "ties":
    # Half to even lands on even columns (depth 2.0, no mismatch) where
    # half up would land on odd ones (2.05).
    assert float(ratio) < 1e-3
  assert (device_closure.DEPTH_SANITY_RATIO,
          device_closure.DEPTH_SANITY_MIN_OVERLAP) == (
              jclosure.DEPTH_SANITY_RATIO, jclosure.DEPTH_SANITY_MIN_OVERLAP)


def test_average_poses_and_dataset_fps_match_the_reference():
  rng = np.random.default_rng(4)
  poses = np.stack([_pose(rng.normal(0, 0.05, 6)) for _ in range(3)])
  np.testing.assert_allclose(se3_np.average_poses(poses),
                             jse3_np.average_poses(poses), atol=1e-6)
  cam = synthetic.default_test_camera(32, 24)
  traj = [_pose([0.001 * i, 0, 0, 0, 0, 0]) for i in range(4)]
  for fps in (15.0, 30.0, 60.0):
    port = synthetic.make_synthetic_video(cam, traj, np.eye(3)[2:] * -1,
                                          fps=fps)
    ref = jsynthetic.make_synthetic_video(jsynthetic.default_test_camera(
        32, 24), traj, np.eye(3)[2:] * -1, fps=fps)
    assert port.fps() == ref.fps()
    for fp, fj in zip(port.frames, ref.frames):
      np.testing.assert_array_equal(fp.depth_raw(), fj.depth_raw())
      np.testing.assert_array_equal(fp.rgb(), fj.rgb())


def test_extract_and_detect_equal_the_reference_on_a_recorded_sequence(
    sequence, monkeypatch):
  """Feature extraction and retrieval with no SLAM: each image is
  extracted, queried and appended in both packages. The vocabulary trains
  at the 31st query, so the revisits at the end go through the inverted
  file and the temporal-consistency gate."""
  monkeypatch.setattr(jbow, "native_vocab_lib", lambda: None)
  cam, images = sequence
  port = LoopDetector(BadSlamConfig(), cam)
  ref = JaxDetector(JaxConfig(), jsynthetic.default_test_camera(W, H))
  results = []
  for i, (intensity, depth) in enumerate(images):
    entries = [det._extract(i, intensity, depth) for det in (port, ref)]
    for name in ("keypoints", "depths", "descriptors", "signature"):
      np.testing.assert_array_equal(getattr(entries[0], name),
                                    getattr(entries[1], name))
    found = [det._detect(e) for det, e in zip((port, ref), entries)]
    assert found[0][:2] == found[1][:2], (i, found[0][:2], found[1][:2])
    assert ([(m.queryIdx, m.trainIdx) for m in found[0][2]]
            == [(m.queryIdx, m.trainIdx) for m in found[1][2]])
    port.entries.append(entries[0])
    ref.entries.append(entries[1])
    results.append(found[0][:2])
  assert port.vocab is not None and ref.vocab is not None
  assert port.vocab.num_words == ref.vocab.num_words
  for a, b in zip(port.entries, ref.entries):
    np.testing.assert_array_equal(a.bow, b.bow)
  # The second revisit closes on the start through the BoW path.
  matched, count = results[-1]
  assert matched is not None and matched <= 2 and count >= 20, results[-3:]


def test_detection_thread_orders_results_and_patches_slots(sequence):
  """Images queued on the main thread are extracted and queried on the
  detection thread; add_keyframe pops the results in order and patches the
  real keyframe slots (the twin of the reference's
  test_parallel_detection_thread_orders_and_patches_slots)."""
  cam, images = sequence
  det = LoopDetector(BadSlamConfig(), cam, recent_exclude=10, parallel=True)
  ref = JaxDetector(JaxConfig(), jsynthetic.default_test_camera(W, H))
  try:
    for intensity, depth in images[:4]:
      det.queue_for_detection(intensity, depth)
    # Four entries inside the recency window cannot match, so add_keyframe
    # returns None without a SLAM system.
    for (intensity, depth), slot in zip(images[:4], [5, 9, 11, 12]):
      assert det.add_keyframe(slot, intensity, depth, slam=None) is None
    assert [e.kf_slot for e in det.entries] == [5, 9, 11, 12]
    for e, (intensity, depth) in zip(det.entries, images[:4]):
      want = ref._extract(-1, intensity, depth)
      np.testing.assert_array_equal(e.signature, want.signature)
      np.testing.assert_array_equal(e.descriptors, want.descriptors)
    det.remove_keyframe(9)
    assert det.entries[1] is None
  finally:
    det.request_exit_and_wait()
  assert det._detection_thread is None


def test_a_dead_detection_thread_raises_instead_of_hanging(sequence):
  cam, images = sequence
  det = LoopDetector(BadSlamConfig(), cam, parallel=True)

  def broken(*_):
    raise ValueError("extraction failed")

  det._extract = broken
  det.queue_for_detection(*images[0])
  with pytest.raises(RuntimeError, match="loop detection thread died"):
    det.add_keyframe(0, *images[0], slam=None)
  det.request_exit_and_wait()
