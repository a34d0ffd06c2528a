"""Loop detection and closure.

Port of ``badslam_tpu/loop/detector.py`` (loop_detector.{h,cc} of the
original BAD SLAM):
  * features: ORB (FAST threshold 20 and rotated BRIEF) on the gray
    keyframe image, with each keypoint's depth (loop_detector.cc:97-128,
    744-757);
  * place recognition: DBoW2/DLoopDetector-style, alpha 0.15 on the
    normalized score, temporal consistency k = 1 over candidate islands,
    the recent keyframes excluded (:150-179). The vocabulary is trained
    online (``loop/bow.py``) once ``VOCAB_TRAIN_SIZE`` keyframes exist and
    retrained each time the database doubles; before that a 256-bit
    majority-vote signature short-lists the small database;
  * geometric verification: 3D-3D RANSAC (0.06 m, >= 10 inliers;
    :284-360);
  * direct refinement against the matched keyframe and its next and
    previous neighbours through ``slam.track_keyframe_pair``, then the
    mutual consistency gates (<= 10 degrees, <= 0.02 m; :436-604);
  * the depth-sanity gate (``loop/device_closure.py``), pose averaging and
    the "is BA enough" reprojection test (<= 1 px skips; :606-666);
  * the pose graph (``loop/pose_graph.py``) with every applied loop edge
    re-added and the odometry edges weighted, the trajectory deformation,
    and a planned repair BA (:670-705).

Everything up to RANSAC runs on the host (cv2 and numpy), on a detection
thread of its own unless ``parallel`` is False; the closing runs on the
thread that calls ``add_keyframe``, the main thread under sequential BA.

Under the pipelined front-end everything after RANSAC is one device program
(``loop/device_closure.verify_and_close``): the event reads
``device-pending`` until ``resolve_pending_device_events``, which
``BadSlam.finalize_pipelined`` calls, reads the outcomes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from badslam_tpu_torch.geometry import se3_np
from badslam_tpu_torch.loop import bow, device_closure
from badslam_tpu_torch.loop.pose_graph import PoseGraphOptimizer
from badslam_tpu_torch.loop.ransac import ransac_3d3d
from badslam_tpu_torch.loop.trajectory_deformation import (
    extrapolate_and_interpolate_keyframe_pose_changes,
    remember_keyframe_poses)
from badslam_tpu_torch.utils import logging as log
from badslam_tpu_torch.utils.timing import Timing
from badslam_tpu_torch.utils.transfer import to_device

NSS_ALPHA = 0.15                 # loop_detector.cc:161
FAST_THRESHOLD = 20              # loop_detector.cc:123
RANSAC_THRESHOLD = 0.06          # loop_detector.cc:310
RANSAC_MIN_INLIERS = 10          # loop_detector.cc:312
MAX_ANGLE_DIFFERENCE = np.pi / 180.0 * 10.0   # loop_detector.cc:577
MAX_EUCLIDEAN_DISTANCE = 0.02                 # loop_detector.cc:578
AVERAGE_PIXEL_DISTANCE_THRESHOLD = 1.0        # loop_detector.cc:655
NUM_FEATURES = 500               # ORB keypoints per keyframe
MIN_MATCH_COUNT = 20             # ratio-test matches to accept a candidate
MAX_CANDIDATES = 8               # short list for exact descriptor matching
VOCAB_TRAIN_SIZE = 30            # keyframes before the vocabulary is trained


@dataclasses.dataclass
class KeyframeEntry:
  kf_slot: int                 # index in the DirectBA keyframe store
  keypoints: np.ndarray        # (N, 2) float pixel positions (cv convention)
  depths: np.ndarray           # (N,) metric depth at the keypoint (0 invalid)
  descriptors: np.ndarray      # (N, 32) uint8 ORB descriptors
  signature: np.ndarray        # (32,) uint8 majority-vote global signature
  bow: "np.ndarray | None" = None   # (W,) L1-normalized TF-IDF BoW vector


@dataclasses.dataclass
class LoopClosureEvent:
  current_slot: int
  matched_slot: int
  inlier_count: int
  applied: bool
  reason: str
  # Norm of the applied constraint's translation (the measured distance
  # between the two camera centers).
  measured_t_norm: "float | None" = None


def _popcount_u8(x: np.ndarray) -> np.ndarray:
  lut = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                      axis=1).sum(axis=1)
  return lut[x]


class LoopDetector:
  """The original LoopDetector's surface: AddImage (``add_keyframe``),
  RemoveImage (``remove_keyframe``), the loop counters."""

  def __init__(self, config, camera, recent_exclude: int = 10,
               parallel: bool = False):
    import cv2
    self.config = config
    self.camera = camera
    self.orb = cv2.ORB_create(nfeatures=NUM_FEATURES,
                              fastThreshold=FAST_THRESHOLD)
    self.matcher = cv2.BFMatcher(cv2.NORM_HAMMING)
    self.entries: List[Optional[KeyframeEntry]] = []
    self.recent_exclude = recent_exclude
    self.num_loops_closed = 0
    self.num_loops_ignored = 0
    self.events: List[LoopClosureEvent] = []
    # The applied loop constraints (cur_slot, old_slot, cur_T_old), re-added
    # to every later pose graph so that verified closures stay pinned (the
    # original rebuilds each graph with the newest loop edge only).
    self.applied_loop_edges: List[tuple] = []
    # The pipelined front-end's twins: the device ring of applied loop
    # edges, and the device closures whose outcome is not read yet.
    self._device_loop_edges: Optional[tuple] = None
    self._pending_device_results: List[device_closure.DeviceClosureResult] = []

    # Retrieval: the vocabulary, once trained, and its inverted file, whose
    # entry ids are aligned with self.entries (holes are dead entries).
    self.vocab: Optional[bow.BinaryVocabulary] = None
    self._vocab_trained_on = 0
    self._inv_index: Optional[bow.InvertedIndex] = None
    self._indexed_upto = 0
    # The previous query's candidates, for temporal consistency.
    self._prev_cand_dbs: Optional[List[int]] = None

    # Parallel detection (loop_detector.h:162-166, DetectionThreadMain): a
    # thread of its own extracts features, queries and inserts into the
    # database for each queued image; add_keyframe pops the finished result
    # and does the closing itself. The thread touches host arrays only.
    self.parallel = parallel
    self._detector_lock = threading.Lock()   # guards self.entries
    self._det_cond = threading.Condition()
    self._det_queue: List = []
    self._det_results: List = []
    self._quit = False
    self._detection_thread: Optional[threading.Thread] = None
    if parallel:
      self._detection_thread = threading.Thread(
          target=self._detection_thread_main, daemon=True,
          name="loop-detection")
      self._detection_thread.start()

  def queue_for_detection(self, intensity: np.ndarray, depth: np.ndarray):
    """QueueForLoopDetection (loop_detector.h:208-214): called on the main
    thread as soon as the keyframe's host images exist. Must be paired 1:1,
    in order, with a later add_keyframe call."""
    assert self._detection_thread is not None
    with self._det_cond:
      self._det_queue.append((np.array(intensity, copy=True),
                              np.array(depth, copy=True)))
      self._det_cond.notify_all()

  def _detection_thread_main(self):
    while True:
      with self._det_cond:
        while not self._det_queue and not self._quit:
          self._det_cond.wait(timeout=0.1)
        if self._quit:
          return
        intensity, depth = self._det_queue.pop(0)
      # The slot is unknown until the keyframe is registered; add_keyframe
      # patches it when it consumes the result.
      entry = self._extract(-1, intensity, depth)
      with self._detector_lock:
        matched_db, count, matches = self._detect(entry)
        self.entries.append(entry)
        entry_index = len(self.entries) - 1
      with self._det_cond:
        self._det_results.append((entry_index, matched_db, count, matches))
        self._det_cond.notify_all()

  def request_exit_and_wait(self):
    """Stop the detection thread (nothing to do without one)."""
    if self._detection_thread is None:
      return
    with self._det_cond:
      self._quit = True
      self._det_cond.notify_all()
    self._detection_thread.join()
    self._detection_thread = None

  # --- feature extraction (loop_detector.cc:97-128, 729-757) ---

  def _extract(self, kf_slot: int, intensity: np.ndarray,
               depth: np.ndarray) -> KeyframeEntry:
    with Timing.time("Loop feature extraction"):
      gray = np.clip(intensity * 255.0 + 0.5, 0, 255).astype(np.uint8)
      keypoints, descriptors = self.orb.detectAndCompute(gray, None)
      if descriptors is None or len(keypoints) == 0:
        return KeyframeEntry(kf_slot, np.zeros((0, 2), np.float32),
                             np.zeros((0,), np.float32),
                             np.zeros((0, 32), np.uint8),
                             np.zeros((32,), np.uint8))
      pts = np.asarray([kp.pt for kp in keypoints], np.float32)
      h, w = depth.shape
      px = np.clip(pts[:, 0].astype(np.int32), 0, w - 1)
      py = np.clip(pts[:, 1].astype(np.int32), 0, h - 1)
      depths = depth[py, px].astype(np.float32)
      # Majority-vote signature: bit b is set iff >= half the descriptors set
      # it.
      bits = np.unpackbits(descriptors, axis=1)
      sig = np.packbits((bits.mean(axis=0) >= 0.5).astype(np.uint8))
      return KeyframeEntry(kf_slot, pts, depths, descriptors, sig)

  # --- retrieval ---

  def _maybe_train_vocabulary(self):
    """Online vocabulary training, with the detector lock held: once
    VOCAB_TRAIN_SIZE keyframes exist, fit the tree on all database
    descriptors, fit the IDF and fill in the BoW vectors. The vocabulary is
    retrained each time the database doubles past its last training size,
    which keeps it at most 2x stale (the reference measured recall 0.87
    with quadrupling and >= 0.95 with doubling at 400 keyframes); the fit
    is linear in the database, so the total training work stays <= 4x the
    last fit. The depth grows with the descriptor count."""
    live = [e for e in self.entries if e is not None and len(e.descriptors)]
    if len(live) < VOCAB_TRAIN_SIZE:
      return
    if self.vocab is not None and len(live) < 2 * self._vocab_trained_on:
      return
    all_desc = np.concatenate([e.descriptors for e in live])
    depth = 3 if len(all_desc) < 30_000 else 4
    vocab = bow.BinaryVocabulary(branching=10, depth=depth)
    vocab.fit(all_desc)
    word_lists = [vocab.transform(e.descriptors) for e in live]
    vocab.fit_idf(word_lists)
    for e in self.entries:
      if e is not None:
        e.bow = None  # vectors of the old word space
    for e, words in zip(live, word_lists):
      e.bow = vocab.bow_vector(words)
    self.vocab = vocab
    self._vocab_trained_on = len(live)
    self._inv_index = bow.InvertedIndex(vocab.num_words)
    self._indexed_upto = 0
    self._index_new_entries()
    log.debug(f"BoW vocabulary trained on {len(live)} keyframes "
              f"({len(all_desc)} descriptors, depth {depth}, "
              f"{vocab.num_words} words)")

  def _index_new_entries(self):
    """Append the entries not yet in the inverted file (ids stay
    aligned)."""
    while self._indexed_upto < len(self.entries):
      e = self.entries[self._indexed_upto]
      self._inv_index.add(
          self._bow_of(e) if e is not None and len(e.descriptors) else None)
      self._indexed_upto += 1

  def _bow_of(self, entry: KeyframeEntry) -> Optional[np.ndarray]:
    if self.vocab is None or len(entry.descriptors) == 0:
      return None
    if entry.bow is None:
      entry.bow = self.vocab.bow_vector(
          self.vocab.transform(entry.descriptors))
    return entry.bow

  def _detect(self, entry: KeyframeEntry) -> Tuple[Optional[int], int, list]:
    """(matched database index or None, match count, matches). The query's
    outcome is counted under "Loop query: <outcome>"."""
    with Timing.time("Loop database query"):
      matched, count, matches, outcome = self._query(entry)
    Timing.count(f"Loop query: {outcome}")
    return matched, count, matches

  def _query(self, entry: KeyframeEntry
             ) -> Tuple[Optional[int], int, list, str]:
    """``_detect``'s result and the gate that ended the query, or "sent to
    verification"."""
    self._maybe_train_vocabulary()
    usable = [
        (i, e) for i, e in enumerate(self.entries)
        if e is not None and len(e.descriptors) > 0
        and i < len(self.entries) - self.recent_exclude
    ]
    if len(entry.descriptors) == 0:
      return None, 0, [], "no features"
    if not usable:
      return None, 0, [], "no usable entry"

    # The normalizer: the temporally previous keyframe (DBoW2/DLoopDetector
    # normalized similarity score).
    prev_entry = None
    for e in reversed(self.entries):
      if e is not None and len(e.descriptors) > 0:
        prev_entry = e
        break

    if self.vocab is not None:
      # Stage 1: BoW scores through the inverted file.
      q = self._bow_of(entry)
      self._index_new_entries()
      scores_full = self._inv_index.query(q)
      scores = scores_full[np.asarray([i for i, _ in usable])]
      prev_bow = self._bow_of(prev_entry) if prev_entry is not None else None
      norm_score = (float(np.minimum(q, prev_bow).sum())
                    if prev_bow is not None else 1.0)
      # DLoopDetector's LOW_NSS_FACTOR: an unreliable normalizer (motion
      # blur, say) rejects the query instead of loosening the gate.
      if norm_score < 0.005:
        self._prev_cand_dbs = None
        return None, 0, [], "low normalizer"
      eta = scores / max(norm_score, 1e-6)
      order = np.argsort(-eta)[:MAX_CANDIDATES]
      best_db = usable[order[0]][0] if len(order) else None
      candidates = [usable[oi] for oi in order if eta[oi] >= NSS_ALPHA]
      # Temporal consistency k = 1 over candidate islands: a detection is
      # accepted only when some current candidate is index-near some
      # candidate of the previous query (comparing single best indices
      # rejected revisits of places with entries from several passes).
      cand_dbs = [i for i, _ in candidates]
      prev_cands = self._prev_cand_dbs
      consistent = prev_cands is not None and any(
          abs(c - p) <= 5 for c in cand_dbs for p in prev_cands)
      self._prev_cand_dbs = cand_dbs or (
          [best_db] if best_db is not None else [])
      if not candidates:
        return None, 0, [], "no candidate above NSS_ALPHA"
      if not consistent:
        return None, 0, [], "not consistent"
    else:
      # Small database: the 256-bit signature short-lists the candidates.
      sigs = np.stack([e.signature for _, e in usable])
      dist = _popcount_u8(sigs ^ entry.signature[None, :]).sum(axis=1)
      order = np.argsort(dist)[:MAX_CANDIDATES]
      norm_count = (self._match_count(entry, prev_entry)[0]
                    if prev_entry is not None else MIN_MATCH_COUNT)
      if norm_count < max(5, MIN_MATCH_COUNT // 4):
        return None, 0, [], "low normalizer"
      candidates = [usable[oi] for oi in order]

    # Stage 2: exact descriptor matching on the short list.
    best = (None, 0, [])
    for i, cand in candidates:
      count, matches = self._match_count(entry, cand)
      if count > best[1]:
        best = (i, count, matches)
    matched, count, matches = best
    if matched is None or count < MIN_MATCH_COUNT:
      return None, count, [], "too few matches"
    if self.vocab is None:
      if count / norm_count < NSS_ALPHA:
        return None, count, [], "below the NSS ratio"
    return matched, count, matches, "sent to verification"

  def _match_count(self, a: KeyframeEntry, b: KeyframeEntry):
    if len(a.descriptors) == 0 or len(b.descriptors) == 0:
      return 0, []
    knn = self.matcher.knnMatch(a.descriptors, b.descriptors, k=2)
    good = [m[0] for m in knn
            if len(m) == 2 and m[0].distance < 0.75 * m[1].distance
            and m[0].distance < 64]
    return len(good), good

  # --- public API ---

  def add_to_database(self, kf_slot: int, intensity: np.ndarray,
                      depth: np.ndarray) -> None:
    """Insert a keyframe without querying: the state-load path re-creates
    the database from the dataset images (io.cc:521). Unlike the original,
    which runs the full detect-and-close on every loaded keyframe
    afterwards, only keyframes made after the resume query the database:
    closing against a map that was just restored verbatim would only
    perturb it."""
    entry = self._extract(kf_slot, intensity, depth)
    with self._detector_lock:
      self.entries.append(entry)

  def remove_keyframe(self, kf_slot: int):
    """LoopDetector::RemoveImage: the keyframe in store slot ``kf_slot``
    was deleted by a keyframe merge. The detector lock serializes this
    against the detection thread (loop_detector.h:204-220)."""
    with self._detector_lock:
      for i, e in enumerate(self.entries):
        if e is not None and e.kf_slot == kf_slot:
          self.entries[i] = None
          if self._inv_index is not None and i < self._indexed_upto:
            self._inv_index.remove(i)

  def add_keyframe(self, kf_slot: int, intensity: np.ndarray,
                   depth: np.ndarray, slam) -> Optional[LoopClosureEvent]:
    """AddImage (loop_detector.cc:208-272): extract and query, or pop the
    detection thread's result (:242-268); then verify and close on the
    calling thread."""
    if self._detection_thread is not None:
      with Timing.time("Loop result wait"), self._det_cond:
        while not self._det_results:
          self._det_cond.wait(timeout=1.0)
          if not self._det_results and not self._detection_thread.is_alive():
            raise RuntimeError("loop detection thread died")
        entry_index, matched_db, count, matches = self._det_results.pop(0)
      with self._detector_lock:
        entry = self.entries[entry_index]
        entry.kf_slot = kf_slot
        matched_entry = (self.entries[matched_db]
                         if matched_db is not None else None)
      if matched_db is None:
        return None
    else:
      entry = self._extract(kf_slot, intensity, depth)
      matched_db, count, matches = self._detect(entry)
      self.entries.append(entry)
      if matched_db is None:
        return None
      matched_entry = self.entries[matched_db]
    if matched_entry is None:
      # The matched keyframe was merged away between detection and closing.
      return None
    with Timing.time("Loop verification"):
      event = self._verify_and_close(entry, matched_entry, matches, slam)
    # The reason without its measured values, so that one gate is one tag.
    Timing.count(f"Loop verification: {event.reason.split(' (')[0]}")
    self.events.append(event)
    if event.applied:
      self.num_loops_closed += 1
      log.info(f"loop closed: kf {event.current_slot} -> "
               f"{event.matched_slot} ({event.inlier_count} inliers; "
               f"total {self.num_loops_closed})")
    else:
      self.num_loops_ignored += 1
      log.debug(f"loop candidate rejected: kf {event.current_slot} -> "
                f"{event.matched_slot} ({event.reason})")
    return event

  # --- verification and closure (loop_detector.cc:284-705) ---

  def _unproject(self, pts: np.ndarray, depths: np.ndarray) -> np.ndarray:
    # The corner-convention unprojection applied to cv keypoint coordinates
    # (center convention), as the original does (loop_detector.cc:294-296):
    # the half-pixel offset is the same on both sides of every
    # correspondence and cancels in the relative pose.
    cam = self.camera
    nx = (pts[:, 0] - float(cam.cx)) / float(cam.fx)
    ny = (pts[:, 1] - float(cam.cy)) / float(cam.fy)
    return np.stack([depths * nx, depths * ny, depths], axis=-1)

  def _verify_and_close(self, cur: KeyframeEntry, old: KeyframeEntry,
                        matches, slam) -> LoopClosureEvent:
    def ev(applied, reason, inl=0):
      return LoopClosureEvent(cur.kf_slot, old.kf_slot, inl, applied, reason)

    # 3D-3D correspondences from the keypoint depths.
    ci = np.asarray([m.queryIdx for m in matches], np.int32)
    oi = np.asarray([m.trainIdx for m in matches], np.int32)
    ok = (cur.depths[ci] > 0) & (old.depths[oi] > 0)
    if ok.sum() < RANSAC_MIN_INLIERS:
      return ev(False, "too few matches with depth")
    cur_pts = self._unproject(cur.keypoints[ci[ok]], cur.depths[ci[ok]])
    old_pts = self._unproject(old.keypoints[oi[ok]], old.depths[oi[ok]])

    # A fixed seed per candidate, as the reference's default generator.
    old_T_cur, inliers = ransac_3d3d(
        cur_pts, old_pts, np.random.default_rng(0), RANSAC_THRESHOLD, 500,
        RANSAC_MIN_INLIERS)
    if old_T_cur is None:
      return ev(False, "RANSAC failed", int(inliers.sum()))
    n_inliers = int(inliers.sum())

    if slam.config.pipelined_frontend:
      # Everything past RANSAC runs as one device program; the outcome
      # stays on the device until finalize_pipelined.
      return self._verify_and_close_device(cur, old, old_T_cur, cur_pts,
                                           n_inliers, slam)

    # Direct refinement against the matched keyframe and its next and
    # previous neighbours. The pose state is read under the BA lock.
    ba = slam.direct_ba
    with slam._ba_lock:
      poses = ba.kf.global_T_frame.cpu().numpy()
      valid = ba._kf_valid_host.copy()
      k = ba.keyframe_count
    if not (0 <= old.kf_slot < k and valid[old.kf_slot]):
      return ev(False, "matched keyframe no longer valid")

    neighbors = [old.kf_slot]
    nxt = next((i for i in range(old.kf_slot + 1, k) if valid[i]), None)
    if nxt is None:
      return ev(False, "no next keyframe for verification", n_inliers)
    neighbors.append(nxt)
    prv = next((i for i in range(old.kf_slot - 1, -1, -1) if valid[i]), None)
    if prv is None:
      prv = next((i for i in range(nxt + 1, k) if valid[i]), None)
      if prv is None:
        return ev(False, "no second keyframe for verification", n_inliers)
    neighbors.append(prv)

    matched_frame_T_global = se3_np.inverse(poses[old.kf_slot])
    cur_T_old_refined = []
    for slot in neighbors:
      matched_T_this = (np.eye(4, dtype=np.float32) if slot == old.kf_slot
                        else matched_frame_T_global @ poses[slot])
      init = se3_np.inverse(old_T_cur) @ matched_T_this
      cur_T_tracked = slam.track_keyframe_pair(cur.kf_slot, slot, init)
      old_T_cur_ref = matched_T_this @ se3_np.inverse(cur_T_tracked)
      cur_T_old_refined.append(se3_np.inverse(old_T_cur_ref))

    # Mutual consistency gates (loop_detector.cc:575-604).
    for i in range(2):
      for j in range(i + 1, 3):
        zi = cur_T_old_refined[i][:3, 2]
        zj = cur_T_old_refined[j][:3, 2]
        ang = np.arccos(np.clip(zi @ zj, -1.0, 1.0))
        if ang > MAX_ANGLE_DIFFERENCE:
          return ev(False, f"refined rotations disagree ({ang:.3f} rad)",
                    n_inliers)
        dt = np.linalg.norm(cur_T_old_refined[i][:3, 3]
                            - cur_T_old_refined[j][:3, 3])
        if dt > MAX_EUCLIDEAN_DISTANCE:
          return ev(False, f"refined translations disagree ({dt:.3f} m)",
                    n_inliers)

    cur_T_old_avg = se3_np.average_poses(np.stack(cur_T_old_refined))

    # Depth-sanity gate: the refined alignment's depth fields must agree,
    # which rejects perceptual aliasing that passed the pose gates.
    calib = ba.calibration
    ratio, overlap = device_closure.alignment_depth_sanity(
        ba.kf.depth[cur.kf_slot], ba.kf.depth[old.kf_slot],
        torch.from_numpy(se3_np.inverse(cur_T_old_avg)).to(ba.device),
        calib.depth_intr, calib.baseline_fx)
    ratio, overlap = float(ratio), int(overlap)
    if (overlap < device_closure.DEPTH_SANITY_MIN_OVERLAP
        or ratio > device_closure.DEPTH_SANITY_RATIO):
      return ev(False, f"aligned depth fields disagree "
                f"(ratio {ratio:.2f}, overlap {overlap})", n_inliers)

    # "Is BA enough?" reprojection test (loop_detector.cc:624-666).
    cur_T_global_est = cur_T_old_avg @ matched_frame_T_global
    delta = cur_T_global_est @ poses[cur.kf_slot]
    moved = cur_pts @ delta[:3, :3].T + delta[:3, 3]
    cam = self.camera

    def project(p):
      z = p[:, 2]
      okz = z > 0
      return (np.stack([float(cam.fx) * p[:, 0] / np.where(okz, z, 1.0)
                        + float(cam.cx),
                        float(cam.fy) * p[:, 1] / np.where(okz, z, 1.0)
                        + float(cam.cy)], axis=-1), okz)

    pe, oke = project(moved)
    pc, okc = project(cur_pts)
    both = oke & okc
    if both.sum() >= 5:
      avg_px = float(np.linalg.norm(pe[both] - pc[both], axis=1).mean())
      if avg_px <= AVERAGE_PIXEL_DISTANCE_THRESHOLD:
        return ev(False, f"BA will absorb it (avg {avg_px:.2f} px)",
                  n_inliers)

    # Close the loop: pose graph and trajectory deformation. The odometry
    # edges carry the front-end's confidence (weak where the tracking-
    # failure gate fired), and every loop edge applied before re-enters
    # the graph.
    slot_map = [i for i in range(k) if valid[i]]
    graph_poses = poses[slot_map]
    odo_w = np.asarray([slam.keyframe_edge_weight.get(slot_map[i + 1], 1.0)
                        for i in range(len(slot_map) - 1)], np.float32)
    optimizer = PoseGraphOptimizer(graph_poses, odo_w, ba.device)
    optimizer.add_edge(slot_map.index(cur.kf_slot),
                       slot_map.index(old.kf_slot), cur_T_old_avg)
    for (pi, pj, pz) in self.applied_loop_edges:
      if pi in slot_map and pj in slot_map:
        optimizer.add_edge(slot_map.index(pi), slot_map.index(pj), pz)
    new_poses = optimizer.optimize()

    original = remember_keyframe_poses(graph_poses)
    # The application writes shared SLAM state under the BA lock, as the
    # original does with direct_ba_->Lock() (loop_detector.cc:670-705).
    with slam._ba_lock:
      full = poses.copy()
      for out_i, slot in enumerate(slot_map):
        full[slot] = new_poses[out_i]
      ba.kf = ba.kf._replace(
          global_T_frame=torch.from_numpy(full).to(ba.device))

      # Deform the trajectory of the frames between keyframes.
      frame_poses = [f.global_T_frame for f in slam.rgbd_video.frames]
      kf_frame_indices = [slam.keyframe_frame_indices[s] for s in slot_map]
      for out_i, slot in enumerate(slot_map):
        frame_poses[slam.keyframe_frame_indices[slot]] = new_poses[out_i]
      extrapolate_and_interpolate_keyframe_pose_changes(
          kf_frame_indices, original, new_poses, frame_poses,
          start_frame=0, end_frame=slam.last_frame_index)
      for i, p in enumerate(frame_poses):
        slam.rgbd_video.frames[i].global_T_frame = p
      if slam.base_kf_index is not None:
        slam.base_kf_global_T_frame = full[slam.base_kf_index]

    self.applied_loop_edges.append(
        (cur.kf_slot, old.kf_slot, np.asarray(cur_T_old_avg, np.float32)))
    # Map repair: a full BA budget re-converges the keyframes and the
    # surfels onto the corrected poses.
    slam.num_planned_ba_iterations += (
        slam.config.max_num_ba_iterations_per_keyframe)

    event = ev(True, "closed", n_inliers)
    event.measured_t_norm = float(np.linalg.norm(cur_T_old_avg[:3, 3]))
    return event

  def _verify_and_close_device(self, cur: KeyframeEntry, old: KeyframeEntry,
                               old_T_cur: np.ndarray, cur_pts: np.ndarray,
                               n_inliers: int, slam) -> LoopClosureEvent:
    """The pipelined front-end's verification and closure: the early gates
    read the store's host mirrors, then one device program refines, gates
    and applies the pose graph or not (``device_closure.verify_and_close``).
    The event's reason is ``device-pending`` until
    ``resolve_pending_device_events``; the caller plans the BA iterations
    that repair the map after it."""
    def ev(applied, reason, inl=0):
      return LoopClosureEvent(cur.kf_slot, old.kf_slot, inl, applied, reason)

    ba = slam.direct_ba
    k = ba.keyframe_count
    valid = ba._kf_valid_host
    if not (0 <= old.kf_slot < k and valid[old.kf_slot]):
      return ev(False, "matched keyframe no longer valid")
    nxt = next((i for i in range(old.kf_slot + 1, k) if valid[i]), None)
    if nxt is None:
      return ev(False, "no next keyframe for verification", n_inliers)
    prv = next((i for i in range(old.kf_slot - 1, -1, -1) if valid[i]), None)
    if prv is None:
      prv = next((i for i in range(nxt + 1, k) if valid[i]), None)
      if prv is None:
        return ev(False, "no second keyframe for verification", n_inliers)

    # The keypoints, padded to a fixed count.
    cap = device_closure.KEYPOINT_BUCKET
    n = min(len(cur_pts), cap)
    pts = np.zeros((cap, 3), np.float32)
    pts[:n] = cur_pts[:n]
    mask = np.zeros((cap,), bool)
    mask[:n] = True
    # Odometry edges between consecutive valid slots, padded to capacity - 1
    # with weight-0 self-edges (zero residual, zero Jacobian rows).
    slots = [i for i in range(k) if valid[i]]
    e_cap = max(1, ba.kf.capacity - 1)
    ei = np.zeros((e_cap,), np.int64)
    ej = np.zeros((e_cap,), np.int64)
    w = np.zeros((e_cap,), np.float32)
    for idx, (a_s, b_s) in enumerate(zip(slots[:-1], slots[1:])):
      ei[idx], ej[idx], w[idx] = a_s, b_s, 1.0

    # The closure's small inputs and the accumulated loop edges live on the
    # back-end's device, the mesh's first device under a mesh, where JAX
    # (:510-539) replicates them over the mesh: the closure reads keyframes
    # and poses only, which every shard replicates.
    dev = ba.device
    if self._device_loop_edges is None:
      self._device_loop_edges = device_closure.empty_loop_edges(dev)
    cam = self.camera
    calib = ba.calibration
    res = device_closure.verify_and_close(
        ba.kf.global_T_frame, ba.kf.depth,
        lambda base, tracked, init: slam.track_keyframe_pair_device(
            base, tracked, init, transfer_free=True),
        calib.depth_intr, calib.baseline_fx,
        cur.kf_slot, old.kf_slot, nxt, prv,
        to_device(np.asarray(old_T_cur, np.float32), dev),
        to_device(pts, dev), to_device(mask, dev),
        (float(cam.fx), float(cam.fy), float(cam.cx), float(cam.cy)),
        to_device(ei, dev), to_device(ej, dev), to_device(w, dev),
        slam.pipelined_state.edge_weight, self._device_loop_edges)
    ba.kf = ba.kf._replace(global_T_frame=res.global_T_frame)
    self._device_loop_edges = (res.loop_ei, res.loop_ej, res.loop_Z,
                               res.loop_w, res.loop_count)
    self._pending_device_results.append(res)
    return ev(False, "device-pending", n_inliers)

  def resolve_pending_device_events(self):
    """Read the device closures' outcomes (the pipelined run's finalize,
    in one read) and settle their events and the loop counters: a pending
    event was counted as ignored by add_keyframe."""
    if not self._pending_device_results:
      return
    log.info(f"resolving {len(self._pending_device_results)} pending "
             "device closure results")
    rows = torch.stack([torch.stack([
        r.applied.to(torch.float32), r.ba_enough.to(torch.float32),
        r.consistent.to(torch.float32), r.depth_sane.to(torch.float32),
        r.avg_px.to(torch.float32), r.t_norm.to(torch.float32)])
        for r in self._pending_device_results]).cpu().numpy()
    pending = iter(rows)
    for event in self.events:
      if event.reason != "device-pending":
        continue
      applied, ba_enough, consistent, depth_sane, avg_px, t_norm = (
          next(pending))
      if applied:
        event.applied = True
        event.reason = "closed"
        event.measured_t_norm = float(t_norm)
        self.num_loops_ignored -= 1
        self.num_loops_closed += 1
        log.info(f"loop closed on device: kf {event.current_slot} -> "
                 f"{event.matched_slot} ({event.inlier_count} inliers)")
      elif ba_enough:
        event.reason = f"BA will absorb it (avg {float(avg_px):.2f} px)"
      elif not consistent:
        event.reason = "refined estimates disagree"
      elif not depth_sane:
        event.reason = "aligned depth fields disagree"
      else:
        event.reason = "rejected on device"
    self._pending_device_results = []
