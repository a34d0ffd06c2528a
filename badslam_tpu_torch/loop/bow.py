"""Hierarchical binary bag-of-words vocabulary for loop-closure retrieval.

The port's own copy of ``badslam_tpu/loop/bow.py``, numpy backend only. The
original ships DBoW2 with a pre-trained BRIEF vocabulary (k = 10, L = 6;
loop_detector.cc:150-179); instead the vocabulary is trained online from the
map's own ORB descriptors once enough keyframes exist: hierarchical
k-medians over binary descriptors (the bitwise majority vote is the
Hamming-metric centroid), DBoW2's construction without the offline corpus.

Scoring is DBoW2's L1 score s(v, w) = 1 - 0.5 |v/|v|_1 - w/|w|_1|_1 of
TF-IDF word histograms; the detector normalizes a query's scores by its
score against the temporally previous keyframe (DLoopDetector's normalized
similarity score) with the original's alpha = 0.15.

The reference can build the tree with a native library
(``native/libbadslam_native.so``); the port always uses this numpy code, so
one seed gives one tree on every machine, and the tree equals the
reference's ``BinaryVocabulary(backend="numpy")`` bit for bit. Everything
here runs on the host, on the loop-detection thread.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def hamming_to_centers(bits: np.ndarray, centers: np.ndarray) -> np.ndarray:
  """(N, B) unpacked bits against (K, B) unpacked centers -> (N, K)
  distances."""
  # Hamming = B - (agreeing ones) - (agreeing zeros), as two products.
  b = bits.astype(np.float32)
  c = centers.astype(np.float32)
  agree = b @ c.T + (1.0 - b) @ (1.0 - c.T)
  return bits.shape[1] - agree


def _kmedians(bits: np.ndarray, k: int, rng: np.random.Generator,
              iters: int = 8) -> np.ndarray:
  """Binary k-medians: majority-vote centroids under the Hamming distance.
  Returns (k', B) centers, k' <= k when there are few distinct points."""
  n = bits.shape[0]
  if n <= k:
    return np.unique(bits, axis=0)
  centers = bits[rng.choice(n, size=k, replace=False)].copy()
  for _ in range(iters):
    d = hamming_to_centers(bits, centers)
    assign = d.argmin(axis=1)
    new_centers = []
    for j in range(len(centers)):
      members = bits[assign == j]
      if len(members) == 0:
        # An empty cluster is re-seeded on the farthest point.
        new_centers.append(bits[d.min(axis=1).argmax()])
      else:
        new_centers.append((members.mean(axis=0) >= 0.5).astype(np.uint8))
    new_centers = np.stack(new_centers)
    if np.array_equal(new_centers, centers):
      break
    centers = new_centers
  return centers


class BinaryVocabulary:
  """Hierarchical k-medians tree over binary descriptors.

  Nodes are stored flat: node i has centers ``self.centers[i]`` (K_i, B) and
  children ``self.children[i]``, node ids or leaf word ids encoded as the
  negative numbers -(word + 1).
  """

  def __init__(self, branching: int = 10, depth: int = 3, seed: int = 0):
    self.branching = branching
    self.depth = depth
    self.seed = seed
    self.centers: List[np.ndarray] = []
    self.children: List[List[int]] = []
    self.num_words = 0
    self.idf: Optional[np.ndarray] = None

  def fit(self, descriptors: np.ndarray) -> "BinaryVocabulary":
    """descriptors: (N, 32) uint8, packed."""
    rng = np.random.default_rng(self.seed)
    bits = np.unpackbits(descriptors, axis=1)
    self.centers, self.children = [], []
    self.num_words = 0
    self._build(bits, self.depth, rng)
    return self

  def _build(self, bits: np.ndarray, depth: int,
             rng: np.random.Generator) -> int:
    """Returns the node id (>= 0) or the leaf's word encoding (< 0)."""
    if depth == 0 or len(bits) <= self.branching:
      word = self.num_words
      self.num_words += 1
      return -(word + 1)
    centers = _kmedians(bits, self.branching, rng)
    node = len(self.centers)
    self.centers.append(centers)
    self.children.append([])
    assign = hamming_to_centers(bits, centers).argmin(axis=1)
    kids = []
    for j in range(len(centers)):
      members = bits[assign == j]
      if len(members) == 0:
        word = self.num_words
        self.num_words += 1
        kids.append(-(word + 1))
      else:
        kids.append(self._build(members, depth - 1, rng))
    self.children[node] = kids
    return node

  def transform(self, descriptors: np.ndarray) -> np.ndarray:
    """(N, 32) packed -> (N,) word ids."""
    if len(descriptors) == 0:
      return np.zeros((0,), np.int32)
    bits = np.unpackbits(descriptors, axis=1)
    out = np.zeros(len(bits), np.int32)
    if not self.centers:  # a one-word vocabulary
      return out
    # Descent node by node, vectorized over the descriptors at each node.
    stack = [(0, np.arange(len(bits)))]
    while stack:
      node, idx = stack.pop()
      assign = hamming_to_centers(bits[idx], self.centers[node]).argmin(axis=1)
      for j, child in enumerate(self.children[node]):
        sel = idx[assign == j]
        if len(sel) == 0:
          continue
        if child < 0:
          out[sel] = -(child + 1)
        else:
          stack.append((child, sel))
    return out

  def fit_idf(self, word_lists: List[np.ndarray]):
    """Inverse document frequency from the database's word sets."""
    df = np.zeros(self.num_words, np.float64)
    for words in word_lists:
      df[np.unique(words)] += 1.0
    n = max(1, len(word_lists))
    self.idf = np.log(n / np.maximum(df, 1.0)).astype(np.float32) + 1e-3

  def bow_vector(self, words: np.ndarray) -> np.ndarray:
    """L1-normalized TF-IDF histogram (W,) float32."""
    v = np.bincount(words, minlength=self.num_words).astype(np.float32)
    if self.idf is not None:
      v = v * self.idf
    s = v.sum()
    return v / s if s > 0 else v


def l1_score(v: np.ndarray, db: np.ndarray) -> np.ndarray:
  """DBoW2's L1 similarity of a query v (W,) against rows db (D, W), both
  L1-normalized: s = 1 - 0.5 |v - w|_1, in [0, 1]."""
  return 1.0 - 0.5 * np.abs(db - v[None, :]).sum(axis=1)


class InvertedIndex:
  """DBoW2's inverted file: word -> postings of (entry id, tf-idf weight).

  For L1-normalized nonnegative vectors 1 - 0.5 |v - w|_1 = sum_i min(v_i,
  w_i), which only shared words contribute to, so a query visits the
  postings of its own words and no other row (DBoW2
  TemplatedDatabase::queryL1). Entries are append-only with tombstones, as
  the detector's slots are.
  """

  def __init__(self, num_words: int):
    self.num_words = num_words
    self._postings: List[List] = [[] for _ in range(num_words)]
    self._alive: List[bool] = []

  def add(self, bow: Optional[np.ndarray]) -> int:
    """Insert an L1-normalized TF-IDF vector and return its entry id. None
    reserves a dead entry, so that ids stay aligned with a store that has
    holes."""
    entry = len(self._alive)
    if bow is None:
      self._alive.append(False)
      return entry
    self._alive.append(True)
    for w in np.flatnonzero(bow):
      self._postings[w].append((entry, float(bow[w])))
    return entry

  def remove(self, entry: int):
    if 0 <= entry < len(self._alive):
      self._alive[entry] = False

  def query(self, bow: np.ndarray) -> np.ndarray:
    """Scores (num_entries,) of the query against every entry; dead entries
    score 0."""
    scores = np.zeros(len(self._alive), np.float32)
    for w in np.flatnonzero(bow):
      qv = bow[w]
      for entry, wv in self._postings[w]:
        scores[entry] += min(qv, wv)
    if self._alive and not all(self._alive):
      scores[~np.asarray(self._alive)] = 0.0
    return scores
