"""Matrix-free preconditioned conjugate gradients for the joint BA system.

Port of ``badslam_tpu/models/pcg.py`` (direct_ba_pcg.cc of the original BAD
SLAM: the algorithm's derivation :62-119, the layout of the unknowns
:240-307, the solver loop :339-471, the kDebugVerifyResult self-check
:476-550, the delta's application :552-646; and kernel_pcg.cu: PCGInit
:180+, the a-prior rows :587-591, PCGStep1 g = J^T W (J p) :646+,
kDiagEpsilon = 1e-8 :44, kAPriorWeight = 10 :48).

Unknowns: 6 per keyframe pose (one keyframe, ``gauge_index``, is held fixed
for the gauge), 3 per surfel (the position's offset along the normal,
descriptor 1, descriptor 2) and, when the flags ask for them, 5 depth
intrinsics unknowns (fx_inv, fy_inv, cx_inv, cy_inv, a), one cfactor unknown
per sparsification cell and 4 color intrinsics unknowns (fx, fy, cx, cy). A
weak prior of weight kAPriorWeight pulls the updated ``a`` toward zero.

One Hessian-vector product is one pass over the keyframes that take part
(valid, and active or covisible-active), in slot order, of dense per-surfel
arithmetic: J p combines the pose block (a 6-dot), the surfel block
(elementwise) and the intrinsics blocks; J^T W (J p) goes back into the pose
and intrinsics rows (matrix products), the surfel rows (elementwise adds)
and the cfactor rows (a sum by cell in a fixed order, ``ops/segment.py``).

The residual terms and Jacobian rows of a keyframe depend on the map state
only, not on the vector the Hessian is applied to, so one solve computes
them once per keyframe (``KeyframeTerms``) and every product of its up to
30 iterations reads them. They take about 200 bytes per surfel slot and
keyframe; where that would not fit into half of the free device memory they
are recomputed in every pass instead, which gives the same bits.

Over a device mesh (``parallel/sharded_ba.py``, ``parallel/spmd.py``)
``axis_name`` names the mesh axis the surfel unknowns are sharded over and
``kf_axis`` the one the keyframes and their pose unknowns are sharded over.
The pose and intrinsics rows that a shard accumulates from its surfels are
summed over ``axis_name``, the surfel and intrinsics rows it accumulates from
its keyframes over ``kf_axis`` (``_psum_replicated``), and the dot products
sum their sharded parts; the surfel rows never leave their shard. With
neither axis every result is what it is without a mesh.
"""

from __future__ import annotations

from typing import Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.intrinsics_opt import (
    A_PRIOR_WEIGHT, depth_intrinsics_jacobian, inverse_parameter_update)
from badslam_tpu_torch.models.keyframes import COVISIBLE_ACTIVE, KeyframeStore
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops.segment import SegmentPlan, plan_segments
from badslam_tpu_torch.parallel import spmd
from badslam_tpu_torch.utils.transfer import DonePoll

DIAG_EPSILON = 1e-8     # kDiagEpsilon (kernel_pcg.cu:44)
N_DINTR = 5             # fx_inv, fy_inv, cx_inv, cy_inv, a
N_CINTR = 4             # fx, fy, cx, cy
# What one keyframe's held terms take per surfel slot (45 floats and the
# cell's row of the segment plan), rounded up.
TERM_BYTES_PER_SLOT = 200
# Terms are held on a CPU device up to this size.
CPU_TERM_BUDGET_BYTES = 1 << 30


class PCGVector(NamedTuple):
  """The layout of the unknown and residual vectors."""
  poses: torch.Tensor   # (K, 6)
  spos: torch.Tensor    # (N,)  position offset along the surfel normal
  sdesc: torch.Tensor   # (N, 2)
  dintr: torch.Tensor   # (5,)  depth fx_inv, fy_inv, cx_inv, cy_inv, a
  cfac: torch.Tensor    # (C,)  flattened per-cell cfactor deltas
  cintr: torch.Tensor   # (4,)  color fx, fy, cx, cy

  def __add__(self, other):
    return PCGVector(*(a + b for a, b in zip(self, other)))

  def __sub__(self, other):
    return PCGVector(*(a - b for a, b in zip(self, other)))

  def scale(self, s):
    return PCGVector(*(s * a for a in self))

  def mul(self, other):
    return PCGVector(*(a * b for a, b in zip(self, other)))

  def dot(self, other, axis_name: Optional[str] = None,
          kf_axis: Optional[str] = None) -> torch.Tensor:
    if axis_name is not None or kf_axis is not None:
      # The surfel blocks are sharded along the surfel axis and, once
      # psum'd over the kf axis, replicated along it; the pose blocks are
      # sharded along the kf axis and replicated along the surfel axis; the
      # intrinsics blocks are replicated everywhere.
      d = torch.sum(self.spos * other.spos) + torch.sum(
          self.sdesc * other.sdesc)
      if axis_name is not None:
        d = spmd.psum(d, axis_name)
      dp = torch.sum(self.poses * other.poses)
      if kf_axis is not None:
        dp = spmd.psum(dp, kf_axis)
      return (d + dp + torch.sum(self.dintr * other.dintr)
              + torch.sum(self.cfac * other.cfac)
              + torch.sum(self.cintr * other.cintr))
    return (torch.sum(self.spos * other.spos)
            + torch.sum(self.sdesc * other.sdesc)
            + torch.sum(self.poses * other.poses)
            + torch.sum(self.dintr * other.dintr)
            + torch.sum(self.cfac * other.cfac)
            + torch.sum(self.cintr * other.cintr))


def zeros_like_vec(k: int, n: int, c: int = 1, device=None) -> PCGVector:
  def z(*shape):
    return torch.zeros(shape, dtype=torch.float32, device=device)
  return PCGVector(z(k, 6), z(n), z(n, 2), z(N_DINTR), z(c), z(N_CINTR))


class _Terms(NamedTuple):
  """One keyframe's residual terms, shared by all passes of a solve. Every
  field is already zero outside its mask (the depth residual's ``mask``,
  the descriptor residuals' ``dmask``, the depth intrinsics' ``dimask``), so
  a lane that does not take part adds an exact 0.0 everywhere."""
  depth_r: torch.Tensor    # (N,)
  depth_w: torch.Tensor    # (N,)
  depth_Jp: torch.Tensor   # (N, 6) wrt the pose
  depth_Js: torch.Tensor   # (N,)  wrt the surfel's offset
  r1: torch.Tensor
  w1: torch.Tensor
  r2: torch.Tensor
  w2: torch.Tensor
  J1p: torch.Tensor        # (N, 6)
  J2p: torch.Tensor
  J1s: torch.Tensor        # (N,)
  J2s: torch.Tensor
  # The descriptor residual's Jacobian wrt its own channel is the constant -1.
  # Intrinsics blocks (None unless enabled):
  w_di: Optional[torch.Tensor]      # (N,) depth weight inside dimask
  Jdi: Optional[torch.Tensor]       # (N, 5) wrt [fx_inv..cy_inv, a]
  jcf: Optional[torch.Tensor]       # (N,) wrt the hit pixel's cfactor cell
  cell_id: Optional[torch.Tensor]   # (N,) int64 flattened cfactor cell
  cells: Optional[SegmentPlan]      # sums over cell_id inside dimask
  J1c: Optional[torch.Tensor]       # (N, 4) descriptor 1 wrt color intrinsics
  J2c: Optional[torch.Tensor]


def _a_row(device) -> torch.Tensor:
  """(N_DINTR,) one-hot on ``a``, made on the device (writing 1.0 through an
  index would copy it from the host and wait for the stream)."""
  return (torch.arange(N_DINTR, device=device) == 4).to(torch.float32)


def _masked(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
  return torch.where(m[:, None] if x.dim() == 2 else m, x, 0.0)


def _compute_terms(
    surfels: SurfelStore,
    global_T_frame: torch.Tensor,
    kf_depth, kf_normals, kf_intensity,
    depth_cam: PinholeCamera, color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool, use_descriptor_residuals: bool,
    opt_dintr: bool = False, opt_cintr: bool = False,
    transfer_free: bool = False,
) -> _Terms:
  n = surfels.capacity
  dev = surfels.device
  frame_T_global = se3.inverse(global_T_frame)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid & surfels.active,
      frame_T_global, kf_depth, kf_normals, depth_cam, dp)
  m = assoc.mask
  z = torch.zeros((n,), dtype=torch.float32, device=dev)
  z6 = torch.zeros((n, 6), dtype=torch.float32, device=dev)
  terms = _Terms(z, z, z6, z, z, z, z, z, z6, z6, z, z,
                 None, None, None, None, None, None, None)

  px_f = assoc.px.to(torch.float32)
  py_f = assoc.py.to(torch.float32)

  if use_depth_residuals:
    unproj = depth_cam.unproject_center(px_f, py_f, assoc.calibrated_depth)
    r = cost.raw_depth_residual(
        unproj, assoc.local_pos, assoc.local_normal, assoc.inv_stddev)
    w = cost.depth_weight(r)
    Jp = cost.depth_residual_pose_jacobian(
        unproj, assoc.local_normal, assoc.inv_stddev)
    terms = terms._replace(
        depth_r=_masked(r, m), depth_w=_masked(w, m),
        depth_Jp=_masked(Jp, m), depth_Js=_masked(-assoc.inv_stddev, m))

    if opt_dintr:
      # The rows of the alternated Schur step (models/intrinsics_opt.py),
      # which are PCGInit's (kernel_pcg.cu:180+).
      Jdi, jcf, usable, cell_id = depth_intrinsics_jacobian(
          assoc, surfels.normal, frame_T_global, kf_depth, depth_cam, dp)
      dim = m & usable
      num_cells = dp.cfactor.numel()
      terms = terms._replace(
          w_di=_masked(w, dim), Jdi=_masked(Jdi, dim), jcf=_masked(jcf, dim),
          cell_id=cell_id,
          cells=plan_segments(torch.where(dim, cell_id, num_cells),
                              num_cells, transfer_free))

  if use_descriptor_residuals:
    d2c = DepthToColorTransform.between(depth_cam, color_cam)
    color_pxy, in_color = d2c.apply(assoc.pxy)
    dm = m & in_color
    t1_pxy, t2_pxy = cost.tangent_projections(
        surfels.pos, surfels.normal, surfels.radius_sq,
        frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
    r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
        kf_intensity, color_pxy, t1_pxy, t2_pxy, surfels.desc)
    J1p = cost.projected_position_pose_jacobian(
        gx1 * color_cam.fx, gy1 * color_cam.fy, assoc.local_pos)
    J2p = cost.projected_position_pose_jacobian(
        gx2 * color_cam.fx, gy2 * color_cam.fy, assoc.local_pos)
    rn = assoc.local_normal
    ls = assoc.local_pos
    term1 = -color_cam.fx * (rn[..., 0] * ls[..., 2] - rn[..., 2] * ls[..., 0])
    term2 = -color_cam.fy * (rn[..., 1] * ls[..., 2] - rn[..., 2] * ls[..., 1])
    term3 = 1.0 / torch.clamp(ls[..., 2] * ls[..., 2], min=1e-12)
    J1s = -(gx1 * term1 + gy1 * term2) * term3
    J2s = -(gx2 * term1 + gy2 * term2) * term3
    terms = terms._replace(
        r1=_masked(r1, dm), w1=_masked(cost.descriptor_weight(r1), dm),
        r2=_masked(r2, dm), w2=_masked(cost.descriptor_weight(r2), dm),
        J1p=_masked(J1p, dm), J2p=_masked(J2p, dm),
        J1s=_masked(J1s, dm), J2s=_masked(J2s, dm))

    if opt_cintr:
      # The color intrinsics' Jacobian approximation J = [gx*nx, gy*ny, gx,
      # gy], with nx, ny the normalized coordinates of the depth pixel.
      nx = depth_cam.nx(px_f)
      ny = depth_cam.ny(py_f)
      terms = terms._replace(
          J1c=_masked(torch.stack([gx1 * nx, gy1 * ny, gx1, gy1], dim=-1),
                      dm),
          J2c=_masked(torch.stack([gx2 * nx, gy2 * ny, gx2, gy2], dim=-1),
                      dm))

  return terms


class KeyframeTerms:
  """The terms of every keyframe that takes part, at one state of the map:
  iterating yields (slot, terms) in slot order. They are computed in the
  first pass and held for the later ones where they fit (see the module's
  docstring); otherwise every pass computes them again."""

  def __init__(self, surfels: SurfelStore, kf: KeyframeStore,
               depth_cam: PinholeCamera, color_cam: PinholeCamera,
               dp: DepthCalibration, use_depth: bool, use_desc: bool,
               opt_dintr: bool = False, opt_cintr: bool = False,
               slots: Optional[Sequence[int]] = None,
               transfer_free: bool = False):
    if slots is None:
      slots = torch.nonzero(
          kf.valid & (kf.activation >= COVISIBLE_ACTIVE)).flatten().tolist()
    self.slots = list(slots)
    self.opt_dintr = opt_dintr and use_depth
    self.opt_cintr = opt_cintr and use_desc
    self._args = (surfels, kf, depth_cam, color_cam, dp, use_depth, use_desc)
    self.transfer_free = transfer_free
    needed = len(self.slots) * surfels.capacity * TERM_BYTES_PER_SLOT
    if surfels.device.type == "cuda":
      budget = torch.cuda.mem_get_info(surfels.device)[0] // 2
    else:
      budget = CPU_TERM_BUDGET_BYTES
    self.held: Optional[Dict[int, _Terms]] = {} if needed <= budget else None
    # Passes over the keyframes, and keyframe terms computed, so far.
    self.passes = 0
    self.computed = 0

  def __iter__(self) -> Iterator[Tuple[int, _Terms]]:
    surfels, kf, depth_cam, color_cam, dp, use_depth, use_desc = self._args
    self.passes += 1
    for k in self.slots:
      terms = None if self.held is None else self.held.get(k)
      if terms is None:
        terms = _compute_terms(
            surfels, kf.global_T_frame[k], kf.depth[k], kf.normals[k],
            kf.intensity[k], depth_cam, color_cam, dp, use_depth, use_desc,
            self.opt_dintr, self.opt_cintr, self.transfer_free)
        self.computed += 1
        if self.held is not None:
          self.held[k] = terms
      yield k, terms


def _gauge_mask(k: int, gauge_index, device,
                kf_axis: Optional[str] = None) -> torch.Tensor:
  """(k, 1) mask of the pose row that is held fixed. Under kf sharding the
  local rows map to global ones by the shard's offset, and ``gauge_index``
  is global."""
  rows = torch.arange(k, device=device)
  if kf_axis is not None:
    rows = rows + spmd.axis_index(kf_axis) * k
  return (rows == gauge_index)[:, None]


def _psum_replicated(vecs: Tuple[PCGVector, ...], axis_name: Optional[str],
                     kf_axis: Optional[str]) -> Tuple[PCGVector, ...]:
  """The cross-shard sums of accumulated r/M/g vectors: the pose rows come
  from the local surfel shard only (summed over the surfel axis), the surfel
  rows from the local keyframe shard only (summed over the kf axis), the
  intrinsics rows from both. One collective per axis for all ``vecs``."""
  vecs = [v._asdict() for v in vecs]
  for axis, names in ((axis_name, ("poses", "dintr", "cfac", "cintr")),
                      (kf_axis, ("spos", "sdesc", "dintr", "cfac", "cintr"))):
    if axis is None:
      continue
    summed = spmd.psum([[v[n] for n in names] for v in vecs], axis)
    for v, parts in zip(vecs, summed):
      v.update(zip(names, parts))
  return tuple(PCGVector(**v) for v in vecs)


def _terms_for(terms, surfels, kf, depth_cam, color_cam, dp, use_depth,
               use_desc, opt_dintr, opt_cintr, slots) -> KeyframeTerms:
  if terms is not None:
    return terms
  return KeyframeTerms(surfels, kf, depth_cam, color_cam, dp, use_depth,
                       use_desc, opt_dintr, opt_cintr, slots)


def pcg_init(surfels, kf, depth_cam, color_cam, dp, gauge_index,
             use_depth=True, use_desc=True,
             opt_dintr: bool = False, opt_cintr: bool = False,
             slots: Optional[Sequence[int]] = None,
             terms: Optional[KeyframeTerms] = None,
             axis_name: Optional[str] = None,
             kf_axis: Optional[str] = None,
             ) -> Tuple[PCGVector, PCGVector]:
  """r = -J^T W F and the Jacobi preconditioner M = diag(J^T W J) + eps
  (PCGInitCUDAKernel, kernel_pcg.cu:180+), the a-prior rows included
  (kernel_pcg.cu:587-591). ``axis_name``, ``kf_axis``: the mesh axes (see
  the module's docstring)."""
  k, n = kf.capacity, surfels.capacity
  c = dp.cfactor.numel()
  dev = surfels.device
  terms = _terms_for(terms, surfels, kf, depth_cam, color_cam, dp, use_depth,
                     use_desc, opt_dintr, opt_cintr, slots)
  opt_dintr, opt_cintr = terms.opt_dintr, terms.opt_cintr
  r = zeros_like_vec(k, n, c, dev)
  M = zeros_like_vec(k, n, c, dev)
  # Each slot is visited once: its pose rows are written, not added to.
  r_poses, M_poses = r.poses, M.poses

  for k_index, t in terms:
    # depth residual
    wr = t.depth_w * t.depth_r
    rp = -(t.depth_Jp.T @ wr)
    Mp = (t.depth_Jp ** 2 * t.depth_w[:, None]).sum(dim=0)
    rs = -(t.depth_w * t.depth_Js * t.depth_r)
    Ms = t.depth_w * t.depth_Js ** 2

    # descriptor residuals
    wr1 = t.w1 * t.r1
    wr2 = t.w2 * t.r2
    rp = rp - (t.J1p.T @ wr1)
    rp = rp - (t.J2p.T @ wr2)
    Mp = Mp + (t.J1p ** 2 * t.w1[:, None]).sum(dim=0)
    Mp = Mp + (t.J2p ** 2 * t.w2[:, None]).sum(dim=0)
    rs = rs - t.w1 * t.J1s * t.r1
    rs = rs - t.w2 * t.J2s * t.r2
    Ms = Ms + t.w1 * t.J1s ** 2 + t.w2 * t.J2s ** 2
    # The descriptor unknowns: Jacobian -1.
    r_poses[k_index] = rp
    M_poses[k_index] = Mp
    r = r._replace(spos=r.spos + rs,
                   sdesc=r.sdesc + torch.stack([wr1, wr2], dim=-1))
    M = M._replace(spos=M.spos + Ms,
                   sdesc=M.sdesc + torch.stack([t.w1, t.w2], dim=-1))

    if opt_dintr:
      wri = t.w_di * t.depth_r
      r = r._replace(dintr=r.dintr - t.Jdi.T @ wri,
                     cfac=r.cfac - t.cells.sum(t.jcf * wri))
      M = M._replace(
          dintr=M.dintr + (t.Jdi ** 2 * t.w_di[:, None]).sum(dim=0),
          cfac=M.cfac + t.cells.sum(t.w_di * t.jcf * t.jcf))

    if opt_cintr:
      r = r._replace(cintr=r.cintr - t.J1c.T @ wr1 - t.J2c.T @ wr2)
      M = M._replace(cintr=M.cintr
                     + (t.J1c ** 2 * t.w1[:, None]).sum(dim=0)
                     + (t.J2c ** 2 * t.w2[:, None]).sum(dim=0))

  if axis_name is not None or kf_axis is not None:
    r, M = _psum_replicated((r, M), axis_name, kf_axis)
  # Gauge fixing: zero the fixed keyframe's rows; unit preconditioner there.
  gauge_mask = _gauge_mask(k, gauge_index, dev, kf_axis)
  r = r._replace(poses=torch.where(gauge_mask, 0.0, r.poses))
  M = M._replace(
      poses=torch.where(gauge_mask, 1.0, M.poses + DIAG_EPSILON),
      spos=M.spos + DIAG_EPSILON,
      sdesc=M.sdesc + DIAG_EPSILON)
  if opt_dintr:
    # The weak prior on a: its residual kAPriorWeight * (a + delta_a) adds
    # -w^2 * a to r and w^2 to M on the a row (kernel_pcg.cu:587-591).
    w2a = A_PRIOR_WEIGHT * A_PRIOR_WEIGHT
    a_row = _a_row(dev)
    r = r._replace(dintr=r.dintr - (w2a * dp.a) * a_row)
    M = M._replace(dintr=M.dintr + w2a * a_row + DIAG_EPSILON,
                   cfac=M.cfac + DIAG_EPSILON)
  else:
    r = r._replace(dintr=torch.zeros_like(r.dintr),
                   cfac=torch.zeros_like(r.cfac))
    M = M._replace(dintr=torch.ones_like(M.dintr),
                   cfac=torch.ones_like(M.cfac))
  if opt_cintr:
    M = M._replace(cintr=M.cintr + DIAG_EPSILON)
  else:
    r = r._replace(cintr=torch.zeros_like(r.cintr))
    M = M._replace(cintr=torch.ones_like(M.cintr))
  return r, M


def apply_hessian(p: PCGVector, surfels, kf, depth_cam, color_cam, dp,
                  gauge_index, use_depth=True, use_desc=True,
                  opt_dintr: bool = False, opt_cintr: bool = False,
                  slots: Optional[Sequence[int]] = None,
                  terms: Optional[KeyframeTerms] = None,
                  axis_name: Optional[str] = None,
                  kf_axis: Optional[str] = None) -> PCGVector:
  """g = (J^T W J + eps I) p, matrix-free (PCGStep1, kernel_pcg.cu:646+),
  the a-prior term on the a row included (kernel_pcg.cu:1040). The mesh
  axes as in ``pcg_init``."""
  k, n = kf.capacity, surfels.capacity
  c = dp.cfactor.numel()
  dev = surfels.device
  terms = _terms_for(terms, surfels, kf, depth_cam, color_cam, dp, use_depth,
                     use_desc, opt_dintr, opt_cintr, slots)
  opt_dintr, opt_cintr = terms.opt_dintr, terms.opt_cintr
  gauge_mask = _gauge_mask(k, gauge_index, dev, kf_axis)
  p = p._replace(poses=torch.where(gauge_mask, 0.0, p.poses))
  if not opt_dintr:
    p = p._replace(dintr=torch.zeros_like(p.dintr),
                   cfac=torch.zeros_like(p.cfac))
  if not opt_cintr:
    p = p._replace(cintr=torch.zeros_like(p.cintr))

  g = zeros_like_vec(k, n, c, dev)
  g_poses = g.poses
  for k_index, t in terms:
    p_pose = p.poses[k_index]

    # The depth residual's row may also involve the intrinsics columns.
    Jp = t.depth_Jp @ p_pose + t.depth_Js * p.spos
    if opt_dintr:
      Jp = Jp + (t.Jdi @ p.dintr + t.jcf * p.cfac[t.cell_id])
    wJpd = t.depth_w * Jp
    d_pose = t.depth_Jp.T @ wJpd
    d_spos = t.depth_Js * wJpd

    # The descriptor residuals' rows may involve the color intrinsics.
    Jp1 = t.J1p @ p_pose + t.J1s * p.spos - p.sdesc[:, 0]
    Jp2 = t.J2p @ p_pose + t.J2s * p.spos - p.sdesc[:, 1]
    if opt_cintr:
      Jp1 = Jp1 + t.J1c @ p.cintr
      Jp2 = Jp2 + t.J2c @ p.cintr
    wJp1 = t.w1 * Jp1
    wJp2 = t.w2 * Jp2
    d_pose = d_pose + t.J1p.T @ wJp1 + t.J2p.T @ wJp2
    d_spos = d_spos + t.J1s * wJp1 + t.J2s * wJp2

    g_poses[k_index] = d_pose
    g = g._replace(spos=g.spos + d_spos,
                   sdesc=g.sdesc + torch.stack([-wJp1, -wJp2], dim=-1))
    if opt_dintr:
      g = g._replace(dintr=g.dintr + t.Jdi.T @ wJpd,
                     cfac=g.cfac + t.cells.sum(t.jcf * wJpd))
    if opt_cintr:
      g = g._replace(cintr=g.cintr + t.J1c.T @ wJp1 + t.J2c.T @ wJp2)

  if axis_name is not None or kf_axis is not None:
    g, = _psum_replicated((g,), axis_name, kf_axis)
  g = g._replace(poses=torch.where(gauge_mask, p.poses, g.poses))
  g = g + p.scale(DIAG_EPSILON)
  if opt_dintr:
    w2a = A_PRIOR_WEIGHT * A_PRIOR_WEIGHT
    a_row = _a_row(dev)
    g = g._replace(dintr=g.dintr + (w2a * p.dintr[4]) * a_row)
  return g


def pcg_solve(surfels: SurfelStore, kf: KeyframeStore,
              depth_cam: PinholeCamera, color_cam: PinholeCamera,
              dp: DepthCalibration, gauge_index,
              max_inner_iterations: int = 30,
              use_depth: bool = True, use_desc: bool = True,
              opt_dintr: bool = False, opt_cintr: bool = False,
              slots: Optional[Sequence[int]] = None,
              stats: Optional[dict] = None,
              transfer_free: bool = False,
              axis_name: Optional[str] = None,
              kf_axis: Optional[str] = None) -> PCGVector:
  """The full PCG solve. Returns the GN update delta, which
  ``apply_pcg_delta`` adds. The loop ends on the host, so each inner
  iteration reads one flag from the device; with ``transfer_free`` the flag
  stays on the device and the delta holds once it is set
  (utils/transfer.py). ``stats``, if given, receives the inner iterations
  run (launched, with ``transfer_free``), the passes over the keyframes and
  the keyframe terms computed. ``axis_name`` and ``kf_axis`` as in
  ``pcg_init``: every value that steers the loop is then the same on every
  shard."""
  terms = KeyframeTerms(surfels, kf, depth_cam, color_cam, dp, use_depth,
                        use_desc, opt_dintr, opt_cintr, slots, transfer_free)
  common = (surfels, kf, depth_cam, color_cam, dp, gauge_index, use_depth,
            use_desc)
  axes = dict(axis_name=axis_name, kf_axis=kf_axis)
  r, M = pcg_init(*common, terms=terms, **axes)
  M_inv = PCGVector(*(1.0 / m for m in M))

  delta = zeros_like_vec(kf.capacity, surfels.capacity, dp.cfactor.numel(),
                         surfels.device)
  g = M_inv.mul(r)
  pvec = g
  alpha_n = r.dot(g, **axes)
  threshold = 1e-10 * alpha_n + 1e-30
  iterations = 0
  if transfer_free:
    mesh_axes = tuple(a for a in (axis_name, kf_axis) if a is not None)
    poll = DonePoll(surfels.device, mesh_axes or None)
    done = ~(alpha_n > threshold)
  while iterations < max_inner_iterations and (
      transfer_free or bool(alpha_n > threshold)):
    h = apply_hessian(pvec, *common, terms=terms, **axes)
    alpha_d = pvec.dot(h, **axes)
    alpha = alpha_n / torch.clamp(alpha_d, min=1e-30)
    stepped = delta + pvec.scale(alpha)
    delta = (PCGVector(*(torch.where(done, a, b)
                         for a, b in zip(delta, stepped)))
             if transfer_free else stepped)
    r = r - h.scale(alpha)
    g = M_inv.mul(r)
    beta_n = r.dot(g, **axes)
    beta = beta_n / torch.clamp(alpha_n, min=1e-30)
    pvec = g + pvec.scale(beta)
    alpha_n = beta_n
    iterations += 1
    if transfer_free:
      done = done | ~(alpha_n > threshold)
      if poll.done(done):
        break
  if stats is not None:
    stats.update(iterations=iterations, passes=terms.passes,
                 terms_computed=terms.computed,
                 terms_held=terms.held is not None)
  return delta


def debug_verify_result(delta: PCGVector, surfels, kf, depth_cam, color_cam,
                        dp, gauge_index, use_depth=True, use_desc=True,
                        opt_dintr: bool = False, opt_cintr: bool = False,
                        slots: Optional[Sequence[int]] = None,
                        axis_name: Optional[str] = None,
                        kf_axis: Optional[str] = None,
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
  """The kDebugVerifyResult self-check (direct_ba_pcg.cc:476-550,
  kernel_pcg.cu:1260-1276): recompute r0 and (J^T W J + eps I) delta and
  return the largest absolute residual of the normal equations, and
  ||r0||_inf for scale. An exact solve gives 0; a converged PCG gives a
  value that is small against the scale. Over a mesh both are maxima over
  every shard."""
  terms = KeyframeTerms(surfels, kf, depth_cam, color_cam, dp, use_depth,
                        use_desc, opt_dintr, opt_cintr, slots)
  common = (surfels, kf, depth_cam, color_cam, dp, gauge_index, use_depth,
            use_desc)
  axes = dict(axis_name=axis_name, kf_axis=kf_axis)
  r0, _ = pcg_init(*common, terms=terms, **axes)
  diff = apply_hessian(delta, *common, terms=terms, **axes) - r0
  blocks = ["spos", "sdesc", "poses"]
  scale_blocks = list(blocks)
  if terms.opt_dintr:
    blocks += ["dintr", "cfac"]
    scale_blocks += ["dintr"]
  if terms.opt_cintr:
    blocks += ["cintr"]
    scale_blocks += ["cintr"]
  err = torch.stack([getattr(diff, b).abs().max() for b in blocks]).max()
  scale = torch.stack(
      [getattr(r0, b).abs().max() for b in scale_blocks]).max()
  for axis in (axis_name, kf_axis):
    if axis is not None:
      err, scale = spmd.pmax((err, scale), axis)
  return err, scale


def apply_pcg_delta(surfels: SurfelStore, kf: KeyframeStore,
                    delta: PCGVector) -> Tuple[SurfelStore, KeyframeStore]:
  """Apply the GN update (direct_ba_pcg.cc:552-646).

  CG solves H delta = r0 with r0 = -J^T W F, so delta = -x for the
  alternating path's x = H^-1 J^T W F, whose update is T * exp(-x); hence
  here T <- T * exp(+delta), position += delta_s * normal, desc += delta_d.
  """
  x = torch.where(torch.isfinite(delta.poses), delta.poses, 0.0)
  T_new = kf.global_T_frame @ se3.exp(x)
  T_new = torch.where(kf.valid[:, None, None], T_new, kf.global_T_frame)

  upd = surfels.valid & surfels.active
  xs = torch.where(upd & torch.isfinite(delta.spos), delta.spos, 0.0)
  xd = torch.where(upd[:, None] & torch.isfinite(delta.sdesc), delta.sdesc,
                   0.0)
  new_pos = surfels.pos + xs[:, None] * surfels.normal
  new_desc = torch.clamp(surfels.desc + xd, -180.0, 180.0)
  return (surfels._replace(pos=new_pos, desc=new_desc),
          kf._replace(global_T_frame=T_new))


def apply_pcg_delta_intrinsics(
    depth_intr, color_intr, a, cfactor, delta: PCGVector,
    opt_dintr: bool, opt_cintr: bool):
  """The intrinsics part of the joint delta (direct_ba_pcg.cc:588-645): the
  depth intrinsics additively on the inverse parameters (with the 0.5 shift
  of the pixel-corner convention), a, cfactor and the color intrinsics
  additively. Returns new tensors; an unknown that is not optimized comes
  back as the tensor that went in."""
  new_depth_intr, new_a, new_cfactor = depth_intr, a, cfactor
  if opt_dintr:
    d = torch.where(torch.isfinite(delta.dintr), delta.dintr, 0.0)
    new_depth_intr = inverse_parameter_update(depth_intr, d, 1.0)
    new_a = a + d[4]
    dc = torch.where(torch.isfinite(delta.cfac), delta.cfac, 0.0)
    new_cfactor = cfactor + dc.reshape(cfactor.shape)
  new_color_intr = color_intr
  if opt_cintr:
    dc = torch.where(torch.isfinite(delta.cintr), delta.cintr, 0.0)
    new_color_intr = color_intr + dc
  return new_depth_intr, new_color_intr, new_a, new_cfactor
