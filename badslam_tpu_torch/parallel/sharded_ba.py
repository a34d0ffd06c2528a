"""Distributed bundle adjustment: the surfel-sharded BA steps over a mesh.

Port of ``badslam_tpu/parallel/sharded_ba.py``. The surfel store is sharded
over the mesh's ``surfels`` axis, and one BA iteration exchanges only:

  * the pose step: a psum of each keyframe's partial (6x6 H, 6 b);
  * the geometry step: nothing (each surfel's 3x3 system is local);
  * activation, merge and deletion: nothing (per surfel).

Keyframe images are replicated, or, in the 2-D layout, sharded over a second
mesh axis ``kf``, with the pose loop of each keyframe run by its kf shard.

Every ``make_*`` function returns a callable with the inputs and outputs of
the JAX function of the same name; placement and collectives are
``parallel/spmd.py``'s (one thread per mesh position, a fixed-order psum).
The cameras are closed over, as in JAX, and must hold host floats when the
mesh spans several devices.
"""

from __future__ import annotations

from typing import Dict

import torch

from badslam_tpu_torch.geometry.camera import PinholeCamera
from badslam_tpu_torch.models import (geometry_opt, keyframes as kf_mod,
                                      pcg as pcg_mod, pose_opt)
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.keyframes import (ACTIVE, COVISIBLE_ACTIVE,
                                                INACTIVE, KeyframeStore)
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.parallel import spmd
from badslam_tpu_torch.parallel.spmd import Mesh, P

SURFEL_AXIS = "surfels"
KF_AXIS = "kf"


def surfel_sharding(mesh: Mesh) -> P:
  """Surfel arrays: sharded along the surfel dimension."""
  return P(SURFEL_AXIS)


def replicated(mesh: Mesh) -> P:
  return P()


def shard_surfels(surfels: SurfelStore, mesh: Mesh) -> SurfelStore:
  """The surfel store with the surfel axis sharded over the mesh (slot ``s``
  on the shard ``s // (capacity / N)``); the watermark stays one tensor on
  the mesh's first device. The capacity must be a multiple of the surfel
  axis' size (``grow`` doubles, so a power-of-2 axis keeps it so). On a
  2-D mesh the shards repeat along the kf axis."""
  first = mesh.first_device

  def place(x):
    x = spmd.gather(x)
    if x.dim() >= 1 and x.shape[0] == surfels.capacity:
      return spmd.shard(x, mesh, SURFEL_AXIS)
    return spmd.replicate(x, first)

  return SurfelStore(*(place(x) for x in surfels))


def surfel_specs() -> SurfelStore:
  """The spec tree of a sharded SurfelStore: every field sharded but the
  watermark."""
  return SurfelStore(
      pos=P(SURFEL_AXIS), normal=P(SURFEL_AXIS), radius_sq=P(SURFEL_AXIS),
      color=P(SURFEL_AXIS), desc=P(SURFEL_AXIS), valid=P(SURFEL_AXIS),
      active=P(SURFEL_AXIS), count=P())


def _kf_specs_2d() -> KeyframeStore:
  """(K, ...) arrays sharded along kf; the count replicated."""
  return KeyframeStore(**{name: P() if name == "count" else P(KF_AXIS)
                          for name in KeyframeStore._fields})


class _Intrinsics:
  """A closed-over camera's (fx, fy, cx, cy) as a tensor, made once per
  device."""

  def __init__(self, cam: PinholeCamera):
    self.cam = cam
    self._on: Dict[torch.device, torch.Tensor] = {}

  def on(self, device) -> torch.Tensor:
    intr = self._on.get(device)
    if intr is None:
      c = self.cam
      intr = torch.stack([torch.as_tensor(v, dtype=torch.float32)
                          for v in (c.fx, c.fy, c.cx, c.cy)]).to(device)
      self._on[device] = intr
    return intr


def _depth_params(depth_intr: _Intrinsics, cell_size: int, a, cfactor,
                  baseline_fx) -> DepthCalibration:
  """The calibration of one call: the closed-over depth camera with the
  call's a, cfactor and baseline_fx."""
  cam = depth_intr.cam
  return DepthCalibration(depth_intr.on(a.device), a, cfactor, baseline_fx,
                          cell_size, (cam.width, cam.height))


def _pose_step(surfels, kf, depth_cam, color_cam, dp, use_depth, use_desc,
               max_pose_iterations):
  """The batched pose GN of the keyframes that are not inactive, with the
  H/b psum'd over the surfel axis, and their new activation
  (direct_ba_alternating.cc:543-577)."""
  optimize = kf.valid & (kf.activation != INACTIVE)
  T, moved = pose_opt.estimate_frame_poses_batched(
      kf.global_T_frame, optimize, surfels, kf.depth, kf.normals,
      kf.intensity, depth_cam, color_cam, dp, use_depth, use_desc,
      max_pose_iterations, axis=SURFEL_AXIS)
  activation = torch.where(
      optimize, torch.where(moved, ACTIVE, INACTIVE).to(torch.int32),
      kf.activation)
  kf = kf._replace(global_T_frame=T, activation=activation)
  converged = torch.sum(kf.valid & (activation == INACTIVE)).to(torch.int32)
  return kf, converged


def make_sharded_ba_iteration(
    mesh: Mesh,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    cell_size: int,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_pose_iterations: int = 30,
):
  """The distributed BA iteration:

    (surfels [sharded], kf [replicated], a, cfactor, baseline_fx)
      -> (surfels', kf' with updated poses and activation, num_converged)

  One iteration is the geometry GN step (local) and the batched pose GN
  (psum'd H/b), steps (3) and (5) of the reference's alternation
  (direct_ba_alternating.cc:466-577)."""
  depth_intr = _Intrinsics(depth_cam)

  def iteration(surfels, kf, a, cfactor, baseline_fx):
    dp = _depth_params(depth_intr, cell_size, a, cfactor, baseline_fx)
    surfels = geometry_opt.optimize_geometry_iteration(
        surfels, kf, depth_cam, color_cam, dp, use_depth_residuals,
        use_descriptor_residuals)
    kf, converged = _pose_step(surfels, kf, depth_cam, color_cam, dp,
                               use_depth_residuals, use_descriptor_residuals,
                               max_pose_iterations)
    return surfels, kf, converged

  return spmd.shard_map(iteration, mesh,
                        in_specs=(surfel_specs(), P(), P(), P(), P()),
                        out_specs=(surfel_specs(), P(), P()))


def make_sharded_ba_iteration_2d(
    mesh: Mesh,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    cell_size: int,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_pose_iterations: int = 30,
):
  """The distributed BA iteration over a 2-D ('kf', 'surfels') mesh, the
  multi-host layout:

    * the keyframe stacks are sharded along the kf axis;
    * the surfels are sharded along the surfel axis;
    * geometry step: each position accumulates its local keyframes into
      per-surfel 3x3 systems, psum'd over the kf axis (9 floats per
      surfel), and solves them locally;
    * pose step: each local keyframe's H/b from the local surfel shard,
      psum'd over the surfel axis; each kf shard steps its own poses.

  Returns (surfels, kf, a, cfactor, baseline_fx)
      -> (surfels', kf', num_converged)."""
  depth_intr = _Intrinsics(depth_cam)

  def iteration(surfels, kf, a, cfactor, baseline_fx):
    dp = _depth_params(depth_intr, cell_size, a, cfactor, baseline_fx)
    acc = geometry_opt._zero_accum(surfels.capacity, surfels.device)
    slots = torch.nonzero(
        kf.valid & (kf.activation >= COVISIBLE_ACTIVE)).flatten().tolist()
    for k in slots:
      acc = geometry_opt.accumulate_one_keyframe(
          acc, surfels, kf.depth[k], kf.normals[k], kf.intensity[k],
          kf.global_T_frame[k], True, depth_cam, color_cam, dp,
          use_depth_residuals, use_descriptor_residuals)
    acc = spmd.psum(acc, KF_AXIS)
    surfels = geometry_opt.solve_and_update(surfels, acc)
    kf, converged = _pose_step(surfels, kf, depth_cam, color_cam, dp,
                               use_depth_residuals, use_descriptor_residuals,
                               max_pose_iterations)
    return surfels, kf, spmd.psum(converged, KF_AXIS)

  kf_spec = _kf_specs_2d()
  return spmd.shard_map(iteration, mesh,
                        in_specs=(surfel_specs(), kf_spec, P(), P(), P()),
                        out_specs=(surfel_specs(), kf_spec, P()))


def shard_keyframes_2d(kf: KeyframeStore, mesh: Mesh) -> KeyframeStore:
  """The keyframe store with its (K, ...) arrays sharded along the kf axis
  and the count on the mesh's first device. The capacity must divide over
  the kf axis."""
  def place(name, x):
    x = spmd.gather(x)
    if name == "count":
      return spmd.replicate(x, mesh.first_device)
    return spmd.shard(x, mesh, KF_AXIS)
  return KeyframeStore(**{name: place(name, getattr(kf, name))
                          for name in KeyframeStore._fields})


def grow_keyframes_2d(kf: KeyframeStore, mesh: Mesh,
                      new_capacity: int) -> KeyframeStore:
  """Keyframe-store growth under kf sharding: every (K, ...) array (and both
  axes of the covisibility matrix) padded to ``new_capacity`` and sharded
  again. ``new_capacity`` must divide over the kf axis; the new slots are
  invalid, free for ``make_add_keyframe_2d``."""
  assert new_capacity % mesh.shape[KF_AXIS] == 0, (
      f"capacity {new_capacity} must divide over kf axis "
      f"{mesh.shape[KF_AXIS]}")
  return shard_keyframes_2d(kf_mod.grow(spmd.gather_tree(kf), new_capacity),
                            mesh)


def make_add_keyframe_2d(mesh: Mesh):
  """Insertion of one keyframe into a slot of the kf-sharded store: the
  images land on the shard that owns the slot, everything else is a masked
  row update (no gather of the store). The covisibility row and column are
  set from a replicated (K,) bool mask."""
  kf_spec = _kf_specs_2d()

  def add(kf, slot, depth, normals, radius_sq, intensity, rgb, T,
          frame_index, min_depth, max_depth, covis_row):
    dev = kf.valid.device
    k = kf.capacity
    slot = torch.as_tensor(slot, device=dev).to(torch.int32)
    rows = torch.arange(k, device=dev) + spmd.axis_index(KF_AXIS) * k
    onehot = rows == slot
    cols = torch.arange(covis_row.shape[0], device=dev) == slot

    def put(stack, value):
      value = torch.as_tensor(value, device=dev).to(stack.dtype)
      mask = onehot.reshape((-1,) + (1,) * (stack.dim() - 1))
      return torch.where(mask, value[None], stack)

    covis = torch.where(onehot[:, None], covis_row[None, :], kf.covis)
    covis = torch.where(cols[None, :], covis_row[rows][:, None], covis)
    covis = covis | (onehot[:, None] & cols[None, :])
    return kf._replace(
        depth=put(kf.depth, depth),
        normals=put(kf.normals, normals),
        radius_sq=put(kf.radius_sq, radius_sq),
        intensity=put(kf.intensity, intensity),
        rgb=put(kf.rgb, rgb),
        global_T_frame=put(kf.global_T_frame, T),
        frame_index=put(kf.frame_index, frame_index),
        min_depth=put(kf.min_depth, min_depth),
        max_depth=put(kf.max_depth, max_depth),
        valid=kf.valid | onehot,
        activation=torch.where(onehot, ACTIVE, kf.activation).to(torch.int32),
        covis=covis,
        count=torch.maximum(kf.count, slot + 1))

  return spmd.shard_map(add, mesh, in_specs=(kf_spec,) + (P(),) * 11,
                        out_specs=kf_spec)


def shard_surfels_2d(surfels: SurfelStore, mesh: Mesh) -> SurfelStore:
  """Surfel arrays sharded along the surfel axis, repeated along kf."""
  return shard_surfels(surfels, mesh)


def make_sharded_pcg_step(
    mesh: Mesh,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    cell_size: int,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_inner_iterations: int = 30,
    opt_dintr: bool = False,
    opt_cintr: bool = False,
):
  """The distributed joint GN step: one matrix-free PCG solve with the
  surfel axis sharded over the mesh. Per CG iteration the shards exchange
  one psum of the (K, 6) pose rows (with the (5,) + (C,) + (4,) intrinsics
  rows when the ``opt_*`` flags fold those unknowns into the joint vector,
  direct_ba_pcg.cc:240-307) and the scalars of two dot products.

  Returns (surfels [sharded], kf [replicated], a, cfactor, baseline_fx,
  gauge_index)
    -> (surfels', kf', max_pose_update) without the intrinsics flags, or
    -> (surfels', kf', depth_intr', color_intr', a', cfactor',
        max_pose_update) with either flag set (depth_intr and color_intr
        start from the closed-over cameras)."""
  depth_intr = _Intrinsics(depth_cam)
  color_intr = _Intrinsics(color_cam)
  with_intrinsics = opt_dintr or opt_cintr

  def step(surfels, kf, a, cfactor, baseline_fx, gauge_index):
    dp = _depth_params(depth_intr, cell_size, a, cfactor, baseline_fx)
    delta = pcg_mod.pcg_solve(
        surfels, kf, depth_cam, color_cam, dp, gauge_index,
        max_inner_iterations, use_depth_residuals, use_descriptor_residuals,
        opt_dintr, opt_cintr, axis_name=SURFEL_AXIS)
    surfels, kf = pcg_mod.apply_pcg_delta(surfels, kf, delta)
    pose_update = torch.where(kf.valid[:, None], delta.poses.abs(),
                              0.0).max()
    if not with_intrinsics:
      return surfels, kf, pose_update
    di, ci, a2, cf2 = pcg_mod.apply_pcg_delta_intrinsics(
        dp.depth_intr, color_intr.on(a.device), a, cfactor, delta,
        opt_dintr, opt_cintr)
    return surfels, kf, di, ci, a2, cf2, pose_update

  out_specs = ((surfel_specs(), P(), P(), P(), P(), P(), P())
               if with_intrinsics else (surfel_specs(), P(), P()))
  return spmd.shard_map(step, mesh,
                        in_specs=(surfel_specs(), P(), P(), P(), P(), P()),
                        out_specs=out_specs)


def make_sharded_pcg_step_2d(
    mesh: Mesh,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    cell_size: int,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_inner_iterations: int = 30,
):
  """Joint GN by PCG over the 2-D ('kf', 'surfels') mesh: the keyframe
  stacks and their pose unknowns sharded along kf, the surfel unknowns
  along surfels. Per CG iteration the pose rows are psum'd over the surfel
  axis, the surfel rows over the kf axis, and the dot products over both;
  no block of unknowns is ever gathered whole.

  ``gauge_index`` is the global keyframe slot (each kf shard resolves its
  offset by ``axis_index``, models/pcg.py ``_gauge_mask``).

  Returns (surfels, kf, a, cfactor, baseline_fx, gauge_index)
      -> (surfels', kf', max_pose_update)."""
  depth_intr = _Intrinsics(depth_cam)

  def step(surfels, kf, a, cfactor, baseline_fx, gauge_index):
    dp = _depth_params(depth_intr, cell_size, a, cfactor, baseline_fx)
    delta = pcg_mod.pcg_solve(
        surfels, kf, depth_cam, color_cam, dp, gauge_index,
        max_inner_iterations, use_depth_residuals, use_descriptor_residuals,
        axis_name=SURFEL_AXIS, kf_axis=KF_AXIS)
    surfels, kf = pcg_mod.apply_pcg_delta(surfels, kf, delta)
    pose_update = spmd.pmax(
        torch.where(kf.valid[:, None], delta.poses.abs(), 0.0).max(),
        KF_AXIS)
    return surfels, kf, pose_update

  kf_spec = _kf_specs_2d()
  return spmd.shard_map(step, mesh,
                        in_specs=(surfel_specs(), kf_spec, P(), P(), P(),
                                  P()),
                        out_specs=(surfel_specs(), kf_spec, P()))
