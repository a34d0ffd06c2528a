"""Frame-to-model pose estimation: Gauss-Newton on the direct cost.

Port of ``badslam_tpu/models/pose_opt.py`` (``EstimateFramePose``,
direct_ba_alternating.cc:42-283 of the original BAD SLAM): up to 30 GN
iterations; each accumulates a 6x6 H and a 6-vector b over all surfels
(depth point-to-plane + two descriptor residuals), solves H x = b, applies
``T <- T * exp(-x)`` and stops on IsScale1PoseEstimationConverged.

The H/b reduction and the 6x6 solve run on the device; each GN iteration
reads one convergence flag back to the host to end the loop.

``estimate_frame_poses_batched`` solves every keyframe of a BA iteration in
one loop over all keyframes (the lanes), as the JAX package's shared
``lax.while_loop`` does. On a CUDA device each step is two launches of the
hand-written kernels of ``csrc/pose_h_b.cu`` (every open lane's H/b, then
every open lane's solve and update) and one host read; for CPU tensors the
kernels' plain versions (``accumulate_lanes_h_b_plain``,
``step_lanes_plain``) run, which the tests hold against the JAX package.
It records two ``Timing`` counters per call: "BA pose GN steps" (shared
steps launched) and "BA pose lane steps" (the lanes open at each step,
summed), whose ratio is the mean number of lanes a launch serves.

With the surfel store sharded over a mesh (``parallel/spmd.py``), ``axis``
names the mesh axis of the surfel shards: each shard accumulates its partial
H/b, the partials are summed over the axis (``psum``) and every shard makes
the same solve and the same step.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from badslam_tpu_torch.geometry import se3
from badslam_tpu_torch.geometry.camera import (DepthToColorTransform,
                                               PinholeCamera)
from badslam_tpu_torch.models import association, cost
from badslam_tpu_torch.models.calibration import DepthCalibration
from badslam_tpu_torch.models.surfels import SurfelStore
from badslam_tpu_torch.ops import pose_h_b
from badslam_tpu_torch.parallel import spmd
from badslam_tpu_torch.utils.timing import Timing
from badslam_tpu_torch.utils.transfer import LoopEnd

_TRANSLATION_CONVERGENCE_THRESHOLD = 1e-6
_ROTATION_SCALE = 10.0  # translation_threshold / rotation_threshold


def is_scale1_converged(x: torch.Tensor) -> torch.Tensor:
  """IsScale1PoseEstimationConverged (convergence_analysis.h:45-52)."""
  scale = torch.where(torch.arange(6, device=x.device) < 3, 1.0,
                      _ROTATION_SCALE).to(x.dtype)
  scaled = x * scale
  return (torch.sum(scaled * scaled, dim=-1)
          < _TRANSLATION_CONVERGENCE_THRESHOLD)


def solve_6x6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  """6x6 GN solve in float32 with Jacobi equilibration and 2 steps of
  iterative refinement. A plain f32 solve loses the weak direction of an
  ill-conditioned H (translation and rotation columns differ by the scene
  scale); the reference solves in double.

  ``solve_ex`` does not check the factorization, so a singular H gives a
  non-finite x (which the caller zeroes) instead of raising, and the solve
  never waits for the device."""
  d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-30))
  s = 1.0 / d
  Hs = H * s[:, None] * s[None, :]
  bs = b * s
  y = torch.linalg.solve_ex(Hs, bs)[0]
  for _ in range(2):
    r = bs - Hs @ y
    y = y + torch.linalg.solve_ex(Hs, r)[0]
  return y * s


def accumulate_pose_h_b(
    global_T_frame: torch.Tensor,
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    compute_cost: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
  """One evaluation of (H, b[, cost, residual_count]) at the given pose
  (AccumulatePoseEstimationCoeffsCUDAKernel, kernel_opt_pose.cu:252-383)."""
  dev = global_T_frame.device
  frame_T_global = se3.inverse(global_T_frame)
  assoc = association.associate_surfels(
      surfels.pos, surfels.normal, surfels.valid, frame_T_global,
      kf_depth, kf_normals, depth_cam, dp)

  H = torch.zeros((6, 6), dtype=torch.float32, device=dev)
  b = torch.zeros((6,), dtype=torch.float32, device=dev)
  total_cost = torch.zeros((), dtype=torch.float32, device=dev)
  res_count = torch.zeros((), dtype=torch.int32, device=dev)

  if use_depth_residuals:
    unproj = depth_cam.unproject_center(
        assoc.px.to(torch.float32), assoc.py.to(torch.float32),
        assoc.calibrated_depth)
    r = cost.raw_depth_residual(unproj, assoc.local_pos, assoc.local_normal,
                                assoc.inv_stddev)
    J = cost.depth_residual_pose_jacobian(unproj, assoc.local_normal,
                                          assoc.inv_stddev)
    w = cost.depth_weight(r)
    Hd, bd = cost.accumulate_h_b(J, r, w, assoc.mask)
    H = H + Hd
    b = b + bd
    if compute_cost:
      total_cost = total_cost + torch.sum(
          torch.where(assoc.mask, cost.weighted_depth_cost(r), 0.0))
      res_count = res_count + torch.sum(assoc.mask.to(torch.int32))

  if use_descriptor_residuals:
    d2c = DepthToColorTransform.between(depth_cam, color_cam)
    color_pxy, in_color = d2c.apply(assoc.pxy)
    dmask = assoc.mask & in_color
    t1_pxy, t2_pxy = cost.tangent_projections(
        surfels.pos, surfels.normal, surfels.radius_sq,
        frame_T_global[0:3, 0:3], frame_T_global[0:3, 3], color_cam)
    r1, r2, gx1, gy1, gx2, gy2 = cost.descriptor_terms_fused(
        kf_intensity, color_pxy, t1_pxy, t2_pxy, surfels.desc)
    # The gradients scale by the center-convention focal lengths
    # (kernel_opt_pose.cu:117-120; fx is the same in both conventions).
    J1 = cost.projected_position_pose_jacobian(
        gx1 * color_cam.fx, gy1 * color_cam.fy, assoc.local_pos)
    J2 = cost.projected_position_pose_jacobian(
        gx2 * color_cam.fx, gy2 * color_cam.fy, assoc.local_pos)
    H1, b1 = cost.accumulate_h_b(J1, r1, cost.descriptor_weight(r1), dmask)
    H2, b2 = cost.accumulate_h_b(J2, r2, cost.descriptor_weight(r2), dmask)
    H = H + H1 + H2
    b = b + b1 + b2
    if compute_cost:
      total_cost = total_cost + torch.sum(
          torch.where(dmask, cost.weighted_descriptor_cost(r1), 0.0))
      res_count = res_count + torch.sum(dmask.to(torch.int32))

  return H, b, total_cost, res_count


def estimate_frame_pose(
    global_T_frame_init: torch.Tensor,
    surfels: SurfelStore,
    kf_depth: torch.Tensor,
    kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor,
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_iterations: int = 30,
) -> Tuple[torch.Tensor, bool]:
  """Returns (global_T_frame_estimate, converged): one keyframe's GN loop,
  which ends on the host, so each iteration reads the convergence flag
  from the device. ``estimate_frame_poses_batched`` gives each of its lanes
  these steps."""
  T = global_T_frame_init
  converged = False
  for _ in range(max_iterations):
    H, b, _, _ = accumulate_pose_h_b(
        T, surfels, kf_depth, kf_normals, kf_intensity, depth_cam,
        color_cam, dp, use_depth_residuals, use_descriptor_residuals)
    x = solve_6x6(H, b)
    # A singular H (no associations) must not poison the pose.
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    T = T @ se3.exp(-x)
    converged = bool(is_scale1_converged(x))
    if converged:
      break
  return T, converged


def accumulate_lanes_h_b_plain(
    T: torch.Tensor, done: torch.Tensor, lanes: Sequence[int],
    surfels: SurfelStore, kf_depth: torch.Tensor, kf_normals: torch.Tensor,
    kf_intensity: torch.Tensor, depth_cam: PinholeCamera,
    color_cam: PinholeCamera, dp: DepthCalibration,
    use_depth_residuals: bool, use_descriptor_residuals: bool,
    out: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]) -> None:
  """The plain version of ``pose_h_b.accumulate``: ``accumulate_pose_h_b``
  of each of ``lanes`` (host ints) that ``done`` (K,) leaves open, at its
  pose in ``T`` (K, 4, 4), written into ``out`` = (H (K, 6, 6), b (K, 6),
  residual count (K,)); the rows of done lanes are left as they were.
  Reads nothing on the host: a done lane among ``lanes`` is computed and
  its result dropped."""
  H, b, count = out
  for k in lanes:
    Hk, bk, _, nk = accumulate_pose_h_b(
        T[k], surfels, kf_depth[k], kf_normals[k], kf_intensity[k],
        depth_cam, color_cam, dp, use_depth_residuals,
        use_descriptor_residuals, compute_cost=True)
    H[k] = torch.where(done[k], H[k], Hk)
    b[k] = torch.where(done[k], b[k], bk)
    count[k] = torch.where(done[k], count[k], nk)


def step_lanes_plain(T: torch.Tensor, done: torch.Tensor, H: torch.Tensor,
                     b: torch.Tensor, state: torch.Tensor,
                     all_done: torch.Tensor, lanes: Sequence[int]) -> None:
  """The plain version of ``pose_h_b.step``: the step of
  ``estimate_frame_pose`` (solve, finite guard, ``T <- T * exp(-x)``) of
  each of ``lanes`` (host ints) that ``done`` leaves open, in place on
  ``T``; a lane that converges is marked done after its step. ``state``
  (2,) becomes (lanes open after the step, lane steps so far), ``all_done``
  whether no lane is open. Reads nothing on the host."""
  open_before = torch.sum(~done)
  for k in lanes:
    x = solve_6x6(H[k], b[k])
    x = torch.where(torch.isfinite(x).all(), x, torch.zeros_like(x))
    T[k] = torch.where(done[k], T[k], T[k] @ se3.exp(-x))
    done[k] = done[k] | is_scale1_converged(x)
  state[0] = torch.sum(~done)
  state[1] += open_before
  all_done.copy_(done.all())


def _intrinsics(cam: PinholeCamera, device: torch.device) -> torch.Tensor:
  """(fx, fy, cx, cy) of a camera as one (4,) float32 tensor on ``device``,
  made on the device (a Python float is filled in, not copied from the
  host)."""
  return torch.stack([
      v.to(device, torch.float32).reshape(()) if isinstance(v, torch.Tensor)
      else torch.full((), float(v), dtype=torch.float32, device=device)
      for v in (cam.fx, cam.fy, cam.cx, cam.cy)])


def estimate_frame_poses_batched(
    global_T_frame_init: torch.Tensor,  # (K, 4, 4)
    optimize_mask: torch.Tensor,        # (K,) bool, keyframes to optimize
    surfels: SurfelStore,
    kf_depth: torch.Tensor,             # (K, H, W)
    kf_normals: torch.Tensor,           # (K, H, W, 2)
    kf_intensity: torch.Tensor,         # (K, H, W)
    depth_cam: PinholeCamera,
    color_cam: PinholeCamera,
    dp: DepthCalibration,
    use_depth_residuals: bool = True,
    use_descriptor_residuals: bool = True,
    max_iterations: int = 30,
    slots: Optional[Sequence[int]] = None,
    transfer_free: bool = False,
    axis: Optional[str] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
  """Frame-to-model pose GN of every keyframe in ``optimize_mask``.

  Within one alternation step the surfel map is fixed, so the keyframes'
  pose problems are independent. As in the reference, they are the lanes of
  one shared loop: each step accumulates the H/b of every open lane, solves
  and updates every open lane, and freezes a lane after the step that
  converged it. The loop ends when no lane is open, or after
  ``max_iterations`` steps; a lane's steps are those of
  ``estimate_frame_pose`` with the same cap. On a CUDA device each step is
  two kernel launches (``ops/pose_h_b.py``), which keep no temporaries of
  size keyframes x surfels; for CPU tensors the kernels' plain versions
  run, one keyframe at a time, over every slot at every step, keeping the
  open lanes' results.

  ``slots`` are the indices of ``optimize_mask`` as host ints, for a caller
  that has them (none means no step); otherwise the CPU path reads the mask
  back once. The all-done flag is read once per step or, with
  ``transfer_free``, polled (``utils/transfer.LoopEnd``); the lanes hold
  still once done, so the steps that run past convergence change nothing.
  "BA pose lane steps" is read once after the loop, and not recorded with
  ``transfer_free``, where no count is read. ``axis``: each shard's H/b
  are summed over the mesh axis before the step, which every shard makes
  alike; the counters are recorded by the axis' first shard.

  Returns (global_T_frame (K, 4, 4), moved (K,) bool). ``moved`` is the
  reference's frame_moved = !IsScale1PoseEstimationConverged(diff.log()) on
  the total pose change (direct_ba_alternating.cc:564-566)."""
  dev = global_T_frame_init.device
  cuda = dev.type == "cuda"
  k = global_T_frame_init.shape[0]
  T = global_T_frame_init.clone(memory_format=torch.contiguous_format)
  steps = 0
  if not cuda and slots is None:
    slots = torch.nonzero(optimize_mask).flatten().tolist()
  if slots is None or len(slots):
    done = ~optimize_mask.to(dev)
    out = (torch.zeros((k, 6, 6), dtype=torch.float32, device=dev),
           torch.zeros((k, 6), dtype=torch.float32, device=dev),
           torch.zeros((k,), dtype=torch.int32, device=dev))
    state = torch.zeros((2,), dtype=torch.int32, device=dev)
    all_done = torch.zeros((), dtype=torch.bool, device=dev)
    if cuda:
      surfels = surfels._replace(
          count=surfels.count.to(dev, non_blocking=True),
          **{name: getattr(surfels, name).contiguous()
             for name in ("pos", "normal", "radius_sq", "desc", "valid")})
      kf_depth, kf_normals, kf_intensity = (
          x.contiguous() for x in (kf_depth, kf_normals, kf_intensity))
      intrinsics = (_intrinsics(depth_cam, dev), _intrinsics(color_cam, dev))
      partials = torch.empty(
          (pose_h_b.blocks(surfels.capacity, dev), k, pose_h_b.SUMS),
          dtype=torch.float32, device=dev)
      ticket = torch.zeros((), dtype=torch.int32, device=dev)
    end = LoopEnd(dev, transfer_free, axis)
    for _ in range(max_iterations):
      if cuda:
        pose_h_b.accumulate(
            T, done, surfels, kf_depth, kf_normals, kf_intensity,
            *intrinsics, (color_cam.width, color_cam.height), dp,
            use_depth_residuals, use_descriptor_residuals, out, partials,
            ticket)
      else:
        accumulate_lanes_h_b_plain(
            T, done, slots, surfels, kf_depth, kf_normals, kf_intensity,
            depth_cam, color_cam, dp, use_depth_residuals,
            use_descriptor_residuals, out)
      H, b, _ = out if axis is None else spmd.psum(out, axis)
      if cuda:
        pose_h_b.step(T, done, H, b, state, all_done)
      else:
        step_lanes_plain(T, done, H, b, state, all_done, slots)
      steps += 1
      if end.done(all_done):
        break
    if axis is None or spmd.axis_index(axis) == 0:
      Timing.count("BA pose GN steps", steps)
      if end.reads:
        Timing.count("BA pose lane steps", int(state[1]))
  diff = se3.inverse(global_T_frame_init) @ T
  moved = optimize_mask & ~is_scale1_converged(se3.log(diff))
  return T, moved
