"""The plain reference of one joint bundle-adjustment step: the Gauss-Newton
system over keyframe poses and surfels that the reference BAD SLAM's
``BundleAdjustmentPCG`` solves (direct_ba_pcg.cc:62-119 and 240-471;
kernel_pcg.cu's PCGInit and PCGStep1), built by automatic
differentiation, and its step by Jacobi-preconditioned conjugate gradients.
Plain torch: it imports nothing of the program under test and no JAX.

The map comes as plain tensors (``JointMap``). For every participating
keyframe, one at a time, and its associated surfels in blocks of ``block``:

1. The linearization point, in float32: a frozen copy of the program's rules
   (as ``reference/preprocess.py`` copies the kernel's chain): the surfel
   to pixel association (the depth band of 10 propagated stddevs, the
   normal facing the camera, the 40-degree normal test), the depth residual
   sigma^-1 n . (u - p) with its Tukey weight (parameter 10), and the two
   descriptor residuals 180 (I(t_i) - I(c)) - d_i with their Huber weights
   (parameter 10, scale 0.01) and the intensity gradients the published
   method uses (cost_function.cuh:115-254).
2. The residuals as functions of the unknowns, in float64: the pose x (6,
   translation first) of ``global_T_frame(x) = T expm(hat(x))``
   (``torch.linalg.matrix_exp``), a surfel's offset s along its normal and
   its two descriptor unknowns. ``J p`` is ``torch.func.jvp`` of them and
   ``J^T v`` is ``torch.func.vjp``; the weights stay at the linearization
   point. Then r = -J^T W F, M = diag(J^T W J) + eps, and
   H p = (J^T W J + eps I) p with the gauge keyframe's rows held fixed: its
   rows of r and of H p are 0 and its rows of M are 1 (kernel_pcg.cu:44,
   kDiagEpsilon = 1e-8).
3. ``solve``: CG with the Jacobi preconditioner, at most
   ``iterations`` steps, ending where r^T M^-1 r falls to 1e-10 of its first
   value (direct_ba_pcg.cc:339-471). ``dense_step`` solves the same system
   by ``torch.linalg.solve`` at small sizes.

Departures from "J is the residual's derivative", as the published method
has them:
  * the descriptor residuals' Jacobian is the intensity gradient written
    out, not the derivative of the bilinear samples: with g_i = 180
    (grad I(t_i) - grad I(c)), each gradient the bilinear interpolation's
    within its texel (cost_function.cuh:191-254), all three sample points
    are taken to move as the surfel's center c moves, so
    F_i(x, s, d) = r_i + g_i . (c(x, s) - c(0, 0)) - d_i, whose derivative
    autograd takes through the projection c of the moved center;
  * the depth residual's scale sigma^-1, the propagated inverse stddev,
    is held at the linearization point, as are the association (the hit
    pixel's unprojection u) and the robust weights.
The pose and depth Jacobians come from autograd; the program derives them
by hand, which is what a comparison of the two tests.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Sequence, Tuple

import torch
from torch.func import jvp, vjp

DIAG_EPSILON = 1e-8
# cos(40 deg), kernels.cuh:56-58; cost_function.cuh:48-52, 126.
COS_NORMAL_COMPATIBILITY = 0.76604
DEPTH_TUKEY = 10.0
DEPTH_UNCERTAINTY_FACTOR = 0.1
DESCRIPTOR_WEIGHT = 1e-2
DESCRIPTOR_HUBER = 10.0
TANGENT_SCALING = 2.0
# The end test of the CG loop: r^T M^-1 r below this share of its first
# value (plus 1e-30).
CG_THRESHOLD = 1e-10
BLOCK = 1 << 16


@dataclasses.dataclass
class Camera:
  """A pinhole camera in the pixel-corner convention (a projected position
  p covers pixel int(p); an integer pixel's unprojection uses its center,
  cx - 0.5). fx, fy, cx, cy are 0-d float32 tensors."""
  width: int
  height: int
  fx: torch.Tensor
  fy: torch.Tensor
  cx: torch.Tensor
  cy: torch.Tensor

  @classmethod
  def of(cls, width: int, height: int, intr: torch.Tensor) -> "Camera":
    intr = intr.to(torch.float32)
    return cls(int(width), int(height), intr[0], intr[1], intr[2], intr[3])

  def project(self, p: torch.Tensor) -> torch.Tensor:
    z = p[..., 2]
    return torch.stack([self.fx * (p[..., 0] / z) + self.cx,
                        self.fy * (p[..., 1] / z) + self.cy], dim=-1)


@dataclasses.dataclass
class JointMap:
  """A surfel map and its keyframes, as plain tensors on one device."""
  pos: torch.Tensor               # (N, 3) global surfel positions
  normal: torch.Tensor            # (N, 3) global unit normals
  desc: torch.Tensor              # (N, 2) descriptors
  radius_sq: torch.Tensor         # (N,) squared radii
  valid: torch.Tensor             # (N,) bool
  active: torch.Tensor            # (N,) bool
  global_T_frame: torch.Tensor    # (K, 4, 4) keyframe poses
  depth: torch.Tensor             # (K, H, W) metric depth, 0 = none
  normals: torch.Tensor           # (K, H, W, 2) x, y of the pixel normals
  intensity: torch.Tensor         # (K, Hc, Wc) in [0, 1]
  depth_cam: Camera
  color_cam: Camera
  a: torch.Tensor                 # () depth deformation
  cfactor: torch.Tensor           # (ceil(H / cell), ceil(W / cell))
  cell_size: int
  baseline_fx: torch.Tensor       # ()

  @classmethod
  def of(cls, surfels, keyframes, depth_intr, color_intr, depth_size,
         color_size, a, cfactor, cell_size, baseline_fx) -> "JointMap":
    """From a surfel store and a keyframe store given as records with named
    fields (pos, normal, desc, radius_sq, valid, active; global_T_frame,
    depth, normals, intensity), intrinsics (fx, fy, cx, cy, corner
    convention) and (width, height) sizes."""
    return cls(surfels.pos, surfels.normal, surfels.desc, surfels.radius_sq,
               surfels.valid, surfels.active, keyframes.global_T_frame,
               keyframes.depth, keyframes.normals, keyframes.intensity,
               Camera.of(*depth_size, depth_intr),
               Camera.of(*color_size, color_intr), a, cfactor, int(cell_size),
               baseline_fx)


class Vector(NamedTuple):
  """The unknowns (or a vector over them): 6 a keyframe pose, 3 a
  surfel."""
  poses: torch.Tensor   # (K, 6)
  spos: torch.Tensor    # (N,)
  sdesc: torch.Tensor   # (N, 2)

  def dot(self, other: "Vector") -> torch.Tensor:
    return sum(torch.sum(a * b) for a, b in zip(self, other))

  def __add__(self, other):
    return Vector(*(a + b for a, b in zip(self, other)))

  def __sub__(self, other):
    return Vector(*(a - b for a, b in zip(self, other)))

  def scale(self, s):
    return Vector(*(s * a for a in self))

  def mul(self, other):
    return Vector(*(a * b for a, b in zip(self, other)))


def zeros(k: int, n: int, device, dtype=torch.float64) -> Vector:
  return Vector(torch.zeros((k, 6), dtype=dtype, device=device),
                torch.zeros((n,), dtype=dtype, device=device),
                torch.zeros((n, 2), dtype=dtype, device=device))


# --- 1. the linearization point, in float32 (the program's rules) ---


def _gather(img, iy, ix):
  h, w = img.shape[0], img.shape[1]
  lin = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(-1)
  flat = img.reshape((h * w,) + img.shape[2:])
  return flat[lin].reshape(iy.shape + img.shape[2:])


def _bilinear_with_grad(img, x, y):
  """The texture sample at corner-convention (x, y) with clamp-to-edge
  addressing, and its gradient within the texel."""
  ix = torch.clamp(x - 0.5, min=0.0).to(torch.int64)
  iy = torch.clamp(y - 0.5, min=0.0).to(torch.int64)
  tx = torch.clamp(x - 0.5 - ix.to(x.dtype), 0.0, 1.0)
  ty = torch.clamp(y - 0.5 - iy.to(y.dtype), 0.0, 1.0)
  tl, tr = _gather(img, iy, ix), _gather(img, iy, ix + 1)
  bl, br = _gather(img, iy + 1, ix), _gather(img, iy + 1, ix + 1)
  top = tl + tx * (tr - tl)
  bottom = bl + tx * (br - bl)
  value = top + ty * (bottom - top)
  dx = (br - bl) * ty + (tr - tl) * (1.0 - ty)
  dy = (br - tr) * tx + (bl - tl) * (1.0 - tx)
  return value, dx, dy


def _inverse(T):
  R, t = T[0:3, 0:3], T[0:3, 3]
  Rt = R.transpose(-1, -2)
  return Rt, -torch.einsum("ij,j->i", Rt, t)


class Lanes(NamedTuple):
  """One keyframe's associated surfels at the linearization point. Float64
  but for ``idx``; the descriptor weights are 0 where the center projects
  outside the color image."""
  idx: torch.Tensor        # (M,) int64 surfel slots
  u: torch.Tensor          # (M, 3) the hit pixel's unprojection
  inv_sigma: torch.Tensor  # (M,)
  r_depth: torch.Tensor    # (M,)
  w_depth: torch.Tensor
  r1: torch.Tensor
  r2: torch.Tensor
  w1: torch.Tensor
  w2: torch.Tensor
  g1: torch.Tensor         # (M, 2) d r1 / d (center pixel)
  g2: torch.Tensor
  c0: torch.Tensor         # (M, 2) the center's projection at x = 0


def _tukey_weight(r, p):
  q = r / p
  term = 1.0 - q * q
  return torch.where(torch.abs(r) < p, term * term, 0.0)


def _huber_weight(r, p):
  a = torch.abs(r)
  return torch.where(a < p, 1.0, p / torch.clamp(a, min=1e-30))


def linearize(m: JointMap, k: int) -> Lanes:
  """Keyframe ``k``'s lanes: the association and residuals of its surfels
  (valid and active) at the map's state."""
  dcam, ccam = m.depth_cam, m.color_cam
  Rfg, tfg = _inverse(m.global_T_frame[k])
  pos, normal = m.pos, m.normal
  local = pos @ Rfg.T + tfg
  z_ok = local[..., 2] > 0.0
  unit_z = torch.eye(3, dtype=pos.dtype, device=pos.device)[2]
  pxy = dcam.project(torch.where(z_ok[..., None], local, unit_z))
  x, y = pxy[..., 0], pxy[..., 1]
  in_img = (x >= 0) & (y >= 0) & (x < dcam.width) & (y < dcam.height) & z_ok
  pxy_int = torch.where(in_img[..., None], pxy, 0.0).to(torch.int64)
  px = pxy_int[..., 0].clamp(0, dcam.width - 1)
  py = pxy_int[..., 1].clamp(0, dcam.height - 1)
  measured = _gather(m.depth[k], py, px)
  depth_ok = measured > 0.0
  cfac = _gather(m.cfactor, py // m.cell_size, px // m.cell_size)
  inv_d = 1.0 / torch.where(depth_ok, measured, 1.0)
  calibrated = torch.where(
      depth_ok, 1.0 / (inv_d + cfac * torch.exp(-m.a * inv_d)), 0.0)
  lnormal = normal @ Rfg.T
  fx_inv, fy_inv = 1.0 / dcam.fx, 1.0 / dcam.fy
  cx_inv = -(dcam.cx - 0.5) / dcam.fx
  cy_inv = -(dcam.cy - 0.5) / dcam.fy
  nx = fx_inv * px.to(pos.dtype) + cx_inv
  ny = fy_inv * py.to(pos.dtype) + cy_inv
  denom = (DEPTH_UNCERTAINTY_FACTOR
           * torch.abs(lnormal[..., 0] * nx + lnormal[..., 1] * ny
                       + lnormal[..., 2]) * calibrated * calibrated)
  inv_sigma = m.baseline_fx / torch.clamp(denom, min=1e-12)
  threshold = DEPTH_TUKEY / inv_sigma
  diff = calibrated - local[..., 2]
  base = m.valid & m.active & in_img & depth_ok
  within = base & (torch.abs(diff) <= threshold)
  facing = torch.sum(local * lnormal, dim=-1) <= 0.0
  pn_xy = _gather(m.normals[k], py, px)
  pn_z = -torch.sqrt(torch.clamp(
      1.0 - pn_xy[..., 0] ** 2 - pn_xy[..., 1] ** 2, min=0.0))
  pixel_normal = torch.cat([pn_xy, pn_z[..., None]], dim=-1)
  compat = (torch.sum(lnormal * pixel_normal, dim=-1)
            >= COS_NORMAL_COMPATIBILITY)
  mask = within & facing & compat

  # The depth residual.
  px_f, py_f = px.to(pos.dtype), py.to(pos.dtype)
  u = torch.stack([calibrated * (fx_inv * px_f + cx_inv),
                   calibrated * (fy_inv * py_f + cy_inv), calibrated], -1)
  r_depth = inv_sigma * torch.sum(lnormal * (u - local), dim=-1)
  w_depth = _tukey_weight(r_depth, DEPTH_TUKEY)

  # The descriptor residuals: the depth pixel taken to the color image, the
  # two tangent points at twice the radius.
  sx, sy = ccam.fx / dcam.fx, ccam.fy / dcam.fy
  cpx = torch.stack([sx * pxy[..., 0] + (ccam.cx - sx * dcam.cx),
                     sy * pxy[..., 1] + (ccam.cy - sy * dcam.cy)], dim=-1)
  in_color = ((cpx[..., 0] >= 0) & (cpx[..., 1] >= 0)
              & (cpx[..., 0] < ccam.width) & (cpx[..., 1] < ccam.height))
  eye = torch.eye(3, dtype=normal.dtype, device=normal.device)
  axis = torch.where((torch.abs(normal[..., 0]) > 0.9)[..., None], eye[1],
                     eye[0])
  t1 = torch.linalg.cross(normal, axis)
  t1 = t1 * (TANGENT_SCALING * torch.sqrt(m.radius_sq / torch.clamp(
      torch.sum(t1 * t1, dim=-1), min=1e-12)))[..., None]
  t2 = torch.linalg.cross(normal, t1)
  t2 = t2 * (TANGENT_SCALING * torch.sqrt(m.radius_sq / torch.clamp(
      torch.sum(t2 * t2, dim=-1), min=1e-12)))[..., None]
  p1 = ccam.project((pos + t1) @ Rfg.T + tfg)
  p2 = ccam.project((pos + t2) @ Rfg.T + tfg)
  img = m.intensity[k]
  c, c_dx, c_dy = _bilinear_with_grad(img, cpx[..., 0], cpx[..., 1])
  i1, t1_dx, t1_dy = _bilinear_with_grad(img, p1[..., 0], p1[..., 1])
  i2, t2_dx, t2_dy = _bilinear_with_grad(img, p2[..., 0], p2[..., 1])
  r1 = 180.0 * (i1 - c) - m.desc[..., 0]
  r2 = 180.0 * (i2 - c) - m.desc[..., 1]
  g1 = torch.stack([180.0 * (t1_dx - c_dx), 180.0 * (t1_dy - c_dy)], -1)
  g2 = torch.stack([180.0 * (t2_dx - c_dx), 180.0 * (t2_dy - c_dy)], -1)
  dmask = mask & in_color
  w1 = torch.where(dmask, DESCRIPTOR_WEIGHT * _huber_weight(
      r1, DESCRIPTOR_HUBER), 0.0)
  w2 = torch.where(dmask, DESCRIPTOR_WEIGHT * _huber_weight(
      r2, DESCRIPTOR_HUBER), 0.0)

  idx = torch.nonzero(mask).flatten()
  f64 = torch.float64
  lanes = Lanes(idx, *(v[idx].to(f64) for v in (
      u, inv_sigma, r_depth, w_depth, r1, r2, w1, w2, g1, g2)),
      torch.zeros((len(idx), 2), dtype=f64, device=idx.device))
  x0 = torch.zeros(6, dtype=f64, device=idx.device)
  c0 = _center(m, k, lanes, x0, torch.zeros(len(idx), dtype=f64,
                                            device=idx.device))
  return lanes._replace(c0=c0)


# --- 2. the residuals as functions of the unknowns, in float64 ---


def _hat4(x: torch.Tensor) -> torch.Tensor:
  z = torch.zeros((), dtype=x.dtype, device=x.device)
  u, w = x[0:3], x[3:6]
  return torch.stack([
      torch.stack([z, -w[2], w[1], u[0]]),
      torch.stack([w[2], z, -w[0], u[1]]),
      torch.stack([-w[1], w[0], z, u[2]]),
      torch.stack([z, z, z, z])])


def _local(m: JointMap, k: int, idx, x, s):
  """The surfels ``idx``, each moved by s along its normal, and their
  normals, in the frame of keyframe ``k`` at pose x."""
  T = m.global_T_frame[k].to(torch.float64) @ torch.linalg.matrix_exp(
      _hat4(x))
  R, t = T[0:3, 0:3], T[0:3, 3]
  n = m.normal[idx].to(torch.float64)
  p = m.pos[idx].to(torch.float64) + s[:, None] * n
  return (p - t) @ R, n @ R


def _project64(cam: Camera, p):
  return torch.stack([cam.fx.double() * (p[:, 0] / p[:, 2]) + cam.cx.double(),
                      cam.fy.double() * (p[:, 1] / p[:, 2]) + cam.cy.double()],
                     dim=-1)


def _center(m, k, lanes, x, s):
  p, _ = _local(m, k, lanes.idx, x, s)
  return _project64(m.color_cam, p)


def _residuals(m: JointMap, k: int, lanes: Lanes):
  """F(x, s, d) of keyframe ``k``'s lanes: (depth, descriptor 1,
  descriptor 2), each (M,)."""
  def F(x, s, d):
    p, n = _local(m, k, lanes.idx, x, s)
    depth = lanes.inv_sigma * torch.sum(n * (lanes.u - p), dim=-1)
    moved = _project64(m.color_cam, p) - lanes.c0
    f1 = lanes.r1 + torch.sum(lanes.g1 * moved, dim=-1) - d[:, 0]
    f2 = lanes.r2 + torch.sum(lanes.g2 * moved, dim=-1) - d[:, 1]
    return depth, f1, f2
  return F


class System:
  """The joint GN system of a map at its state: the participating
  keyframes ``slots``, the gauge keyframe ``gauge``. Its lanes are formed
  once; every product reads them."""

  def __init__(self, m: JointMap, slots: Sequence[int], gauge: int,
               block: int = BLOCK):
    self.map, self.slots, self.gauge = m, list(slots), int(gauge)
    self.k = m.global_T_frame.shape[0]
    self.n = m.pos.shape[0]
    self.device = m.pos.device
    self.lanes: List[Tuple[int, Lanes]] = []
    for k in self.slots:
      full = linearize(m, k)
      for b in range(0, max(len(full.idx), 1), block):
        part = Lanes(*(v[b:b + block] for v in full))
        if len(part.idx):
          self.lanes.append((k, part))

  def _zeros(self) -> Vector:
    return zeros(self.k, self.n, self.device)

  def _origin(self, lanes):
    """The unknowns at the linearization point: x = 0, s = 0, d = 0."""
    f64 = dict(dtype=torch.float64, device=self.device)
    return (torch.zeros(6, **f64), torch.zeros(len(lanes.idx), **f64),
            torch.zeros((len(lanes.idx), 2), **f64))

  def _scatter(self, out: Vector, k, lanes, gx, gs, gd):
    out.poses[k] += gx
    out.spos.index_add_(0, lanes.idx, gs)
    out.sdesc.index_add_(0, lanes.idx, gd)

  def _gauge(self) -> torch.Tensor:
    return (torch.arange(self.k, device=self.device) == self.gauge)[:, None]

  def gradient(self) -> Vector:
    """r = -J^T W F, the gauge keyframe's rows 0."""
    out = self._zeros()
    for k, lanes in self.lanes:
      _, pull = vjp(_residuals(self.map, k, lanes), *self._origin(lanes))
      gx, gs, gd = pull((lanes.w_depth * lanes.r_depth, lanes.w1 * lanes.r1,
                         lanes.w2 * lanes.r2))
      self._scatter(out, k, lanes, -gx, -gs, -gd)
    return out._replace(poses=torch.where(self._gauge(), 0.0, out.poses))

  def diagonal(self) -> Vector:
    """M = diag(J^T W J) + eps, the gauge keyframe's rows 1: the columns of
    J by forward-mode products (6 pose directions; each residual depends on
    one surfel, so one product with all surfel offsets 1, and one per
    descriptor channel, gives every surfel's column)."""
    out = self._zeros()
    for k, lanes in self.lanes:
      F = _residuals(self.map, k, lanes)
      x0, s0, d0 = self._origin(lanes)
      w = (lanes.w_depth, lanes.w1, lanes.w2)

      def weighted_sq(tangents):
        _, cols = jvp(F, (x0, s0, d0), tangents)
        return sum(wi * c * c for wi, c in zip(w, cols))
      for j in range(6):
        e = torch.zeros_like(x0)
        e[j] = 1.0
        out.poses[k, j] += torch.sum(weighted_sq((e, s0, d0)))
      out.spos.index_add_(0, lanes.idx, weighted_sq(
          (x0, torch.ones_like(s0), d0)))
      for c in range(2):
        e = torch.zeros_like(d0)
        e[:, c] = 1.0
        out.sdesc[:, c].index_add_(0, lanes.idx, weighted_sq((x0, s0, e)))
    gauge = self._gauge()
    return Vector(torch.where(gauge, 1.0, out.poses + DIAG_EPSILON),
                  out.spos + DIAG_EPSILON, out.sdesc + DIAG_EPSILON)

  def hessian_product(self, p: Vector) -> Vector:
    """(J^T W J + eps I) p, matrix-free: J p by jvp, J^T (W J p) by vjp;
    the gauge keyframe's rows of p are taken as 0 and its rows of the
    product are 0."""
    gauge = self._gauge()
    p = p._replace(poses=torch.where(gauge, 0.0, p.poses))
    out = self._zeros()
    for k, lanes in self.lanes:
      F = _residuals(self.map, k, lanes)
      tangents = (p.poses[k], p.spos[lanes.idx], p.sdesc[lanes.idx])
      _, jp = jvp(F, self._origin(lanes), tangents)
      _, pull = vjp(F, *self._origin(lanes))
      gx, gs, gd = pull((lanes.w_depth * jp[0], lanes.w1 * jp[1],
                         lanes.w2 * jp[2]))
      self._scatter(out, k, lanes, gx, gs, gd)
    out = out + p.scale(DIAG_EPSILON)
    return out._replace(poses=torch.where(gauge, 0.0, out.poses))

  def solve(self, iterations: int = 30, threshold: float = CG_THRESHOLD
            ) -> Tuple[Vector, int]:
    """(delta, iterations run): Jacobi-preconditioned CG on H delta = r
    from delta = 0, ending after ``iterations`` steps or where r^T M^-1 r
    falls to ``threshold`` of its first value."""
    r = self.gradient()
    M_inv = Vector(*(1.0 / v for v in self.diagonal()))
    delta = self._zeros()
    g = M_inv.mul(r)
    pvec = g
    alpha_n = r.dot(g)
    end = threshold * alpha_n + 1e-30
    done = 0
    while done < iterations and bool(alpha_n > end):
      h = self.hessian_product(pvec)
      alpha = alpha_n / torch.clamp(pvec.dot(h), min=1e-30)
      delta = delta + pvec.scale(alpha)
      r = r - h.scale(alpha)
      g = M_inv.mul(r)
      beta_n = r.dot(g)
      pvec = g + pvec.scale(beta_n / torch.clamp(alpha_n, min=1e-30))
      alpha_n = beta_n
      done += 1
    return delta, done

  def dense_step(self) -> Vector:
    """The GN step by a dense solve, for small maps: H assembled from the
    Jacobian's columns (the pose columns of every lane and its surfel's
    three) over the participating poses but the gauge's and the surfels
    that some lane holds; every other unknown has r = 0, so its step is
    0."""
    surfels = torch.unique(torch.cat([l.idx for _, l in self.lanes]))
    poses = [k for k in self.slots if k != self.gauge]
    col = {k: 6 * i for i, k in enumerate(poses)}
    base = 6 * len(poses)
    at = torch.full((self.n,), -1, dtype=torch.int64, device=self.device)
    at[surfels] = torch.arange(len(surfels), device=self.device)
    size = base + 3 * len(surfels)
    H = torch.zeros((size, size), dtype=torch.float64, device=self.device)
    for k, lanes in self.lanes:
      F = _residuals(self.map, k, lanes)
      x0, s0, d0 = self._origin(lanes)
      m = len(lanes.idx)
      # Each lane's residuals (3) against its 9 unknowns (pose, s, d1, d2).
      J = torch.zeros((m, 3, 9), dtype=torch.float64, device=self.device)
      for j in range(6):
        e = torch.zeros_like(x0)
        e[j] = 1.0
        J[:, :, j] = torch.stack(jvp(F, (x0, s0, d0), (e, s0, d0))[1], -1)
      J[:, :, 6] = torch.stack(
          jvp(F, (x0, s0, d0), (x0, torch.ones_like(s0), d0))[1], -1)
      for c in range(2):
        e = torch.zeros_like(d0)
        e[:, c] = 1.0
        J[:, :, 7 + c] = torch.stack(jvp(F, (x0, s0, d0), (x0, s0, e))[1], -1)
      w = torch.stack([lanes.w_depth, lanes.w1, lanes.w2], -1)
      blocks = torch.einsum("lri,lr,lrj->lij", J, w, J)   # (m, 9, 9)
      s = base + 3 * at[lanes.idx]
      cols = torch.stack([s, s + 1, s + 2], -1)
      if k in col:
        pose = torch.arange(col[k], col[k] + 6, device=self.device)
        cols = torch.cat([pose.expand(m, 6), cols], -1)
      else:
        blocks = blocks[:, 6:, 6:]
      n = cols.shape[1]
      H.index_put_((cols[:, :, None].expand(m, n, n),
                    cols[:, None, :].expand(m, n, n)), blocks,
                   accumulate=True)
    H += DIAG_EPSILON * torch.eye(size, dtype=H.dtype, device=H.device)
    r = self.gradient()
    rhs = torch.cat([r.poses[poses].reshape(-1),
                     torch.stack([r.spos[surfels], r.sdesc[surfels, 0],
                                  r.sdesc[surfels, 1]], -1).reshape(-1)])
    x = torch.linalg.solve(H, rhs)
    out = self._zeros()
    if poses:
      out.poses[poses] = x[:base].reshape(-1, 6)
    xs = x[base:].reshape(-1, 3)
    out.spos[surfels] = xs[:, 0]
    out.sdesc[surfels] = xs[:, 1:]
    return out
