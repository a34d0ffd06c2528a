// Fused depth preprocess for Hopper (sm_90a): bilateral filter + cutoff,
// calibration + occlusion-aware normals, point radii + isolated-pixel
// removal, in one pass over the frame.
//
// Replaces: badslam_tpu/ops/pallas_preprocess.py:fused_depth_preprocess
// (the TPU kernel, which runs the whole chain of badslam_tpu/ops/
// depth_proc.py on a VMEM-resident frame). Its plain PyTorch version is
// badslam_tpu_torch/ops/fused_preprocess.py:fused_depth_preprocess_reference,
// and this kernel follows that chain operation for operation.
//
// What bounds it on an H100: operations, not bytes. Per pixel the function
// moves 20 bytes (one float32 read, four float32 writes) but evaluates the
// bilateral filter's taps (29 in the radius-3 disc: a subtraction, two
// products, a subtraction, an expf, two sums and a product each) and then
// ~230 more float operations for calibration, normals and radii, seven of
// them IEEE divisions or reciprocals. chip_smoke.py counts both for its
// inputs and prints which one binds: at 640x480 the operations take 1.77x
// the time of the bytes. Measured on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py; PERF.md section 6 has every number and how each design
// step was timed): 19 us of device time per launch, against 59 us for the
// first design and a bound of 3.2 us. What is left is the instruction
// count: nvcc emits 19 instructions per tap (expf alone is 8) and ~1,150
// per pixel in all,
// which is 10-12 us on 132 SMs with every scheduler busy every cycle, and
// a frame of only two tiles already takes 6 us: one CTA's chain of stages
// plus the launch, which no parallelism removes.
//
// What the design does about it:
//   1. One reciprocal per staged value, not per tap: stage 0 stores
//      1 / raw (with -1 marking an invalid sample) next to the raw depth,
//      so a tap is a shared-memory load, seven float operations, an expf
//      and a select. The bits are those of the plain version, which also
//      inverts each pixel once. (59 -> 37 us.)
//   2. The radius is a template parameter. The instantiation for radius 3
//      (the configuration's default, int(2.0 * 1.5 + 0.5)) unrolls the 29
//      taps in the plain version's order (dy outer, dx inner, so the sums
//      round the same way), with shared-memory offsets as immediates and
//      the spatial weights read from the kernel's parameters by
//      compile-time index. Any other radius runs the generic
//      instantiation (run-time loops, weights in shared memory): the same
//      kernel, never the plain version. (37 -> 24 us.)
//   3. Large tiles: the bilateral runs on the ring tile + 2, so a 32x8
//      tile computes 1.69 taps' worth per output, 32x20 1.35 (24 -> 20.7
//      us) and the 64x37 tile of a 640x480 frame 1.18. A CTA has 1,024
//      threads and every stage is a strided loop over its ring, so each
//      thread owns a fixed set of positions whatever the tile's height. A
//      center that fails the cutoff skips its taps.
//   4. Whole waves: the tile's width is fixed (the unrolled taps address
//      shared memory by it) but its height is chosen at launch, so that
//      the grid is a whole number of waves of one CTA per SM:
//      pick_tile_y. 640x480 becomes 10 x 13 = 130 CTAs on 132 SMs, one
//      wave with no tail (20.7 -> 18.6 us; a fixed 64x40 tile, 120 CTAs,
//      takes 19.6 us).
//   5. No prefetch. A persistent grid that stages the next tile's halo
//      with cp.async while the current tile computes measured slower at
//      both sizes tried with 32x20 tiles (27 against 20.5 us at 640x480
//      with two tiles per CTA, 78 against 68 us at 1280x960), and the
//      prefetch itself moved it by 1%: the read is 1.2 MB of a kernel
//      bound by arithmetic. With one wave there is no next tile at all.
//      It is not in this source.
//
// Tile and halo: the three stencils depend on each other, so each stage
// computes a ring wider than the next one needs:
//   stage 0  raw depth and its reciprocal on tile + (r + 2)
//   stage 1  bilateral on tile + 2            (normals need +1, radii +1)
//   stage 2  calibration and validity on tile + 1
//   stage 3  normals and radii on the tile, then the four writes.
// Intermediates never go to device memory. The tile is indexed by global
// pixel coordinates and masks the ragged edge, so any frame size works.
// Pixels outside the image read as 0 (invalid), as the reference's zero
// padding does, and each stage writes 0 for ring positions outside the
// image, as the reference pads each stage's output.
//
// Numerics: expf and IEEE division and square root (no --use_fast_math).
// FMA contraction is OFF (the build passes -fmad=false): every product and
// sum rounds on its own, as the plain version's separate tensor operations
// do, and the value term multiplies by the same float32 reciprocal. The
// normals amplify an ulp of filtered depth to ~1e-4 at 640x480, so the
// kernel keeps the plain version's rounding step for step. depth_intr and
// a are read through device pointers, so the kernel never makes the host
// wait for BA-updated calibration.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <atomic>

namespace {

constexpr int kTileX = 64;
constexpr int kMinTileY = 8, kMaxTileY = 48;     // of the launch's choice
constexpr int kThreads = 1024;                   // one CTA on each SM
constexpr int kRadius = 3;                       // the unrolled instantiation
constexpr int kSpatialEntries = kRadius * kRadius + 1;
// Row pitch of the later stages' rings (independent of the radius).
constexpr int kW1 = kTileX + 4;                  // bilateral, tile + 2
constexpr int kW2 = kTileX + 2;                  // calibration, tile + 1

struct Params {
  const float* raw;
  const float* intr;     // (4,) fx, fy, cx, cy (corner convention)
  const float* a;        // (1,)
  const float* cfactor;  // (hc, wc)
  float* filtered;       // (H, W)
  float* normals;        // (H, W, 2)
  float* radius_sq;      // (H, W)
  int height, width, cfactor_width, cell_size, radius;
  int tile_y;            // rows of one CTA's output tile (set by launch)
  double denom_xy;       // 2 sigma_xy^2
  float inv_denom_value; // 1 / (2 sigma_inv_depth^2)
  float max_depth;
  // -(dx^2 + dy^2) / (2 sigma_xy^2) by squared grid distance, computed in
  // double and rounded once, as the plain version's Python constants are
  // (filled for the unrolled radius only).
  float spatial[kSpatialEntries];
};

struct Camera {
  float fx_inv, fy_inv, cx_inv, cy_inv;
};

__device__ __forceinline__ void unproj(const Camera& c, float px, float py,
                                       float d, float* p) {
  p[0] = d * (c.fx_inv * px + c.cx_inv);
  p[1] = d * (c.fy_inv * py + c.cy_inv);
  p[2] = d;
}

__device__ __forceinline__ float dist_sq(const float* p, const float* q) {
  float dx = p[0] - q[0], dy = p[1] - q[1], dz = p[2] - q[2];
  return dx * dx + dy * dy + dz * dz;
}

// Occlusion-aware difference (ComputeNormalsCUDAKernel): the central
// difference when both sides lie at comparable distance, else the one-sided
// difference toward the nearer side.
__device__ __forceinline__ void pick_difference(const float* neg,
                                                const float* pos,
                                                const float* c, float* out) {
  float neg_sq = dist_sq(neg, c);
  float pos_sq = dist_sq(pos, c);
  float ratio = neg_sq / fmaxf(pos_sq, 1e-30f);
  bool use_central = (ratio < 4.0f) && (ratio > 0.25f);
  bool nearer_neg = neg_sq < pos_sq;
  for (int k = 0; k < 3; ++k) {
    out[k] = use_central ? pos[k] - neg[k]
                         : (nearer_neg ? c[k] - neg[k] : pos[k] - c[k]);
  }
}

// One bilateral tap: `inv_s` is the staged reciprocal of the sample, -1 for
// an invalid one. An invalid sample adds weight 0 and value 0 * -1 = -0,
// which leaves both sums as they are.
__device__ __forceinline__ void tap(float inv_s, float spatial,
                                    float inv_center, float inv_denom_value,
                                    float& wsum, float& vsum) {
  float diff = inv_center - inv_s;
  float wgt = expf(spatial - (diff * diff) * inv_denom_value);
  wgt = inv_s >= 0.0f ? wgt : 0.0f;
  wsum = wsum + wgt;
  vsum = vsum + wgt * inv_s;
}

// kR > 0: the bilateral radius, unrolled. kR == 0: p.radius at run time.
template <int kR>
__global__ void __launch_bounds__(kThreads, 1)
fused_depth_preprocess_kernel(const __grid_constant__ Params p) {
  extern __shared__ float smem[];
  const int r = kR > 0 ? kR : p.radius;
  const int h0 = r + 2;                 // raw halo
  const int tile_y = p.tile_y;
  const int w0 = kTileX + 2 * h0, n0 = w0 * (tile_y + 2 * h0);
  const int n1 = kW1 * (tile_y + 4), n2 = kW2 * (tile_y + 2);
  float* s_raw = smem;
  float* s_inv = s_raw + n0;
  float* s_filt = s_inv + n0;
  float* s_calib = s_filt + n1;
  float* s_depth2 = s_calib + n2;
  float* s_spatial = s_depth2 + n2;     // generic radius only

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * tile_y;
  const int W = p.width, H = p.height;

  // Stage 0: raw depth with halo, and its reciprocal; out-of-image reads
  // are 0. The generic radius also tabulates its spatial weights, per CTA.
  for (int i = tid; i < n0; i += kThreads) {
    int gx = x0 - h0 + i % w0, gy = y0 - h0 + i / w0;
    bool in = gx >= 0 && gx < W && gy >= 0 && gy < H;
    float s = in ? p.raw[(size_t)gy * W + gx] : 0.0f;
    s_raw[i] = s;
    s_inv[i] = s > 0.0f ? 1.0f / s : -1.0f;
  }
  if (kR == 0) {
    const int taps = (2 * r + 1) * (2 * r + 1);
    for (int i = tid; i < taps; i += kThreads) {
      int dx = i % (2 * r + 1) - r, dy = i / (2 * r + 1) - r;
      s_spatial[i] = (float)(-(double)(dx * dx + dy * dy) / p.denom_xy);
    }
  }
  __syncthreads();

  // Stage 1: bilateral filter in inverse depth on tile + 2. A position
  // outside the image has raw depth 0 and so comes out 0.
#pragma unroll 1
  for (int i = tid; i < n1; i += kThreads) {
    // Center of ring position (lx, ly) in s_raw coordinates: + (h0 - 2).
    const int c = (i / kW1 + r) * w0 + (i % kW1 + r);
    const float d = s_raw[c];
    float out = 0.0f;
    if (d > 0.0f && d <= p.max_depth) {
      const float inv_center = s_inv[c];
      float wsum = 0.0f, vsum = 0.0f;
      if constexpr (kR > 0) {
#pragma unroll
        for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
          for (int dx = -kR; dx <= kR; ++dx) {
            if (dx * dx + dy * dy > kR * kR) continue;
            tap(s_inv[c + dy * w0 + dx], p.spatial[dx * dx + dy * dy],
                inv_center, p.inv_denom_value, wsum, vsum);
          }
        }
      } else {
        for (int dy = -r; dy <= r; ++dy) {
          for (int dx = -r; dx <= r; ++dx) {
            if (dx * dx + dy * dy > r * r) continue;
            tap(s_inv[c + dy * w0 + dx],
                s_spatial[(dy + r) * (2 * r + 1) + (dx + r)], inv_center,
                p.inv_denom_value, wsum, vsum);
          }
        }
      }
      float o = wsum / (vsum > 0.0f ? vsum : 1.0f);
      out = wsum > 0.0f ? o : 0.0f;
    }
    s_filt[i] = out;
  }
  __syncthreads();

  Camera cam;
  {
    const float fx = p.intr[0], fy = p.intr[1], cx = p.intr[2],
                cy = p.intr[3];
    cam.fx_inv = 1.0f / fx;
    cam.fy_inv = 1.0f / fy;
    cam.cx_inv = -(cx - 0.5f) / fx;
    cam.cy_inv = -(cy - 0.5f) / fy;
  }
  const float a = p.a[0];

  // Stage 2: calibrated depth, and the normals' validity (border and
  // incomplete 4-neighbourhood) as the invalidated depth, on tile + 1.
  for (int i = tid; i < n2; i += kThreads) {
    int lx = i % kW2, ly = i / kW2;
    int gx = x0 - 1 + lx, gy = y0 - 1 + ly;
    float calib = 0.0f, depth2 = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      int j = (ly + 1) * kW1 + (lx + 1);
      float d = s_filt[j];
      bool valid = d > 0.0f;
      if (valid) {
        float c = p.cfactor[(size_t)(gy / p.cell_size) * p.cfactor_width
                            + gx / p.cell_size];
        float inv_depth = 1.0f / d;
        calib = 1.0f / (inv_depth + c * expf(-a * inv_depth));
      }
      bool border = gx == 0 || gy == 0 || gx == W - 1 || gy == H - 1;
      bool all_valid = valid && !border && s_filt[j - 1] > 0.0f &&
                       s_filt[j + 1] > 0.0f && s_filt[j - kW1] > 0.0f &&
                       s_filt[j + kW1] > 0.0f;
      depth2 = all_valid ? d : 0.0f;
    }
    s_calib[i] = calib;
    s_depth2[i] = depth2;
  }
  __syncthreads();

  // Stage 3: normals (calibrated depth) and radii (uncalibrated depth) on
  // the tile; write the outputs.
  for (int i = tid; i < kTileX * tile_y; i += kThreads) {
    const int tx = i % kTileX, ty = i / kTileX;
    const int gx = x0 + tx, gy = y0 + ty;
    if (gx >= W || gy >= H) continue;
    const int j = (ty + 1) * kW2 + (tx + 1);
    const float fx_ = (float)gx, fy_ = (float)gy;
    const float depth2 = s_depth2[j];
    const bool all_valid = depth2 > 0.0f;

    float pc[3], pl[3], pr[3], pt[3], pb[3];
    unproj(cam, fx_, fy_, s_calib[j], pc);
    unproj(cam, fx_ - 1.0f, fy_, s_calib[j - 1], pl);
    unproj(cam, fx_ + 1.0f, fy_, s_calib[j + 1], pr);
    unproj(cam, fx_, fy_ - 1.0f, s_calib[j - kW2], pt);
    unproj(cam, fx_, fy_ + 1.0f, s_calib[j + kW2], pb);
    float da[3], db[3];
    pick_difference(pl, pr, pc, da);  // left to right
    pick_difference(pb, pt, pc, db);  // bottom to top
    float nx = da[1] * db[2] - da[2] * db[1];
    float ny = da[2] * db[0] - da[0] * db[2];
    float nz = da[0] * db[1] - da[1] * db[0];
    float length = sqrtf(nx * nx + ny * ny + nz * nz);
    bool degenerate = !(length > 1e-6f);
    float sign = cam.fy_inv < 0.0f ? -1.0f : 1.0f;
    float inv_len = sign / (degenerate ? 1.0f : length);
    bool keep = all_valid && !degenerate;

    // Radii: min squared distance to the valid 4-neighbours (left, right,
    // top, bottom, the plain version's order); fewer than 4 -> invalid.
    float q[3];
    unproj(cam, fx_, fy_, depth2, q);
    const int offs[4] = {-1, 1, -kW2, kW2};
    const float ox[4] = {-1.0f, 1.0f, 0.0f, 0.0f};
    const float oy[4] = {0.0f, 0.0f, -1.0f, 1.0f};
    float min_sq = CUDART_INF_F;
    int count = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float dn = s_depth2[j + offs[k]];
      bool vn = dn > 0.0f;
      float pn[3];
      unproj(cam, fx_ + ox[k], fy_ + oy[k], dn, pn);
      float ds = dist_sq(pn, q);
      if (vn && ds < min_sq) min_sq = ds;
      count += vn ? 1 : 0;
    }
    bool ok = all_valid && count >= 4;

    const size_t o = (size_t)gy * W + gx;
    p.filtered[o] = ok ? depth2 : 0.0f;
    p.radius_sq[o] = ok ? min_sq : 0.0f;
    p.normals[2 * o] = keep ? nx * inv_len : 0.0f;
    p.normals[2 * o + 1] = keep ? ny * inv_len : 0.0f;
  }
}

// Shared memory of one CTA (bytes).
size_t smem_bytes(int radius, int tile_y) {
  int h0 = radius + 2;
  size_t n0 = (size_t)(kTileX + 2 * h0) * (tile_y + 2 * h0);
  size_t n1 = (size_t)kW1 * (tile_y + 4), n2 = (size_t)kW2 * (tile_y + 2);
  size_t taps = (size_t)(2 * radius + 1) * (2 * radius + 1);
  return (2 * n0 + n1 + 2 * n2 + taps) * sizeof(float);
}

// What a launch needs to know of its device, asked once per device: the
// SM count, and per instantiation (0: generic, 1: unrolled) the dynamic
// shared memory granted to the kernel beyond the 48 KB that need no asking.
// Static storage starts at zero: nothing asked yet. Racing first launches
// store the same values.
constexpr int kMaxDevices = 64;
constexpr size_t kSmemWithoutAsking = 48 * 1024;
struct DeviceState {
  std::atomic<int> sms;
  std::atomic<int> smem_granted[2];
};
DeviceState g_devices[kMaxDevices];

cudaError_t device_state(DeviceState** state) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  DeviceState* d = &g_devices[device];
  if (d->sms.load(std::memory_order_relaxed) == 0) {
    int sms = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (sms < 1) return cudaErrorInvalidDevice;
    d->sms.store(sms, std::memory_order_relaxed);
  }
  *state = d;
  return cudaSuccess;
}

// The tile height for a frame: tiles as tall as kMaxTileY allows (a taller
// tile has less ring per output), in the smallest whole number of waves,
// where a wave is one CTA on each SM. 640x480 on 132 SMs: 10 tiles across,
// so 13 rows of 37 lines, 130 CTAs.
int pick_tile_y(int width, int height, int sms) {
  const int tiles_x = (width + kTileX - 1) / kTileX;
  for (int waves = 1;; ++waves) {
    const int rows = waves * sms / tiles_x;
    if (rows < 1) continue;
    const int tile_y = (height + rows - 1) / rows;
    if (tile_y <= kMaxTileY) return tile_y < kMinTileY ? kMinTileY : tile_y;
  }
}

template <int kR>
int launch(Params& p, cudaStream_t stream) {
  DeviceState* dev = nullptr;
  cudaError_t e = device_state(&dev);
  if (e != cudaSuccess) return (int)e;
  p.tile_y = pick_tile_y(p.width, p.height,
                         dev->sms.load(std::memory_order_relaxed));
  const size_t smem = smem_bytes(p.radius, p.tile_y);
  std::atomic<int>& granted = dev->smem_granted[kR > 0 ? 1 : 0];
  if (smem > kSmemWithoutAsking &&
      smem > (size_t)granted.load(std::memory_order_relaxed)) {
    e = cudaFuncSetAttribute(fused_depth_preprocess_kernel<kR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store((int)smem, std::memory_order_relaxed);
  }
  dim3 grid((p.width + kTileX - 1) / kTileX,
            (p.height + p.tile_y - 1) / p.tile_y);
  fused_depth_preprocess_kernel<kR><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` of the current device; returns the CUDA error of the
// device queries or of the launch, 0 for none.
int fused_depth_preprocess_launch(
    const float* raw, const float* intr, const float* a,
    const float* cfactor, float* filtered, float* normals, float* radius_sq,
    int height, int width, int cfactor_width, int cell_size, int radius,
    double denom_xy, float inv_denom_value, float max_depth, void* stream) {
  Params p{raw, intr, a, cfactor, filtered, normals, radius_sq,
           height, width, cfactor_width, cell_size, radius,
           /*tile_y=*/0,
           denom_xy, inv_denom_value, max_depth, {}};
  if (radius == kRadius) {
    for (int g = 0; g < kSpatialEntries; ++g) {
      p.spatial[g] = (float)(-(double)g / denom_xy);
    }
    return launch<kRadius>(p, (cudaStream_t)stream);
  }
  return launch<0>(p, (cudaStream_t)stream);
}

}  // extern "C"
