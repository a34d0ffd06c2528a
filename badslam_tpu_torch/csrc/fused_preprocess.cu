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
// What bounds it on an H100: the bilateral filter's exp taps (29 at the
// default radius 3, each an expf and an IEEE reciprocal) and the memory
// traffic of 1 read plus 4 plane writes per pixel (filtered depth, two
// normal components, radius). Intermediates never go to device memory:
// one CTA owns a 32x8 output tile and stages everything through shared
// memory.
//
// Tile and halo: the three stencils depend on each other, so each stage
// computes a ring wider than the next one needs:
//   stage 0  raw depth on tile + (r + 2)      (r = bilateral radius)
//   stage 1  bilateral on tile + 2            (normals need +1, radii +1)
//   stage 2  calibration and validity on tile + 1
//   stage 3  normals and radii on the tile, then the four writes.
// With r = 3 that is a 5-pixel halo: 42x18 raw values for 32x8 outputs,
// 7.5 KB of shared memory in all. The redundant ring work is ~50% at
// stage 1; a larger tile would cut it and is left to a tuning pass. The
// tile is indexed by global pixel coordinates and masks the ragged edge, so
// any frame size works. Pixels outside the image read as 0 (invalid), as
// the reference's zero padding does, and each stage writes 0 for ring
// positions outside the image, as the reference pads each stage's output.
//
// Numerics: expf and IEEE division and square root (no --use_fast_math).
// FMA contraction is OFF (the build passes -fmad=false): every product and
// sum rounds on its own, as the plain version's separate tensor operations
// do, and the value term multiplies by the same float32 reciprocal. The
// normals amplify an ulp of filtered depth to ~1e-4 at 640x480, so the
// kernel keeps the plain version's rounding step for step. depth_intr and a are read through device pointers, so the kernel
// never makes the host wait for BA-updated calibration.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;

struct Params {
  const float* raw;
  const float* intr;     // (4,) fx, fy, cx, cy (corner convention)
  const float* a;        // (1,)
  const float* cfactor;  // (hc, wc)
  float* filtered;       // (H, W)
  float* normals;        // (H, W, 2)
  float* radius_sq;      // (H, W)
  int height, width, cfactor_width, cell_size, radius;
  double denom_xy;       // 2 sigma_xy^2
  float inv_denom_value; // 1 / (2 sigma_inv_depth^2)
  float max_depth;
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

__global__ void __launch_bounds__(kThreads)
fused_depth_preprocess_kernel(Params p) {
  extern __shared__ float smem[];
  const int r = p.radius;
  const int h0 = r + 2;                 // raw halo
  const int w0 = kTileX + 2 * h0, n0 = w0 * (kTileY + 2 * h0);
  const int w1 = kTileX + 4, n1 = w1 * (kTileY + 4);   // bilateral, +2
  const int w2 = kTileX + 2, n2 = w2 * (kTileY + 2);   // calibration, +1
  const int taps = (2 * r + 1) * (2 * r + 1);
  float* s_raw = smem;
  float* s_filt = s_raw + n0;
  float* s_calib = s_filt + n1;
  float* s_depth2 = s_calib + n2;
  float* s_spatial = s_depth2 + n2;

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * kTileX, y0 = blockIdx.y * kTileY;
  const int W = p.width, H = p.height;

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

  // Stage 0: raw depth with halo; out-of-image reads are 0. The spatial
  // weights -(dx^2+dy^2) / (2 sigma_xy^2) are computed once per CTA in
  // double and rounded once, as the plain version's Python constants are.
  for (int i = tid; i < n0; i += kThreads) {
    int gx = x0 - h0 + i % w0, gy = y0 - h0 + i / w0;
    bool in = gx >= 0 && gx < W && gy >= 0 && gy < H;
    s_raw[i] = in ? p.raw[(size_t)gy * W + gx] : 0.0f;
  }
  for (int i = tid; i < taps; i += kThreads) {
    int dx = i % (2 * r + 1) - r, dy = i / (2 * r + 1) - r;
    s_spatial[i] = (float)(-(double)(dx * dx + dy * dy) / p.denom_xy);
  }
  __syncthreads();

  // Stage 1: bilateral filter in inverse depth on tile + 2.
  for (int i = tid; i < n1; i += kThreads) {
    int lx = i % w1, ly = i / w1;
    int gx = x0 - 2 + lx, gy = y0 - 2 + ly;
    float out = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      // Center of (lx, ly) in s_raw coordinates.
      int cx = lx + (h0 - 2), cy = ly + (h0 - 2);
      float d = s_raw[cy * w0 + cx];
      bool center_valid = d > 0.0f && d <= p.max_depth;
      float inv_center = 1.0f / (d > 0.0f ? d : 1.0f);
      float wsum = 0.0f, vsum = 0.0f;
      for (int dy = -r; dy <= r; ++dy) {
        for (int dx = -r; dx <= r; ++dx) {
          if (dx * dx + dy * dy > r * r) continue;
          float s = s_raw[(cy + dy) * w0 + (cx + dx)];
          bool sv = s > 0.0f;
          float inv_s = 1.0f / (sv ? s : 1.0f);
          float diff = inv_center - inv_s;
          float spatial = s_spatial[(dy + r) * (2 * r + 1) + (dx + r)];
          float wgt = sv ? expf(spatial - (diff * diff) * p.inv_denom_value)
                         : 0.0f;
          wsum = wsum + wgt;
          vsum = vsum + wgt * inv_s;
        }
      }
      float o = wsum / (vsum > 0.0f ? vsum : 1.0f);
      out = (center_valid && wsum > 0.0f) ? o : 0.0f;
    }
    s_filt[i] = out;
  }
  __syncthreads();

  // Stage 2: calibrated depth, and the normals' validity (border and
  // incomplete 4-neighbourhood) as the invalidated depth, on tile + 1.
  for (int i = tid; i < n2; i += kThreads) {
    int lx = i % w2, ly = i / w2;
    int gx = x0 - 1 + lx, gy = y0 - 1 + ly;
    float calib = 0.0f, depth2 = 0.0f;
    if (gx >= 0 && gx < W && gy >= 0 && gy < H) {
      int j = (ly + 1) * w1 + (lx + 1);
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
                       s_filt[j + 1] > 0.0f && s_filt[j - w1] > 0.0f &&
                       s_filt[j + w1] > 0.0f;
      depth2 = all_valid ? d : 0.0f;
    }
    s_calib[i] = calib;
    s_depth2[i] = depth2;
  }
  __syncthreads();

  // Stage 3: normals (calibrated depth) and radii (uncalibrated depth) on
  // the tile; write the outputs.
  const int tx = tid % kTileX, ty = tid / kTileX;
  const int gx = x0 + tx, gy = y0 + ty;
  if (gx >= W || gy >= H) return;
  const int j = (ty + 1) * w2 + (tx + 1);
  const float fx_ = (float)gx, fy_ = (float)gy;
  const float depth2 = s_depth2[j];
  const bool all_valid = depth2 > 0.0f;

  float pc[3], pl[3], pr[3], pt[3], pb[3];
  unproj(cam, fx_, fy_, s_calib[j], pc);
  unproj(cam, fx_ - 1.0f, fy_, s_calib[j - 1], pl);
  unproj(cam, fx_ + 1.0f, fy_, s_calib[j + 1], pr);
  unproj(cam, fx_, fy_ - 1.0f, s_calib[j - w2], pt);
  unproj(cam, fx_, fy_ + 1.0f, s_calib[j + w2], pb);
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
  const int offs[4] = {-1, 1, -w2, w2};
  const float ox[4] = {-1.0f, 1.0f, 0.0f, 0.0f};
  const float oy[4] = {0.0f, 0.0f, -1.0f, 1.0f};
  float min_sq = CUDART_INF_F;
  int count = 0;
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

}  // namespace

extern "C" {

// Shared memory the kernel needs for a bilateral radius (bytes).
size_t fused_depth_preprocess_smem_bytes(int radius) {
  int h0 = radius + 2;
  size_t n0 = (size_t)(kTileX + 2 * h0) * (kTileY + 2 * h0);
  size_t n1 = (size_t)(kTileX + 4) * (kTileY + 4);
  size_t n2 = (size_t)(kTileX + 2) * (kTileY + 2);
  size_t taps = (size_t)(2 * radius + 1) * (2 * radius + 1);
  return (n0 + n1 + 2 * n2 + taps) * sizeof(float);
}

// Launches on `stream`; returns cudaGetLastError() after the launch.
int fused_depth_preprocess_launch(
    const float* raw, const float* intr, const float* a,
    const float* cfactor, float* filtered, float* normals, float* radius_sq,
    int height, int width, int cfactor_width, int cell_size, int radius,
    double denom_xy, float inv_denom_value, float max_depth, void* stream) {
  Params p{raw, intr, a, cfactor, filtered, normals, radius_sq,
           height, width, cfactor_width, cell_size, radius,
           denom_xy, inv_denom_value, max_depth};
  size_t smem = fused_depth_preprocess_smem_bytes(radius);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fused_depth_preprocess_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
  fused_depth_preprocess_kernel<<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
