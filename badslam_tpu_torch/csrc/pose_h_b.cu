// Frame-to-model pose Gauss-Newton for every keyframe lane at once, for
// Hopper (sm_90a): the lanes' H/b in one pass over the surfels, and the
// lanes' solve and pose update in a second, one-block launch.
//
// Replaces no TPU kernel. The JAX package computes this function as an XLA
// program (badslam_tpu/models/pose_opt.py: accumulate_pose_h_b, vmapped
// over the keyframes inside estimate_frame_poses_batched's shared
// lax.while_loop); the original BAD SLAM has it as
// AccumulatePoseEstimationCoeffsCUDAKernel (kernel_opt_pose.cu:252-383).
// It was added because the port's plain version, a few hundred small
// launches and one host read per keyframe per Gauss-Newton step, made the
// BA pose phase host-bound. Its plain version is
// badslam_tpu_torch/models/pose_opt.py: accumulate_pose_h_b per lane
// (accumulate_lanes_h_b_plain) and solve_6x6 / se3.exp per lane
// (step_lanes_plain); this source follows that arithmetic operation for
// operation where it can (below).
//
// What bounds it on an H100: neither bytes nor operations, but the
// association's dependent gathers. Per (surfel, lane) the kernel reads the
// surfel once per block (36 bytes, staged in shared memory) and, for a
// surfel that projects into the lane's image, one depth, one normal, one
// cfactor and 12 intensity taps; most pairs end after the transform and
// the projection (~40 float operations). The bytes a step must move are the
// surfels and the lanes' images (PERF.md section 6 has the counts and the
// measured time).
//
// What the design does about it:
//   1. One launch for every lane. A block stages a chunk of surfels in
//      shared memory and then loops over its lanes that are still open (a
//      lane's `done` flag lives on the device, so the host never tells the
//      kernel which lanes to run), so a block reads a surfel once, not once
//      per lane. The grid's second dimension splits the lanes into groups
//      (lane g, g + gridDim.y, ...), as many as it takes to give the card
//      about eight blocks per SM: a small map has few chunks, and one block
//      per chunk walking every lane left most SMs idle (on an H100: 384 us
//      a launch at 25 lanes and 19 chunks, against 9 us of bound; 60 us
//      with the lane groups).
//   2. No temporaries of size lanes x surfels. Each thread sums its
//      surfels' contributions to the 28 values of a lane (H's upper
//      triangle 21, b 6, the residual count 1) in registers; the block
//      reduces them with warp shuffles in a fixed order into one partial
//      row per (block, lane). A block that no surfel of a lane reached
//      skips the reduction (a __syncthreads_or).
//   3. Persistent blocks along the surfels: gridDim.x is at most two
//      blocks per SM, each walking chunks blockIdx.x, blockIdx.x +
//      gridDim.x, ... and adding each chunk's sums into its own partial row
//      of the lane in that order, so the scratch is (gridDim.x, lanes, 28)
//      whatever the map's size.
//   4. The last block to finish (a ticket counter) sums the partial rows
//      over the blocks in block order and writes H (mirrored), b and the
//      count of each open lane. Every sum is taken in a fixed order, so a
//      step gives the same bits in every run.
//   5. The step kernel runs each open lane's solve on one thread:
//      solve_6x6's Jacobi equilibration, LU with partial pivoting in
//      float32 and two refinement steps, the finite guard,
//      T <- T * exp(-x) and IsScale1PoseEstimationConverged; a lane that
//      converges is frozen after that step (the step is applied, as in the
//      reference's shared loop). It writes the open-lane counts and one
//      all-lanes-done flag, the loop's only host read.
//
// Numerics: float32, IEEE division and square root, expf/sinf/cosf (no
// --use_fast_math), FMA contraction off (-fmad=false), so each product and
// sum rounds on its own as the plain version's tensor operations do. Where
// PyTorch on CUDA divides a tensor by a Python scalar it multiplies by the
// float32 reciprocal, and `scalar / tensor` is reciprocal(tensor) * scalar;
// the kernel does the same. What cannot match bit for bit: the plain
// version's small matrix products (the transforms, J^T W J) go to cuBLAS,
// whose summation order and FMAs are its own, and its LU is cuSOLVER's; the
// sums over surfels are taken in another order. The tests hold H and b to
// a tolerance and the poses to one (tests/test_torch_ba_models.py).

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;                     // surfels a thread holds
constexpr int kChunk = kThreads * kItems;     // surfels a block stages
constexpr int kBlocksPerSm = 2;               // resident, by registers
constexpr int kTargetBlocksPerSm = 8;         // launched, with lane groups
constexpr int kSums = 28;                     // H upper 21, b 6, count 1
constexpr int kWarps = kThreads / 32;
constexpr int kStepThreads = 128;

struct Params {
  // Surfels, capacity N.
  const float* pos;        // (N, 3)
  const float* normal;     // (N, 3)
  const float* radius_sq;  // (N,)
  const float* desc;       // (N, 2)
  const unsigned char* valid;  // (N,) bool
  const int* count;        // () allocation watermark
  int capacity;
  // Keyframe lanes.
  const float* T;          // (K, 4, 4) global_T_frame
  const unsigned char* done;   // (K,) bool
  const float* depth;      // (K, H, W)
  const float* normals;    // (K, H, W, 2)
  const float* intensity;  // (K, HI, WI)
  int lanes, height, width, int_height, int_width;
  // Cameras and depth calibration, read on the device.
  const float* depth_intr;   // (4,) fx, fy, cx, cy (corner convention)
  const float* color_intr;   // (4,)
  const float* a;            // ()
  const float* cfactor;      // (hc, wc)
  const float* baseline_fx;  // ()
  int cfactor_width, cell_size, color_width, color_height;
  int use_depth, use_desc;
  // Outputs and scratch.
  float* partials;           // (gridDim.x, K, kSums)
  unsigned int* ticket;      // (), zero between launches
  float* H;                  // (K, 6, 6)
  float* b;                  // (K, 6)
  int* res_count;            // (K,)
};

// What every thread of a block reads for a launch or a lane.
struct Consts {
  float dfx, dfy, dcx, dcy;          // depth camera
  float fx_inv, fy_inv, cx_inv, cy_inv;
  float cfx, cfy, ccx, ccy;          // color camera
  float tfx, tfy, tcx, tcy;          // depth -> color pixel transform
  float a, bfx;
};

struct Frame {
  float r[9];  // frame_T_global's rotation, row-major
  float t[3];
};

// torch.clamp(x, min=lo): NaN stays NaN.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// R v as the plain version's float32 product (N, 3) @ R.T rounds it on
// the card: an FMA chain over the index (cuBLAS; measured bit for bit on an
// H100). A surfel's pixel, and so which tap cell its gradients come from,
// then match the plain version's.
__device__ __forceinline__ void rotate(const Frame& f, const float* v,
                                       float* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    out[i] = fmaf(v[2], f.r[3 * i + 2],
                  fmaf(v[1], f.r[3 * i + 1], v[0] * f.r[3 * i]));
  }
}

// R p + t: the product, then the translation.
__device__ __forceinline__ void transform(const Frame& f, const float* p,
                                          float* out) {
  rotate(f, p, out);
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = out[i] + f.t[i];
}

// torch.linalg.cross(u, v).
__device__ __forceinline__ void cross(const float* u, const float* v,
                                      float* out) {
  out[0] = u[1] * v[2] - u[2] * v[1];
  out[1] = u[2] * v[0] - u[0] * v[2];
  out[2] = u[0] * v[1] - u[1] * v[0];
}

// interp.sample_bilinear_with_grad: corner-convention coordinates, taps at
// (x - 0.5, y - 0.5), clamp-to-edge.
__device__ __forceinline__ void sample(const float* img, int h, int w,
                                       float x, float y, float* value,
                                       float* dx, float* dy) {
  const float xm = x - 0.5f, ym = y - 0.5f;
  long long ix = (long long)clamp_min(xm, 0.0f);
  long long iy = (long long)clamp_min(ym, 0.0f);
  const float tx = clamp01(xm - (float)ix);
  const float ty = clamp01(ym - (float)iy);
  const long long x0 = ix < 0 ? 0 : (ix > w - 1 ? w - 1 : ix);
  const long long x1 = ix + 1 < 0 ? 0 : (ix + 1 > w - 1 ? w - 1 : ix + 1);
  const long long y0 = iy < 0 ? 0 : (iy > h - 1 ? h - 1 : iy);
  const long long y1 = iy + 1 < 0 ? 0 : (iy + 1 > h - 1 ? h - 1 : iy + 1);
  const float tl = __ldg(img + y0 * w + x0), tr = __ldg(img + y0 * w + x1);
  const float bl = __ldg(img + y1 * w + x0), br = __ldg(img + y1 * w + x1);
  const float top = tl + tx * (tr - tl);
  const float bottom = bl + tx * (br - bl);
  *value = top + ty * (bottom - top);
  *dx = (br - bl) * ty + (tr - tl) * (1.0f - ty);
  *dy = (br - tr) * tx + (bl - tl) * (1.0f - tx);
}

// cost.projected_position_pose_jacobian.
__device__ __forceinline__ void projected_jacobian(float gx, float gy,
                                                   const float* l,
                                                   float* j) {
  const float inv_z = 1.0f / l[2];
  const float z_sq = l[2] * l[2];
  const float inv_z_sq = inv_z * inv_z;
  const float xy = l[0] * l[1];
  j[0] = -gx * inv_z;
  j[1] = -gy * inv_z;
  j[2] = (l[0] * gx + l[1] * gy) * inv_z_sq;
  j[3] = ((l[1] * l[1] + z_sq) * gy + xy * gx) * inv_z_sq;
  j[4] = -((l[0] * l[0] + z_sq) * gx + xy * gy) * inv_z_sq;
  j[5] = -(l[0] * gy - l[1] * gx) * inv_z;
}

// acc += (J w)^T J, (J w)^T r (cost.accumulate_h_b on one lane).
__device__ __forceinline__ void add_term(const float* j, float r, float w,
                                         float* acc) {
  float jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) jw[i] = j[i] * w;
  int o = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
#pragma unroll
    for (int k = i; k < 6; ++k) acc[o++] += jw[i] * j[k];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += jw[i] * r;
}

// One surfel's contribution to one lane (pose_opt.accumulate_pose_h_b with
// association.associate_surfels). Returns whether it was associated.
__device__ bool contribute(const Params& p, const Consts& c, const Frame& f,
                           int lane, const float* pos, const float* nrm,
                           float radius_sq, float desc0, float desc1,
                           float* acc) {
  float l[3];
  transform(f, pos, l);
  const bool z_ok = l[2] > 0.0f;
  if (!z_ok) return false;
  const float px = c.dfx * (l[0] / l[2]) + c.dcx;
  const float py = c.dfy * (l[1] / l[2]) + c.dcy;
  if (!(px >= 0.0f && py >= 0.0f && px < (float)p.width &&
        py < (float)p.height)) {
    return false;
  }
  int ix = (int)px, iy = (int)py;
  ix = ix > p.width - 1 ? p.width - 1 : ix;
  iy = iy > p.height - 1 ? p.height - 1 : iy;
  const size_t pix = ((size_t)lane * p.height + iy) * p.width + ix;
  const float measured = __ldg(p.depth + pix);
  if (!(measured > 0.0f)) return false;
  const float cfac = __ldg(p.cfactor + (size_t)(iy / p.cell_size) *
                           p.cfactor_width + ix / p.cell_size);
  const float inv_depth = 1.0f / measured;
  const float calibrated =
      1.0f / (inv_depth + cfac * expf(-c.a * inv_depth));

  float ln[3];
  rotate(f, nrm, ln);
  const float nx = c.fx_inv * (float)ix + c.cx_inv;
  const float ny = c.fy_inv * (float)iy + c.cy_inv;
  const float denom = ((0.1f * fabsf((ln[0] * nx + ln[1] * ny) + ln[2]))
                       * calibrated) * calibrated;
  const float inv_stddev = c.bfx / clamp_min(denom, 1e-12f);
  const float threshold = (1.0f / inv_stddev) * 10.0f;
  const float depth_diff = calibrated - l[2];
  if (!(fabsf(depth_diff) <= threshold)) return false;
  if (!(((l[0] * ln[0] + l[1] * ln[1]) + l[2] * ln[2]) <= 0.0f)) {
    return false;
  }
  const float pnx = __ldg(p.normals + 2 * pix);
  const float pny = __ldg(p.normals + 2 * pix + 1);
  const float zsq = (1.0f - pnx * pnx) - pny * pny;
  const float pnz = -sqrtf(clamp_min(zsq, 0.0f));
  if (!(((ln[0] * pnx + ln[1] * pny) + ln[2] * pnz) >= 0.76604f)) {
    return false;
  }

  if (p.use_depth) {
    const float u[3] = {calibrated * nx, calibrated * ny, calibrated};
    const float r = inv_stddev * ((ln[0] * (u[0] - l[0])
                                   + ln[1] * (u[1] - l[1]))
                                  + ln[2] * (u[2] - l[2]));
    float j[6];
    j[0] = inv_stddev * ln[0];
    j[1] = inv_stddev * ln[1];
    j[2] = inv_stddev * ln[2];
    j[3] = inv_stddev * (-ln[1] * u[2] + ln[2] * u[1]);
    j[4] = inv_stddev * (ln[0] * u[2] - ln[2] * u[0]);
    j[5] = inv_stddev * (-ln[0] * u[1] + ln[1] * u[0]);
    const float quot = r * (1.0f / 10.0f);
    const float term = 1.0f - quot * quot;
    const float w = fabsf(r) < 10.0f ? term * term : 0.0f;
    add_term(j, r, w, acc);
    acc[27] += 1.0f;
  }

  if (p.use_desc) {
    const float cx = c.tfx * px + c.tcx;
    const float cy = c.tfy * py + c.tcy;
    if (cx >= 0.0f && cy >= 0.0f && cx < (float)p.color_width &&
        cy < (float)p.color_height) {
      // Two surfel-border tangent points (cost.tangent_projections).
      const float axis[3] = {fabsf(nrm[0]) > 0.9f ? 0.0f : 1.0f,
                             fabsf(nrm[0]) > 0.9f ? 1.0f : 0.0f, 0.0f};
      float t1[3], t2[3];
      cross(nrm, axis, t1);
      const float s1 = 2.0f * sqrtf(radius_sq / clamp_min(
          (t1[0] * t1[0] + t1[1] * t1[1]) + t1[2] * t1[2], 1e-12f));
#pragma unroll
      for (int i = 0; i < 3; ++i) t1[i] = t1[i] * s1;
      cross(nrm, t1, t2);
      const float s2 = 2.0f * sqrtf(radius_sq / clamp_min(
          (t2[0] * t2[0] + t2[1] * t2[1]) + t2[2] * t2[2], 1e-12f));
      float q1[3], q2[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        t2[i] = t2[i] * s2;
        q1[i] = pos[i] + t1[i];
        q2[i] = pos[i] + t2[i];
      }
      float m1[3], m2[3];
      transform(f, q1, m1);
      transform(f, q2, m2);
      const float x1 = c.cfx * (m1[0] / m1[2]) + c.ccx;
      const float y1 = c.cfy * (m1[1] / m1[2]) + c.ccy;
      const float x2 = c.cfx * (m2[0] / m2[2]) + c.ccx;
      const float y2 = c.cfy * (m2[1] / m2[2]) + c.ccy;
      const float* img = p.intensity + (size_t)lane * p.int_height *
                         p.int_width;
      float ic, icx, icy, i1, i1x, i1y, i2, i2x, i2y;
      sample(img, p.int_height, p.int_width, cx, cy, &ic, &icx, &icy);
      sample(img, p.int_height, p.int_width, x1, y1, &i1, &i1x, &i1y);
      sample(img, p.int_height, p.int_width, x2, y2, &i2, &i2x, &i2y);
      const float r1 = 180.0f * (i1 - ic) - desc0;
      const float r2 = 180.0f * (i2 - ic) - desc1;
      float j1[6], j2[6];
      projected_jacobian((180.0f * (i1x - icx)) * c.cfx,
                         (180.0f * (i1y - icy)) * c.cfy, l, j1);
      projected_jacobian((180.0f * (i2x - icx)) * c.cfx,
                         (180.0f * (i2y - icy)) * c.cfy, l, j2);
      const float a1 = fabsf(r1), a2 = fabsf(r2);
      const float w1 = 0.01f * (a1 < 10.0f ? 1.0f
                                : (1.0f / clamp_min(a1, 1e-30f)) * 10.0f);
      const float w2 = 0.01f * (a2 < 10.0f ? 1.0f
                                : (1.0f / clamp_min(a2, 1e-30f)) * 10.0f);
      add_term(j1, r1, w1, acc);
      add_term(j2, r2, w2, acc);
      acc[27] += 1.0f;  // the two descriptor terms count as one residual
    }
  }
  return true;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
pose_h_b_accumulate_kernel(Params p) {
  __shared__ float s_pos[3 * kChunk];
  __shared__ float s_nrm[3 * kChunk];
  __shared__ float s_r2[kChunk];
  __shared__ float s_desc[2 * kChunk];
  __shared__ unsigned char s_valid[kChunk];
  __shared__ float s_red[kWarps][kSums];
  __shared__ Consts s_c;
  __shared__ Frame s_f;
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int count = min(*p.count, p.capacity);
  const int chunks = (count + kChunk - 1) / kChunk;
  // Columns of blocks that own at least one chunk; the others hold no
  // partial rows.
  const int owners = min((int)gridDim.x, chunks);

  if (tid == 0) {
    Consts c;
    c.dfx = p.depth_intr[0];
    c.dfy = p.depth_intr[1];
    c.dcx = p.depth_intr[2];
    c.dcy = p.depth_intr[3];
    c.fx_inv = 1.0f / c.dfx;
    c.fy_inv = 1.0f / c.dfy;
    c.cx_inv = -(c.dcx - 0.5f) / c.dfx;
    c.cy_inv = -(c.dcy - 0.5f) / c.dfy;
    c.cfx = p.color_intr[0];
    c.cfy = p.color_intr[1];
    c.ccx = p.color_intr[2];
    c.ccy = p.color_intr[3];
    c.tfx = c.cfx / c.dfx;
    c.tfy = c.cfy / c.dfy;
    c.tcx = c.ccx - c.tfx * c.dcx;
    c.tcy = c.ccy - c.tfy * c.dcy;
    c.a = *p.a;
    c.bfx = *p.baseline_fx;
    s_c = c;
  }

  bool first = true;
  for (int chunk = blockIdx.x; chunk < chunks; chunk += gridDim.x) {
    const int begin = chunk * kChunk;
    const int n = min(kChunk, count - begin);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = tid; i < 3 * n; i += kThreads) {
      s_pos[i] = p.pos[3 * (size_t)begin + i];
      s_nrm[i] = p.normal[3 * (size_t)begin + i];
    }
    for (int i = tid; i < 2 * n; i += kThreads) {
      s_desc[i] = p.desc[2 * (size_t)begin + i];
    }
    for (int i = tid; i < kChunk; i += kThreads) {
      s_r2[i] = i < n ? p.radius_sq[begin + i] : 0.0f;
      s_valid[i] = i < n ? p.valid[begin + i] : 0;
    }

    for (int lane = blockIdx.y; lane < p.lanes; lane += gridDim.y) {
      if (p.done[lane]) continue;  // the same for every thread
      __syncthreads();  // staged chunk visible; s_f and s_red free
      if (tid == 0) {
        // frame_T_global = inverse(global_T_frame) (se3.inverse).
        const float* T = p.T + 16 * (size_t)lane;
        Frame f;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
          for (int k = 0; k < 3; ++k) f.r[3 * i + k] = T[4 * k + i];
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          f.t[i] = -((f.r[3 * i] * T[3] + f.r[3 * i + 1] * T[7])
                     + f.r[3 * i + 2] * T[11]);
        }
        s_f = f;
      }
      __syncthreads();

      float acc[kSums];
#pragma unroll
      for (int v = 0; v < kSums; ++v) acc[v] = 0.0f;
      bool any = false;
#pragma unroll
      for (int item = 0; item < kItems; ++item) {
        const int i = tid + item * kThreads;
        if (!s_valid[i]) continue;
        const float pos[3] = {s_pos[3 * i], s_pos[3 * i + 1],
                              s_pos[3 * i + 2]};
        const float nrm[3] = {s_nrm[3 * i], s_nrm[3 * i + 1],
                              s_nrm[3 * i + 2]};
        any |= contribute(p, s_c, s_f, lane, pos, nrm, s_r2[i], s_desc[2 * i],
                          s_desc[2 * i + 1], acc);
      }

      float* row = p.partials + ((size_t)blockIdx.x * p.lanes + lane) * kSums;
      if (!__syncthreads_or(any)) {
        if (first && tid < kSums) row[tid] = 0.0f;
        continue;
      }
      // Block sum in a fixed order: shuffles within each warp, then the
      // warps in index order.
#pragma unroll
      for (int v = 0; v < kSums; ++v) {
        float s = acc[v];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          s += __shfl_down_sync(0xffffffffu, s, off);
        }
        if ((tid & 31) == 0) s_red[tid >> 5][v] = s;
      }
      __syncthreads();
      if (tid < kSums) {
        float s = s_red[0][tid];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) s += s_red[w][tid];
        row[tid] = first ? s : row[tid] + s;
      }
    }
    first = false;
  }

  // The last block to finish sums the partial rows.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(p.ticket, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int pair = tid; pair < p.lanes * kSums; pair += kThreads) {
    const int lane = pair / kSums, v = pair % kSums;
    if (p.done[lane]) continue;
    float s = 0.0f;
    const float* col = p.partials + (size_t)lane * kSums + v;
    const size_t stride = (size_t)p.lanes * kSums;
#pragma unroll 8
    for (int blk = 0; blk < owners; ++blk) s += __ldcg(col + blk * stride);
    if (v < 21) {
      // Upper-triangle index v -> (row, column), mirrored.
      int r = 0, start = 0;
      while (v >= start + 6 - r) {
        start += 6 - r;
        ++r;
      }
      const int k = r + (v - start);
      p.H[36 * (size_t)lane + 6 * r + k] = s;
      p.H[36 * (size_t)lane + 6 * k + r] = s;
    } else if (v < 27) {
      p.b[6 * (size_t)lane + (v - 21)] = s;
    } else {
      p.res_count[lane] = (int)s;
    }
  }
  if (tid == 0) *p.ticket = 0u;
}

// ---- The step: one thread per open lane. ----

struct StepParams {
  float* T;                 // (K, 4, 4), updated in place
  unsigned char* done;      // (K,), updated in place
  const float* H;           // (K, 6, 6)
  const float* b;           // (K, 6)
  int* state;               // (2,): lanes open after the step, lane steps
  unsigned char* all_done;  // ()
  int lanes;
};

// LU with partial pivoting of a (6x6, row-major), in place; piv[k] is the
// row swapped into k at step k (LAPACK's getrf).
__device__ void lu6(float* a, int* piv) {
  for (int k = 0; k < 6; ++k) {
    int m = k;
    float best = fabsf(a[6 * k + k]);
    for (int i = k + 1; i < 6; ++i) {
      const float v = fabsf(a[6 * i + k]);
      if (v > best) {
        best = v;
        m = i;
      }
    }
    piv[k] = m;
    if (m != k) {
      for (int j = 0; j < 6; ++j) {
        const float t = a[6 * k + j];
        a[6 * k + j] = a[6 * m + j];
        a[6 * m + j] = t;
      }
    }
    const float inv = 1.0f / a[6 * k + k];
    for (int i = k + 1; i < 6; ++i) {
      const float l = a[6 * i + k] * inv;
      a[6 * i + k] = l;
      for (int j = k + 1; j < 6; ++j) a[6 * i + j] -= l * a[6 * k + j];
    }
  }
}

// Solve with the factors of lu6: rhs in, solution out, in place.
__device__ void lu6_solve(const float* lu, const int* piv, float* x) {
  for (int k = 0; k < 6; ++k) {
    if (piv[k] != k) {
      const float t = x[k];
      x[k] = x[piv[k]];
      x[piv[k]] = t;
    }
  }
  for (int i = 1; i < 6; ++i) {
    float s = x[i];
    for (int j = 0; j < i; ++j) s -= lu[6 * i + j] * x[j];
    x[i] = s;
  }
  for (int i = 5; i >= 0; --i) {
    float s = x[i];
    for (int j = i + 1; j < 6; ++j) s -= lu[6 * i + j] * x[j];
    x[i] = s / lu[6 * i + i];
  }
}

// pose_opt.solve_6x6: Jacobi equilibration, the float32 solve, two steps
// of iterative refinement.
__device__ void solve6(const float* H, const float* b, float* x) {
  float s[6], hs[36], lu[36], bs[6], y[6];
  int piv[6];
  for (int i = 0; i < 6; ++i) {
    s[i] = 1.0f / sqrtf(clamp_min(H[7 * i], 1e-30f));
  }
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) hs[6 * i + j] = (H[6 * i + j] * s[i]) * s[j];
    bs[i] = b[i] * s[i];
  }
  for (int i = 0; i < 36; ++i) lu[i] = hs[i];
  lu6(lu, piv);
  for (int i = 0; i < 6; ++i) y[i] = bs[i];
  lu6_solve(lu, piv, y);
  for (int step = 0; step < 2; ++step) {
    float r[6];
    for (int i = 0; i < 6; ++i) {
      float m = 0.0f;
      for (int j = 0; j < 6; ++j) m += hs[6 * i + j] * y[j];
      r[i] = bs[i] - m;
    }
    lu6_solve(lu, piv, r);
    for (int i = 0; i < 6; ++i) y[i] = y[i] + r[i];
  }
  for (int i = 0; i < 6; ++i) x[i] = y[i] * s[i];
}

// M = exp(tangent) as (3x3 R, 3 t) (se3.exp, with so3's series below
// theta^2 = 1e-2).
__device__ void se3_exp(const float* v, float* R, float* t) {
  const float w[3] = {v[3], v[4], v[5]};
  const float theta_sq = (w[0] * w[0] + w[1] * w[1]) + w[2] * w[2];
  const float theta = sqrtf(theta_sq + 1e-16f);
  const bool small = theta_sq < 1e-2f;
  const float t4 = theta_sq * theta_sq;
  const float sin_t = sinf(theta), cos_t = cosf(theta);
  const float a = small ? (1.0f - theta_sq * (1.0f / 6.0f))
                          + t4 * (1.0f / 120.0f)
                        : sin_t / theta;
  const float bb = small ? (0.5f - theta_sq * (1.0f / 24.0f))
                           + t4 * (1.0f / 720.0f)
                         : (1.0f - cos_t) / theta_sq;
  const float cc = small ? (1.0f / 6.0f - theta_sq * (1.0f / 120.0f))
                           + t4 * (1.0f / 5040.0f)
                         : (theta - sin_t) / (theta_sq * theta);
  const float K[9] = {0.0f, -w[2], w[1], w[2], 0.0f, -w[0],
                      -w[1], w[0], 0.0f};
  float K2[9];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      K2[3 * i + j] = (K[3 * i] * K[j] + K[3 * i + 1] * K[3 + j])
                      + K[3 * i + 2] * K[6 + j];
    }
  }
  float V[9];
  for (int i = 0; i < 9; ++i) {
    const float eye = (i % 4 == 0) ? 1.0f : 0.0f;
    R[i] = (eye + a * K[i]) + bb * K2[i];
    V[i] = (eye + bb * K[i]) + cc * K2[i];
  }
  for (int i = 0; i < 3; ++i) {
    t[i] = (V[3 * i] * v[0] + V[3 * i + 1] * v[1]) + V[3 * i + 2] * v[2];
  }
}

__global__ void __launch_bounds__(kStepThreads)
pose_h_b_step_kernel(StepParams q) {
  __shared__ int s_open_before, s_open_after;
  if (threadIdx.x == 0) {
    s_open_before = 0;
    s_open_after = 0;
  }
  __syncthreads();
  int before = 0, after = 0;
  for (int lane = threadIdx.x; lane < q.lanes; lane += blockDim.x) {
    if (q.done[lane]) continue;
    ++before;
    float x[6];
    solve6(q.H + 36 * (size_t)lane, q.b + 6 * (size_t)lane, x);
    // A singular H (no associations) must not poison the pose.
    bool finite = true;
    for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
    float neg[6];
    for (int i = 0; i < 6; ++i) neg[i] = finite ? -x[i] : -0.0f;
    float R[9], t[3];
    se3_exp(neg, R, t);
    // T <- T * exp(-x).
    float* T = q.T + 16 * (size_t)lane;
    float row[4];
    for (int i = 0; i < 3; ++i) {
      for (int k = 0; k < 4; ++k) row[k] = T[4 * i + k];
      for (int j = 0; j < 3; ++j) {
        T[4 * i + j] = ((row[0] * R[j] + row[1] * R[3 + j])
                        + row[2] * R[6 + j]) + row[3] * 0.0f;
      }
      T[4 * i + 3] = ((row[0] * t[0] + row[1] * t[1]) + row[2] * t[2])
                     + row[3] * 1.0f;
    }
    // IsScale1PoseEstimationConverged: rotation scaled by 10.
    float sq = 0.0f;
    for (int i = 0; i < 6; ++i) {
      const float v = finite ? x[i] : 0.0f;
      const float sv = v * (i < 3 ? 1.0f : 10.0f);
      sq += sv * sv;
    }
    if (sq < 1e-6f) {
      q.done[lane] = 1;
    } else {
      ++after;
    }
  }
  atomicAdd(&s_open_before, before);
  atomicAdd(&s_open_after, after);
  __syncthreads();
  if (threadIdx.x == 0) {
    q.state[0] = s_open_after;
    q.state[1] += s_open_before;
    *q.all_done = s_open_after == 0 ? 1 : 0;
  }
}

constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  int n = g_sms[device].load(std::memory_order_relaxed);
  if (n == 0) {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (n < 1) return cudaErrorInvalidDevice;
    g_sms[device].store(n, std::memory_order_relaxed);
  }
  *sms = n;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The number of blocks (and of partial rows per lane) that
// pose_h_b_accumulate_launch uses for a surfel capacity on the current
// device; 0 on a failed device query.
int pose_h_b_blocks(int capacity) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return 0;
  const int chunks = (capacity + kChunk - 1) / kChunk;
  const int cap = kBlocksPerSm * sms;
  return chunks < 1 ? 1 : (chunks < cap ? chunks : cap);
}

// Launches on `stream` of the current device with `blocks` columns of
// blocks (from pose_h_b_blocks; `partials` holds blocks x lanes x 28
// floats) and as many lane groups as make about kTargetBlocksPerSm blocks
// per SM; returns the CUDA error of the launch, 0 for none.
int pose_h_b_accumulate_launch(
    const float* pos, const float* normal, const float* radius_sq,
    const float* desc, const unsigned char* valid, const int* count,
    int capacity, const float* T, const unsigned char* done,
    const float* depth, const float* normals, const float* intensity,
    int lanes, int height, int width, int int_height, int int_width,
    const float* depth_intr, const float* color_intr, const float* a,
    const float* cfactor, const float* baseline_fx, int cfactor_width,
    int cell_size, int color_width, int color_height, int use_depth,
    int use_desc, float* partials, unsigned int* ticket, float* H, float* b,
    int* res_count, int blocks, void* stream) {
  Params p{pos, normal, radius_sq, desc, valid, count, capacity,
           T, done, depth, normals, intensity,
           lanes, height, width, int_height, int_width,
           depth_intr, color_intr, a, cfactor, baseline_fx,
           cfactor_width, cell_size, color_width, color_height,
           use_depth, use_desc, partials, ticket, H, b, res_count};
  int sms = 0;
  cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return (int)e;
  const int per_column = (kTargetBlocksPerSm * sms + blocks - 1) / blocks;
  const int groups = per_column < lanes ? per_column : lanes;
  const dim3 grid(blocks, groups < 1 ? 1 : groups);
  pose_h_b_accumulate_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int pose_h_b_step_launch(float* T, unsigned char* done, const float* H,
                         const float* b, int* state, unsigned char* all_done,
                         int lanes, void* stream) {
  StepParams q{T, done, H, b, state, all_done, lanes};
  pose_h_b_step_kernel<<<1, kStepThreads, 0, (cudaStream_t)stream>>>(q);
  return (int)cudaGetLastError();
}

}  // extern "C"
