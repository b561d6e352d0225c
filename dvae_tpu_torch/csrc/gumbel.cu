// Fused Gumbel-softmax sample of a categorical posterior, forward and
// backward.  Hand-written for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernels of dvae_tpu/ops/gumbel_pallas.py:
//   * `_gumbel_kernel` (:52) and `_gumbel_kernel_with_u` (:67), launched by
//     `_gumbel_fwd_pallas` (:78, pallas_call :105 and :115), math in
//     `_finish` (:38):
//         [phi = softmax(phi / tau)]                       (sharpen variant)
//         g = -log(-log(u + eps) + eps)
//         y = softmax((log(phi + eps) + g) / T)
//         [one-hot of argmax y]                                  (hard)
//   * `_soft_bwd_kernel` (:128), launched by `_gs_bwd` (:171, pallas_call
//     :186):
//         s = sum_C dy*y,  dz = (dy - s)*y,  dphi = dz / T / (phi + eps)
//         dT = -sum dz * log y / T            (an element with y = 0 adds 0)
// phi, u, y, dy, dphi are (N, C) f32, N the product of the leading axes.
// Both take any C >= 1, as the TPU kernels' (512, C) blocks do.
//
// The uniforms.  Given as a tensor, or drawn in the kernel: Philox4x32-10
// keyed by (seed, KEY1) and counted by (column/4, row), word column % 4,
// whatever lane draws it; the top 23 bits of each word times 2^-23, so u
// lies in [0, 1) on a grid of 2^-23 as the TPU kernel's does (:59-63): the
// same distribution, not the TPU's bitstream.  The check entry
// `gumbel_uniform_f32` materialises them through the same device function.
//
// Bound at the production shape (N = 25,000 rows, C = 92), per call: the
// forward reads phi and writes y, 18.4 MB -> 0.0055 ms at 3.35 TB/s; its
// element math (three accurate logf, one expf, a quarter of a Philox draw)
// is about 106 SASS instructions an element and 4.75 integer multiplies,
// 0.0079 ms at the FP32 issue rate of 33.5e12 lane-instructions a second
// (the multiplies at half of it): the forward is bound by instructions
// (chip_smoke.py OPS_*, counted by scripts/gumbel_sass.py).  The backward
// reads y, phi, dy and writes dphi, 36.8 MB -> 0.011 ms, a division and a
// log an element (0.0032 ms): bound by bytes.
//
// Forward design (`gumbel_fwd_rows`): a row plan from C keeps the lanes
// busy.  A lane holds whole quads (4 neighbouring columns, one 16-byte load
// and one Philox draw); `lanes` lanes share a row (1 .. 32, a power of
// two), lane `sub` holding quads sub, sub + lanes, ... (`quads` of them, at
// most MAX_QUADS).  The plan takes the fewest padded quads a row, and of
// equals the most lanes (more rows in flight): at C = 92 8 lanes of 3 quads
// (92 of 96 columns busy, where one warp a row kept 92 of 128).  The row's
// maximum, sum and argmax take log2(lanes) shuffle steps.  One reciprocal
// of T a launch and one of the row sum replace two IEEE divisions an
// element (an ulp apart).  Accurate logf/expf, no fast math: near u -> 0
// and u -> 1 the double log is where fast intrinsics differ visibly.  A
// grid of at most BLOCKS_PER_SM blocks an SM strides over groups of rows,
// every block the same number of steps, and loads the next group's phi (and
// u) before the current group's math.  At the production shape the 782
// groups of 32 rows take one step a block: on the H100 that beat 391
// blocks of two steps (4 blocks an SM) by 5%.  The hard sample writes the
// soft one and the one-hot from the same registers.  Rows past 32 * MAX_QUADS quads
// (C > 1024, `gumbel_fwd_wide`) are walked by one warp in chunks of
// 32 * WIDE_QUADS quads: the logits go to the output on the first pass and
// are rescaled in place, so no C is too wide.  The grid does not change a
// row's arithmetic: every card gives the same bits.
// Backward design (`gumbel_bwd_rows`): one warp a row, each lane four
// neighbouring columns per group of 128, held in registers up to 512
// columns; wider rows (`gumbel_bwd_wide`) take sum dy*y in one pass over
// the groups, then dphi and dT in a second.  The temperature gradient is
// summed per block, then in a fixed order in double by a second small
// kernel: repeated launches are bit-identical, no float atomics.
// Ragged edges are masked, never padded.  Ties of the argmax go to the
// lowest index.  T is a launch argument, or read from a device scalar.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int WARPS = 8;             // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int BWD_GROUPS = 4;        // #10 in registers: 128 columns a group
constexpr int MAX_QUADS = 8;         // #9 in registers: quads a lane
constexpr int WIDE_QUADS = 4;        // #9 past that: quads a lane a chunk
constexpr int BLOCKS_PER_SM = 8;     // #9's striding grid
constexpr uint32_t KEY1 = 0x5EED0002u;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long MAX_ROWS = 0x3fffffffLL;  // row indices stay in int

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// Sum and maximum over the `lanes` lanes that share a row.
__device__ __forceinline__ float seg_sum(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float seg_max(float v, int lanes) {
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// (w >> 9) * 2^-23 exactly: 1 + k * 2^-23 is a float for k < 2^23, and
// subtracting 1 from it is exact; no integer-to-float conversion.
__device__ __forceinline__ float unit23(uint32_t w) {
  return __uint_as_float(0x3f800000u | (w >> 9)) - 1.0f;
}

// Four uniforms in [0, 1) for columns 4*col4 .. 4*col4+3 of `row`.
__device__ __forceinline__ void uniform4(uint32_t seed, uint32_t row,
                                         uint32_t col4, float out[4]) {
  const uint4 r = philox4x32_10(make_uint4(col4, row, 0u, 0u), seed, KEY1);
  out[0] = unit23(r.x);
  out[1] = unit23(r.y);
  out[2] = unit23(r.z);
  out[3] = unit23(r.w);
}

// ---------------------------------------------------------------------------
// Forward (#9)
// ---------------------------------------------------------------------------

// Quads sub, sub + lanes, .. (Q of them) of a row: columns 4*quad + k.
// Nothing is read where `ok` is false (a row past N) or past C.
template <int Q>
__device__ __forceinline__ void load_quads(const float* __restrict__ p, int C,
                                           bool vec, bool ok, int sub,
                                           int lanes, float fill,
                                           float v[Q][4]) {
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int c0 = 4 * (sub + lanes * j);
    if (ok && vec && c0 < C) {
      const float4 t = *reinterpret_cast<const float4*>(p + c0);
      v[j][0] = t.x; v[j][1] = t.y; v[j][2] = t.z; v[j][3] = t.w;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[j][k] = (ok && c0 + k < C) ? p[c0 + k] : fill;
    }
  }
}

template <int Q>
__device__ __forceinline__ void store_quads(float* __restrict__ p, int C,
                                            bool vec, bool ok, int sub,
                                            int lanes, const float v[Q][4]) {
  if (!ok) return;
#pragma unroll
  for (int j = 0; j < Q; ++j) {
    const int c0 = 4 * (sub + lanes * j);
    if (vec && c0 < C) {
      *reinterpret_cast<float4*>(p + c0) =
          make_float4(v[j][0], v[j][1], v[j][2], v[j][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (c0 + k < C) p[c0 + k] = v[j][k];
    }
  }
}

// v <- softmax(v) over the row's C columns (max-shifted, as torch.softmax
// and jax.nn.softmax compute it); columns past C end as 0.
template <int Q>
__device__ __forceinline__ void softmax_quads(float v[Q][4], int C, int sub,
                                              int lanes) {
  float m = -INFINITY;
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (4 * (sub + lanes * j) + k < C) m = fmaxf(m, v[j][k]);
  m = seg_max(m, lanes);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v[j][k] = 4 * (sub + lanes * j) + k < C ? expf(v[j][k] - m) : 0.f;
      s += v[j][k];
    }
  const float inv_s = 1.f / seg_sum(s, lanes);
#pragma unroll
  for (int j = 0; j < Q; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) v[j][k] = v[j][k] * inv_s;
}

// The logits (log(phi + eps) + g) / T of quad `quad` of `row`, in place.
template <bool PHILOX>
__device__ __forceinline__ void logits4(float v[4], const float u[4],
                                        uint32_t seed, int row, int quad,
                                        float eps, float inv_t) {
  float un[4];
  if (PHILOX) {
    uniform4(seed, (uint32_t)row, (uint32_t)quad, un);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) un[k] = u[k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float gn = -logf(-logf(un[k] + eps) + eps);
    v[k] = (logf(v[k] + eps) + gn) * inv_t;
  }
}

struct FwdArgs {
  const float* phi;
  const float* u;
  const float* temp_dev;
  float* y_soft;
  float* y_hard;
  uint32_t seed;
  float temp, eps, tau;   // tau > 0: the sharpen variant
  int N, C, lg;           // lg: log2 of the lanes a row
  long long groups;       // groups of rows the grid strides over
  int chunks;             // wide rows: chunks of 32 * WIDE_QUADS quads
  bool vec;
};

// A row group a step: rows g * rows .. of `rows` = WARPS * 32 / lanes; the
// lane's row is warp * (32 / lanes) + lane / lanes of it.
template <int Q, bool HARD, bool PHILOX>
__global__ void __launch_bounds__(THREADS) gumbel_fwd_rows(FwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int lanes = 1 << a.lg;
  const int sub = lane & (lanes - 1);
  const int rows = WARPS << (5 - a.lg);
  const int rin = ((threadIdx.x >> 5) << (5 - a.lg)) + (lane >> a.lg);
  const float inv_t = 1.f / (a.temp_dev ? *a.temp_dev : a.temp);
  const int C = a.C;
  long long g = blockIdx.x;
  int row = (int)(g * rows + rin);
  float v[Q][4], un[Q][4];
  load_quads<Q>(a.phi + (long long)row * C, C, a.vec, row < a.N, sub, lanes,
                1.f, v);
  if (!PHILOX)
    load_quads<Q>(a.u + (long long)row * C, C, a.vec, row < a.N, sub, lanes,
                  0.5f, un);
  while (true) {
    // the next group's operands are in flight during this group's math
    const long long gn = g + gridDim.x;
    const int rn = (int)(gn * rows + rin);
    float vn[Q][4], unn[Q][4];
    if (gn < a.groups) {
      load_quads<Q>(a.phi + (long long)rn * C, C, a.vec, rn < a.N, sub,
                    lanes, 1.f, vn);
      if (!PHILOX)
        load_quads<Q>(a.u + (long long)rn * C, C, a.vec, rn < a.N, sub,
                      lanes, 0.5f, unn);
    }
    if (a.tau > 0.f) {
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) v[j][k] = v[j][k] / a.tau;
      softmax_quads<Q>(v, C, sub, lanes);
    }
#pragma unroll
    for (int j = 0; j < Q; ++j)
      logits4<PHILOX>(v[j], un[j], a.seed, row, sub + lanes * j, a.eps,
                      inv_t);
    softmax_quads<Q>(v, C, sub, lanes);
    const long long base = (long long)row * C;
    const bool ok = row < a.N;
    if (a.y_soft) store_quads<Q>(a.y_soft + base, C, a.vec, ok, sub, lanes, v);
    if (HARD) {
      // argmax of the soft sample, the lowest index among equals
      float best = -INFINITY;
      int idx = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = 4 * (sub + lanes * j) + k;
          if (c < C && v[j][k] > best) { best = v[j][k]; idx = c; }
        }
      for (int o = lanes >> 1; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, o);
        const int oi = __shfl_xor_sync(FULL, idx, o);
        if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
      }
#pragma unroll
      for (int j = 0; j < Q; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[j][k] = (4 * (sub + lanes * j) + k == idx) ? 1.f : 0.f;
      store_quads<Q>(a.y_hard + base, C, a.vec, ok, sub, lanes, v);
    }
    if (gn >= a.groups) break;
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[j][k] = vn[j][k];
        if (!PHILOX) un[j][k] = unn[j][k];
      }
    g = gn;
    row = rn;
  }
}

// Rows wider than the register plan: one warp a row, chunk c holding quads
// c * 32 * WIDE_QUADS + lane + 32 * j.  Pass 1 writes the logits to the
// output (y_soft, else y_hard) and keeps their maximum; pass 2 sums their
// exps; pass 3 rewrites them as the sample, the one-hot's zeros beside it,
// and the lane owning the argmax writes its 1 last.
template <bool HARD, bool PHILOX>
__global__ void __launch_bounds__(THREADS) gumbel_fwd_wide(FwdArgs a) {
  constexpr int WQ = WIDE_QUADS;
  constexpr int CHUNK = 4 * 32 * WQ;  // columns a chunk
  const int lane = threadIdx.x & 31;
  const float inv_t = 1.f / (a.temp_dev ? *a.temp_dev : a.temp);
  const int C = a.C;
  float* const cache = a.y_soft ? a.y_soft : a.y_hard;
  for (long long g = blockIdx.x; g < a.groups; g += gridDim.x) {
    const int row = (int)(g * WARPS + (threadIdx.x >> 5));
    if (row >= a.N) continue;  // the whole warp
    const long long base = (long long)row * C;
    float mt = 0.f, inv_st = 1.f;  // the sharpen variant's softmax
    if (a.tau > 0.f) {
      float m = -INFINITY, s = 0.f;
      for (int c = 0; c < a.chunks; ++c) {
        float v[WQ][4];
        load_quads<WQ>(a.phi + base + c * CHUNK, C - c * CHUNK, a.vec, true,
                       lane, 32, 1.f, v);
#pragma unroll
        for (int j = 0; j < WQ; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c * CHUNK + 4 * (lane + 32 * j) + k < C)
              m = fmaxf(m, v[j][k] / a.tau);
      }
      m = warp_max(m);
      for (int c = 0; c < a.chunks; ++c) {
        float v[WQ][4];
        load_quads<WQ>(a.phi + base + c * CHUNK, C - c * CHUNK, a.vec, true,
                       lane, 32, 1.f, v);
#pragma unroll
        for (int j = 0; j < WQ; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k)
            if (c * CHUNK + 4 * (lane + 32 * j) + k < C)
              s += expf(v[j][k] / a.tau - m);
      }
      mt = m;
      inv_st = 1.f / warp_sum(s);
    }
    float m = -INFINITY;
    for (int c = 0; c < a.chunks; ++c) {
      const int cc = C - c * CHUNK;
      float v[WQ][4], un[WQ][4];
      load_quads<WQ>(a.phi + base + c * CHUNK, cc, a.vec, true, lane, 32,
                     1.f, v);
      if (!PHILOX)
        load_quads<WQ>(a.u + base + c * CHUNK, cc, a.vec, true, lane, 32,
                       0.5f, un);
#pragma unroll
      for (int j = 0; j < WQ; ++j) {
        if (a.tau > 0.f) {
#pragma unroll
          for (int k = 0; k < 4; ++k)
            v[j][k] = expf(v[j][k] / a.tau - mt) * inv_st;
        }
        logits4<PHILOX>(v[j], un[j], a.seed, row, c * 32 * WQ + lane + 32 * j,
                        a.eps, inv_t);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * (lane + 32 * j) + k < cc) m = fmaxf(m, v[j][k]);
      }
      store_quads<WQ>(cache + base + c * CHUNK, cc, a.vec, true, lane, 32, v);
    }
    m = warp_max(m);
    float s = 0.f;
    for (int c = 0; c < a.chunks; ++c) {
      const int cc = C - c * CHUNK;
      float v[WQ][4];
      load_quads<WQ>(cache + base + c * CHUNK, cc, a.vec, true, lane, 32,
                     0.f, v);
#pragma unroll
      for (int j = 0; j < WQ; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (4 * (lane + 32 * j) + k < cc) s += expf(v[j][k] - m);
    }
    const float inv_s = 1.f / warp_sum(s);
    float best = -INFINITY;
    int idx = 0x7fffffff;
    for (int c = 0; c < a.chunks; ++c) {
      const int cc = C - c * CHUNK;
      float v[WQ][4];
      load_quads<WQ>(cache + base + c * CHUNK, cc, a.vec, true, lane, 32,
                     0.f, v);
#pragma unroll
      for (int j = 0; j < WQ; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          v[j][k] = expf(v[j][k] - m) * inv_s;
          const int col = 4 * (lane + 32 * j) + k;
          if (HARD && col < cc && v[j][k] > best) {
            best = v[j][k];
            idx = c * CHUNK + col;
          }
        }
      if (a.y_soft)
        store_quads<WQ>(a.y_soft + base + c * CHUNK, cc, a.vec, true, lane,
                        32, v);
      if (HARD) {
#pragma unroll
        for (int j = 0; j < WQ; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) v[j][k] = 0.f;
        store_quads<WQ>(a.y_hard + base + c * CHUNK, cc, a.vec, true, lane,
                        32, v);
      }
    }
    if (HARD) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(FULL, best, o);
        const int oi = __shfl_xor_sync(FULL, idx, o);
        if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
      }
      // the lane that wrote the argmax's 0 writes its 1
      if (idx < C && ((idx >> 2) & 31) == lane) a.y_hard[base + idx] = 1.f;
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (#10)
// ---------------------------------------------------------------------------

// A lane's elements of one row: columns 4*(lane + 32*g) + j.
template <int NG>
__device__ __forceinline__ void load_row(const float* __restrict__ p, int C,
                                         bool vec, int lane, float fill,
                                         float v[NG][4]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c0 = 4 * (lane + 32 * g);
    if (vec && c0 < C) {
      const float4 t = *reinterpret_cast<const float4*>(p + c0);
      v[g][0] = t.x; v[g][1] = t.y; v[g][2] = t.z; v[g][3] = t.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[g][j] = (c0 + j < C) ? p[c0 + j] : fill;
    }
  }
}

template <int NG>
__device__ __forceinline__ void store_row(float* __restrict__ p, int C,
                                          bool vec, int lane,
                                          float v[NG][4]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c0 = 4 * (lane + 32 * g);
    if (vec && c0 < C) {
      *reinterpret_cast<float4*>(p + c0) =
          make_float4(v[g][0], v[g][1], v[g][2], v[g][3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (c0 + j < C) p[c0 + j] = v[g][j];
    }
  }
}

// dphi of one group of a row, and its terms of sum dz * log y.
template <int NG>
__device__ __forceinline__ void dphi_groups(float yv[NG][4], float gv[NG][4],
                                            const float pv[NG][4], float s,
                                            float t, float eps, float& dt) {
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float yy = yv[g][j];
      const float dz = (gv[g][j] - s) * yy;
      const float logy = yy > 0.f ? logf(fmaxf(yy, 1e-38f)) : 0.f;
      dt += dz * logy;
      gv[g][j] = dz / t / (pv[g][j] + eps);
    }
}

// The block's share of dT = -sum dz*log y / T to dtemp_part[block], where
// it is given; `dt` is the warp's sum.
__device__ __forceinline__ void block_partial(float dt, float t,
                                              float* __restrict__ dtemp_part) {
  __shared__ float part[WARPS];
  if (dtemp_part == nullptr) return;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = dt;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w];
    dtemp_part[blockIdx.x] = -sum / t;
  }
}

// One warp a row, the row in registers (C <= 128 * NG); dphi written once.
template <int NG>
__global__ void __launch_bounds__(THREADS)
gumbel_bwd_rows(const float* __restrict__ y, const float* __restrict__ phi,
                const float* __restrict__ dy, float temp,
                const float* __restrict__ temp_dev, float eps, int N, int C,
                bool vec, float* __restrict__ dphi,
                float* __restrict__ dtemp_part) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const float t = temp_dev ? *temp_dev : temp;
  float dt = 0.f;
  if (row < N) {
    const long long base = (long long)row * C;
    float yv[NG][4], gv[NG][4], pv[NG][4];
    load_row<NG>(y + base, C, vec, lane, 0.f, yv);
    load_row<NG>(dy + base, C, vec, lane, 0.f, gv);
    load_row<NG>(phi + base, C, vec, lane, 1.f, pv);
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) s += gv[g][j] * yv[g][j];
    s = warp_sum(s);
    dphi_groups<NG>(yv, gv, pv, s, t, eps, dt);
    store_row<NG>(dphi + base, C, vec, lane, gv);
    dt = warp_sum(dt);
  }
  block_partial(dt, t, dtemp_part);
}

// One warp a row past 128 * BWD_GROUPS columns, walking it a group of 128
// columns at a time: sum dy*y in one pass, dphi and dT in a second.
__global__ void __launch_bounds__(THREADS)
gumbel_bwd_wide(const float* __restrict__ y, const float* __restrict__ phi,
                const float* __restrict__ dy, float temp,
                const float* __restrict__ temp_dev, float eps, int N, int C,
                bool vec, float* __restrict__ dphi,
                float* __restrict__ dtemp_part) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const float t = temp_dev ? *temp_dev : temp;
  float dt = 0.f;
  if (row < N) {
    const long long base = (long long)row * C;
    float s = 0.f;
    for (int c0 = 0; c0 < C; c0 += 128) {
      float yv[1][4], gv[1][4];
      load_row<1>(y + base + c0, C - c0, vec, lane, 0.f, yv);
      load_row<1>(dy + base + c0, C - c0, vec, lane, 0.f, gv);
#pragma unroll
      for (int j = 0; j < 4; ++j) s += gv[0][j] * yv[0][j];
    }
    s = warp_sum(s);
    for (int c0 = 0; c0 < C; c0 += 128) {
      float yv[1][4], gv[1][4], pv[1][4];
      load_row<1>(y + base + c0, C - c0, vec, lane, 0.f, yv);
      load_row<1>(dy + base + c0, C - c0, vec, lane, 0.f, gv);
      load_row<1>(phi + base + c0, C - c0, vec, lane, 1.f, pv);
      dphi_groups<1>(yv, gv, pv, s, t, eps, dt);
      store_row<1>(dphi + base + c0, C - c0, vec, lane, gv);
    }
    dt = warp_sum(dt);
  }
  block_partial(dt, t, dtemp_part);
}

// Second pass of dT: one block sums the per-block shares in a fixed order,
// in double.
__global__ void __launch_bounds__(THREADS)
reduce_partials(const float* __restrict__ part, int n, float* __restrict__ out) {
  __shared__ double ss[THREADS];
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += THREADS) s += (double)part[i];
  ss[threadIdx.x] = s;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (threadIdx.x < o) ss[threadIdx.x] += ss[threadIdx.x + o];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)ss[0];
}

// Check entry: the uniforms the forward draws, as f32 (N, C).
__global__ void gumbel_uniform_rows(uint32_t seed, int N, int C,
                                    float* __restrict__ out) {
  const int n4 = (C + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)N * n4) return;
  const int col4 = (int)(i % n4);
  const int row = (int)(i / n4);
  float un[4];
  uniform4(seed, (uint32_t)row, (uint32_t)col4, un);
  for (int j = 0; j < 4; ++j)
    if (col4 * 4 + j < C) out[(long long)row * C + col4 * 4 + j] = un[j];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// The forward's row plan (ops/gumbel.py `gumbel_plan` is its twin).
struct Plan {
  int lanes, quads, chunks, rows;
  long long groups, grid;
};

Plan fwd_plan(long long N, int C, int sms) {
  Plan p{0, 0, 1, 0, 0, 0};
  const int q = (C - 1) / 4 + 1;  // quads a row
  for (int lanes = 1; lanes <= 32; lanes *= 2) {
    const int quads = (q - 1) / lanes + 1;
    if (quads <= MAX_QUADS &&
        (p.lanes == 0 || lanes * quads <= p.lanes * p.quads)) {
      p.lanes = lanes;
      p.quads = quads;
    }
  }
  if (p.lanes == 0) {  // too wide for registers: chunks of one warp
    p.lanes = 32;
    p.quads = WIDE_QUADS;
    p.chunks = (q - 1) / (32 * WIDE_QUADS) + 1;
  }
  p.rows = WARPS * 32 / p.lanes;
  p.groups = (N + p.rows - 1) / p.rows;
  // every block the same number of steps, at most BLOCKS_PER_SM an SM
  const long long slots = (long long)(sms > 0 ? sms : 1) * BLOCKS_PER_SM;
  const long long steps = (p.groups + slots - 1) / slots;
  p.grid = (p.groups + steps - 1) / steps;
  return p;
}

int sm_count() {
  static int cache[64];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (cache[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cache[dev] = n > 0 ? n : 132;
  }
  return cache[dev];
}

template <bool HARD, bool PHILOX>
void launch_rows(int quads, unsigned grid, cudaStream_t st, const FwdArgs& a) {
  switch (quads) {
#define GUMBEL_Q(Q)                                                         \
  case Q:                                                                   \
    gumbel_fwd_rows<Q, HARD, PHILOX><<<grid, THREADS, 0, st>>>(a);          \
    break;
    GUMBEL_Q(1) GUMBEL_Q(2) GUMBEL_Q(3) GUMBEL_Q(4)
    GUMBEL_Q(5) GUMBEL_Q(6) GUMBEL_Q(7) GUMBEL_Q(8)
#undef GUMBEL_Q
  }
}

template <bool HARD, bool PHILOX>
void launch_fwd(const Plan& p, cudaStream_t st, const FwdArgs& a) {
  const unsigned grid = (unsigned)p.grid;
  if (p.chunks > 1)
    gumbel_fwd_wide<HARD, PHILOX><<<grid, THREADS, 0, st>>>(a);
  else
    launch_rows<HARD, PHILOX>(p.quads, grid, st, a);
}

}  // namespace

extern "C" {

// The forward's plan for (N, C) on a card of `sms` SMs: out = lanes a row,
// quads a lane (a chunk), chunks a row, rows a group, groups, blocks.
int gumbel_fwd_plan(long long N, int C, int sms, long long* out) {
  if (N <= 0 || N > MAX_ROWS || C <= 0 || !out)
    return (int)cudaErrorInvalidValue;
  const Plan p = fwd_plan(N, C, sms);
  out[0] = p.lanes;
  out[1] = p.quads;
  out[2] = p.chunks;
  out[3] = p.rows;
  out[4] = p.groups;
  out[5] = p.grid;
  return 0;
}

// Blocks of the backward, which is the length of its dtemp_part scratch.
long long gumbel_bwd_partials(long long N) { return (N + WARPS - 1) / WARPS; }

int gumbel_fwd_f32(const void* phi, const void* u, unsigned seed, float temp,
                   const void* temp_dev, float eps, int use_tau, float tau,
                   int hard, long long N, int C, void* y_soft, void* y_hard,
                   void* stream) {
  if (N <= 0 || N > MAX_ROWS || C <= 0 || (hard && !y_hard) ||
      (!hard && !y_soft) || (use_tau && !(tau > 0.f)))
    return (int)cudaErrorInvalidValue;
  const Plan p = fwd_plan(N, C, sm_count());
  FwdArgs a;
  a.phi = static_cast<const float*>(phi);
  a.u = static_cast<const float*>(u);
  a.temp_dev = static_cast<const float*>(temp_dev);
  a.y_soft = static_cast<float*>(y_soft);
  a.y_hard = static_cast<float*>(y_hard);
  a.seed = seed;
  a.temp = temp;
  a.eps = eps;
  a.tau = use_tau ? tau : 0.f;
  a.N = (int)N;
  a.C = C;
  a.lg = __builtin_ctz((unsigned)p.lanes);
  a.groups = p.groups;
  a.chunks = p.chunks;
  a.vec = (C % 4 == 0) && aligned16(phi) && aligned16(u) &&
          aligned16(y_soft) && aligned16(y_hard);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hard && u)
    launch_fwd<true, false>(p, st, a);
  else if (hard)
    launch_fwd<true, true>(p, st, a);
  else if (u)
    launch_fwd<false, false>(p, st, a);
  else
    launch_fwd<false, true>(p, st, a);
  return (int)cudaGetLastError();
}

// dtemp_part (gumbel_bwd_partials(N) floats) and dtemp (1 float) are both
// given, or both null: then the temperature gradient is not computed.
int gumbel_bwd_f32(const void* y, const void* phi, const void* dy, float temp,
                   const void* temp_dev, float eps, long long N, int C,
                   void* dphi, void* dtemp_part, void* dtemp, void* stream) {
  if (N <= 0 || N > MAX_ROWS || C <= 0 ||
      ((dtemp_part == nullptr) != (dtemp == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool vec = (C % 4 == 0) && aligned16(y) && aligned16(phi) &&
                   aligned16(dy) && aligned16(dphi);
  const int blocks = (int)((N + WARPS - 1) / WARPS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* yy = static_cast<const float*>(y);
  const float* p = static_cast<const float*>(phi);
  const float* g = static_cast<const float*>(dy);
  const float* td = static_cast<const float*>(temp_dev);
  float* dp = static_cast<float*>(dphi);
  float* part = static_cast<float*>(dtemp_part);
  if (C <= 128)
    gumbel_bwd_rows<1><<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                   (int)N, C, vec, dp, part);
  else if (C <= 256)
    gumbel_bwd_rows<2><<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                   (int)N, C, vec, dp, part);
  else if (C <= 128 * BWD_GROUPS)
    gumbel_bwd_rows<BWD_GROUPS><<<blocks, THREADS, 0, st>>>(
        yy, p, g, temp, td, eps, (int)N, C, vec, dp, part);
  else
    gumbel_bwd_wide<<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                (int)N, C, vec, dp, part);
  if (int e = (int)cudaGetLastError()) return e;
  if (part) {
    reduce_partials<<<1, THREADS, 0, st>>>(part, blocks,
                                           static_cast<float*>(dtemp));
    return (int)cudaGetLastError();
  }
  return 0;
}

int gumbel_uniform_f32(unsigned seed, long long N, int C, void* out,
                       void* stream) {
  if (N <= 0 || N > MAX_ROWS || C <= 0) return (int)cudaErrorInvalidValue;
  const long long n = N * ((C + 3) / 4);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  gumbel_uniform_rows<<<(unsigned)blocks, 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      seed, (int)N, C, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
