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
//
// The uniforms.  Given as a tensor, or drawn in the kernel: Philox4x32-10
// keyed by (seed, KEY1) and counted by (column/4, row), the top 23 bits of
// each word times 2^-23, so u lies in [0, 1) on a grid of 2^-23 as the TPU
// kernel's does (:59-63): the same distribution, not the TPU's bitstream.
// The check entry `gumbel_uniform_f32` materialises them through the same
// device function.
//
// Bound at the production shape (N = 25,000 rows, C = 92), per call: the
// forward reads phi and writes y, 18.4 MB -> 0.0055 ms at 3.35 TB/s (one
// more write with the one-hot beside the soft sample); the backward reads
// y, phi, dy and writes dphi, 36.8 MB -> 0.011 ms.  Four logs and one exp an
// element are far below the memory time: both kernels are bound by bytes,
// and at this size by launch and memory latency.
// What the design does about it: one warp owns one row, each lane four
// neighbouring columns per group of 128 (a 16-byte load where C is a
// multiple of 4), the row's maximum and sums by warp shuffles, so a row
// is read once and written once and nothing but the operands touches
// memory.  T is a launch argument, or read from a device scalar, never a
// compile-time constant.  Accurate logf/expf and IEEE division, no fast
// math: near u -> 0 and u -> 1 the double log is where fast intrinsics
// differ visibly.  The ragged edge (C not a multiple of 128, the last
// block's rows) is masked, never padded.  The temperature gradient is
// summed per block, then in a fixed order in double by a second small
// kernel: repeated launches are bit-identical, no float atomics.
// Ties of the argmax go to the lowest index.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int WARPS = 8;             // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUPS = 4;        // 128 columns each: C <= 512
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

// Four uniforms in [0, 1) for columns 4*col4 .. 4*col4+3 of `row`.
__device__ __forceinline__ void uniform4(uint32_t seed, uint32_t row,
                                         uint32_t col4, float out[4]) {
  const uint4 r = philox4x32_10(make_uint4(col4, row, 0u, 0u), seed, KEY1);
  const float scale = 1.0f / 8388608.0f;  // 2^-23
  out[0] = (float)(r.x >> 9) * scale;
  out[1] = (float)(r.y >> 9) * scale;
  out[2] = (float)(r.z >> 9) * scale;
  out[3] = (float)(r.w >> 9) * scale;
}

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

// v <- softmax(v) over the row's C valid columns (max-shifted, as
// torch.softmax and jax.nn.softmax compute it); masked columns end as 0.
template <int NG>
__device__ __forceinline__ void softmax_row(float v[NG][4], int C, int lane) {
  float m = -INFINITY;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * (lane + 32 * g) + j < C) m = fmaxf(m, v[g][j]);
  m = warp_max(m);
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = 4 * (lane + 32 * g) + j < C;
      v[g][j] = ok ? expf(v[g][j] - m) : 0.f;
      s += v[g][j];
    }
  s = warp_sum(s);
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) v[g][j] = v[g][j] / s;
}

// Forward: one warp per row.  `u` given (PHILOX false) or drawn from
// `seed`.  Writes the soft sample where y_soft is given and, under HARD,
// the one-hot of its argmax to y_hard.
template <int NG, bool TAU, bool HARD, bool PHILOX>
__global__ void __launch_bounds__(THREADS)
gumbel_fwd_rows(const float* __restrict__ phi, const float* __restrict__ u,
                uint32_t seed, float temp, const float* __restrict__ temp_dev,
                float eps, float tau, int N, int C, bool vec,
                float* __restrict__ y_soft, float* __restrict__ y_hard) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;
  const float t = temp_dev ? *temp_dev : temp;
  const long long base = (long long)row * C;

  float v[NG][4];
  load_row<NG>(phi + base, C, vec, lane, 1.f, v);
  if (TAU) {
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[g][j] = v[g][j] / tau;
    softmax_row<NG>(v, C, lane);
  }
  float un[NG][4];
  if (PHILOX) {
#pragma unroll
    for (int g = 0; g < NG; ++g)
      uniform4(seed, (uint32_t)row, (uint32_t)(lane + 32 * g), un[g]);
  } else {
    load_row<NG>(u + base, C, vec, lane, 0.5f, un);
  }
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float gn = -logf(-logf(un[g][j] + eps) + eps);
      v[g][j] = (logf(v[g][j] + eps) + gn) / t;
    }
  softmax_row<NG>(v, C, lane);
  if (y_soft) store_row<NG>(y_soft + base, C, vec, lane, v);
  if (HARD) {
    // argmax of the soft sample, the lowest index among equals
    float best = -INFINITY;
    int idx = 0x7fffffff;
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * (lane + 32 * g) + j;
        if (c < C && v[g][j] > best) { best = v[g][j]; idx = c; }
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(FULL, best, o);
      const int oi = __shfl_xor_sync(FULL, idx, o);
      if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[g][j] = (4 * (lane + 32 * g) + j == idx) ? 1.f : 0.f;
    store_row<NG>(y_hard + base, C, vec, lane, v);
  }
}

// Backward: one warp per row; dphi written once; where dtemp_part is given
// the block's share of dT = -sum dz*log y / T goes to dtemp_part[block].
template <int NG>
__global__ void __launch_bounds__(THREADS)
gumbel_bwd_rows(const float* __restrict__ y, const float* __restrict__ phi,
                const float* __restrict__ dy, float temp,
                const float* __restrict__ temp_dev, float eps, int N, int C,
                bool vec, float* __restrict__ dphi,
                float* __restrict__ dtemp_part) {
  __shared__ float part[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row = blockIdx.x * WARPS + warp;
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
    store_row<NG>(dphi + base, C, vec, lane, gv);
    dt = warp_sum(dt);
  }
  if (dtemp_part == nullptr) return;
  if (lane == 0) part[warp] = dt;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += part[w];
    dtemp_part[blockIdx.x] = -sum / t;
  }
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

int groups_for(int C) {  // 128-column groups a lane walks: 1, 2 or 4
  if (C <= 128) return 1;
  if (C <= 256) return 2;
  return 4;
}

template <int NG, bool TAU, bool HARD>
void launch_fwd_u(dim3 grid, cudaStream_t st, const float* phi, const float* u,
                  uint32_t seed, float temp, const float* temp_dev, float eps,
                  float tau, int N, int C, bool vec, float* y_soft,
                  float* y_hard) {
  if (u)
    gumbel_fwd_rows<NG, TAU, HARD, false><<<grid, THREADS, 0, st>>>(
        phi, u, seed, temp, temp_dev, eps, tau, N, C, vec, y_soft, y_hard);
  else
    gumbel_fwd_rows<NG, TAU, HARD, true><<<grid, THREADS, 0, st>>>(
        phi, u, seed, temp, temp_dev, eps, tau, N, C, vec, y_soft, y_hard);
}

template <int NG>
void launch_fwd(bool use_tau, bool hard, dim3 grid, cudaStream_t st,
                const float* phi, const float* u, uint32_t seed, float temp,
                const float* temp_dev, float eps, float tau, int N, int C,
                bool vec, float* y_soft, float* y_hard) {
  if (use_tau && hard)
    launch_fwd_u<NG, true, true>(grid, st, phi, u, seed, temp, temp_dev, eps,
                                 tau, N, C, vec, y_soft, y_hard);
  else if (use_tau)
    launch_fwd_u<NG, true, false>(grid, st, phi, u, seed, temp, temp_dev, eps,
                                  tau, N, C, vec, y_soft, y_hard);
  else if (hard)
    launch_fwd_u<NG, false, true>(grid, st, phi, u, seed, temp, temp_dev, eps,
                                  tau, N, C, vec, y_soft, y_hard);
  else
    launch_fwd_u<NG, false, false>(grid, st, phi, u, seed, temp, temp_dev,
                                   eps, tau, N, C, vec, y_soft, y_hard);
}

}  // namespace

extern "C" {

int gumbel_max_c() { return 128 * MAX_GROUPS; }

// Blocks of the backward, which is the length of its dtemp_part scratch.
long long gumbel_bwd_partials(long long N) { return (N + WARPS - 1) / WARPS; }

int gumbel_fwd_f32(const void* phi, const void* u, unsigned seed, float temp,
                   const void* temp_dev, float eps, int use_tau, float tau,
                   int hard, long long N, int C, void* y_soft, void* y_hard,
                   void* stream) {
  if (N <= 0 || N > MAX_ROWS || C <= 0 || C > 128 * MAX_GROUPS ||
      (hard && !y_hard) || (!hard && !y_soft))
    return (int)cudaErrorInvalidValue;
  const bool vec = (C % 4 == 0) && aligned16(phi) && aligned16(u) &&
                   aligned16(y_soft) && aligned16(y_hard);
  const dim3 grid((unsigned)((N + WARPS - 1) / WARPS));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(phi);
  const float* uu = static_cast<const float*>(u);
  const float* td = static_cast<const float*>(temp_dev);
  float* ys = static_cast<float*>(y_soft);
  float* yh = static_cast<float*>(y_hard);
  switch (groups_for(C)) {
    case 1:
      launch_fwd<1>(use_tau, hard, grid, st, p, uu, seed, temp, td, eps, tau,
                    (int)N, C, vec, ys, yh);
      break;
    case 2:
      launch_fwd<2>(use_tau, hard, grid, st, p, uu, seed, temp, td, eps, tau,
                    (int)N, C, vec, ys, yh);
      break;
    default:
      launch_fwd<4>(use_tau, hard, grid, st, p, uu, seed, temp, td, eps, tau,
                    (int)N, C, vec, ys, yh);
  }
  return (int)cudaGetLastError();
}

// dtemp_part (gumbel_bwd_partials(N) floats) and dtemp (1 float) are both
// given, or both null: then the temperature gradient is not computed.
int gumbel_bwd_f32(const void* y, const void* phi, const void* dy, float temp,
                   const void* temp_dev, float eps, long long N, int C,
                   void* dphi, void* dtemp_part, void* dtemp, void* stream) {
  if (N <= 0 || N > MAX_ROWS || C <= 0 || C > 128 * MAX_GROUPS ||
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
  switch (groups_for(C)) {
    case 1:
      gumbel_bwd_rows<1><<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                     (int)N, C, vec, dp, part);
      break;
    case 2:
      gumbel_bwd_rows<2><<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                     (int)N, C, vec, dp, part);
      break;
    default:
      gumbel_bwd_rows<4><<<blocks, THREADS, 0, st>>>(yy, p, g, temp, td, eps,
                                                     (int)N, C, vec, dp, part);
  }
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
