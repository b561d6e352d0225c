// Tile routines of the fused whole-decoder kernel (decoder.cu, kernels #12
// and #13), its only includer: the shared-memory tile loaders, the 64x64
// register-blocked SIMT product, the loss epilogue, the column pass that
// finishes dW and db of the output layer, and the fixed-order reduction of
// the block partials of the sums.  The fused reconstruction-loss training
// kernel (recon_fwdbwd.cu) shared them until it moved to the tensor cores;
// since then #13's dW_11 and db_11 agree with that kernel's within f32
// rounding, no longer bit for bit, and #13's column pass can take its
// tensor-core pass 2 (`recon_cols`) when #13 is redesigned.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // rows (cells) of a tile
constexpr int BN = 64;        // columns (genes) of a tile
constexpr int FP = 128;       // hidden width held in shared memory (F <= FP)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int APAD = 4;       // keeps float4 alignment, spreads banks
constexpr int LDM = BM + APAD;
constexpr int LDN = BN + APAD;
constexpr int REDUCE_THREADS = 256;
constexpr size_t SMEM_BYTES =
    sizeof(float) * ((size_t)FP * LDM + (size_t)FP * LDN + (size_t)BM * LDN);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the operand type and back: the TPU kernel's gm16
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

// Hs[k][m] = h[a, m0 + m, k], zero outside the arrays (k < FP, m < BM).
template <typename T>
__device__ __forceinline__ void load_h_tile(const T* __restrict__ ha, int m0,
                                            int B, int F, float (*Hs)[LDM]) {
  for (int idx = threadIdx.x; idx < BM * FP; idx += THREADS) {
    const int m = idx / FP, k = idx % FP;
    const int row = m0 + m;
    Hs[k][m] = (row < B && k < F) ? to_f32(ha[(long long)row * F + k]) : 0.f;
  }
}

// Ws[k][n] = W[a, k, n0 + n], zero outside the arrays (k < FP, n < BN).
template <typename T>
__device__ __forceinline__ void load_w_tile(const T* __restrict__ wa, int n0,
                                            int F, int D, float (*Ws)[LDN]) {
  for (int idx = threadIdx.x; idx < FP * BN; idx += THREADS) {
    const int k = idx / BN, n = idx % BN;
    const int col = n0 + n;
    Ws[k][n] = (k < F && col < D) ? to_f32(wa[(long long)k * D + col]) : 0.f;
  }
}

// acc[i][j] = sum_{k<F} Hs[k][ty*4+i] * Ws[k][tx*4+j]: the pre-bias r tile.
__device__ __forceinline__ void product_hw(float (*Hs)[LDM],
                                           float (*Ws)[LDN], int F,
                                           int tx, int ty, float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k = 0; k < F; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&Hs[k][ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a4[i], b4[j], acc[i][j]);
  }
}

// Loss epilogue of one thread's 4x4 outputs: adds to the sums and returns
// gm = two_g 1[r > 0] (r - x) (f32; 0 outside the arrays); two_g is 2, or
// 2 g_a for a given cotangent.
template <typename T>
__device__ __forceinline__ void loss_epilogue(
    float acc[4][4], const T* __restrict__ ba,
    const T* __restrict__ xa, int m0, int n0, int B, int D, float thr,
    int with_mism, float two_g, int tx, int ty, float& s, int& mm,
    float gm[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    const bool col_ok = col < D;
    const float bj = col_ok ? to_f32(ba[col]) : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float g = 0.f;
      if (col_ok && row < B) {
        const float y = acc[i][j] + bj;
        const float r = (y < 0.f) ? 0.f : y;  // NaN propagates, like relu
        const float xv = to_f32(xa[(long long)row * D + col]);
        const float e = r - xv;
        s = fmaf(e, e, s);
        if (with_mism) mm += ((r > thr) != (xv > thr)) ? 1 : 0;
        g = (r > 0.f) ? two_g * e : 0.f;
      }
      gm[i][j] = g;
    }
  }
}

// Block reduction of the threads' loss sums in a fixed order (warp shuffles,
// then thread 0), stored as the block's partials at index p.
__device__ __forceinline__ void store_block_sums(float s, int mm, long long p,
                                                 float* __restrict__ part_sum,
                                                 int* __restrict__ part_mism) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    mm += __shfl_down_sync(0xffffffffu, mm, off);
  }
  __shared__ float warp_s[THREADS / 32];
  __shared__ int warp_m[THREADS / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (lane == 0) {
    warp_s[warp] = s;
    warp_m[warp] = mm;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bs = 0.f;
    int bm = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      bs += warp_s[i];
      bm += warp_m[i];
    }
    part_sum[p] = bs;
    part_mism[p] = bm;
  }
}

// Pass 2: grid (ceil(D/BN), A).  dW and db of one column tile.
template <typename T, bool SEPARATE>
__global__ void __launch_bounds__(THREADS)
recon_fwdbwd_cols(const T* __restrict__ h, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ x,
                  long long x_arm_stride, const float* __restrict__ g, int B,
                  int F, int D, float* __restrict__ dw,
                  float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  float(*Ws)[LDN] = reinterpret_cast<float(*)[LDN]>(smem);
  float(*Hs)[LDM] = reinterpret_cast<float(*)[LDM]>(smem + FP * LDN);
  float(*Gs)[LDN] = reinterpret_cast<float(*)[LDN]>(smem + FP * LDN + FP * LDM);

  const int a = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* ha = h + (long long)a * B * F;
  const T* ba = bias + (long long)a * D;
  const T* xa = x + (long long)a * x_arm_stride;
  const T* tag = nullptr;
  const float two_g = SEPARATE ? 2.f * g[a] : 2.f;

  load_w_tile(w + (long long)a * F * D, n0, F, D, Ws);

  float wacc[8][4];  // dW hidden units ty + 16*i, columns tx*4+j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wacc[i][j] = 0.f;
  float dbp[4] = {0.f, 0.f, 0.f, 0.f};
  float s_unused = 0.f;
  int mm_unused = 0;

  for (int m0 = 0; m0 < B; m0 += BM) {
    load_h_tile(ha, m0, B, F, Hs);
    __syncthreads();
    float acc[4][4], gm[4][4];
    product_hw(Hs, Ws, F, tx, ty, acc);
    loss_epilogue(acc, ba, xa, m0, n0, B, D, 0.f, 0, two_g, tx, ty, s_unused,
                  mm_unused, gm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        dbp[j] += gm[i][j];
        Gs[ty * 4 + i][tx * 4 + j] = round_as(gm[i][j], tag);
      }
    __syncthreads();
    // dW[f][n] += sum_m h[m][f] * gm[m][n]
    const int kmax = min(BM, B - m0);
    for (int k = 0; k < kmax; ++k) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gs[k][tx * 4]);
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float hv = Hs[ty + 16 * i][k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wacc[i][j] = fmaf(hv, g4[j], wacc[i][j]);
      }
    }
    __syncthreads();
  }

  float* dwa = dw + (long long)a * F * D;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = ty + 16 * i;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < D) dwa[(long long)f * D + col] = wacc[i][j];
    }
  }

  // db: the 16 row groups' column sums, added in a fixed order
  float(*red)[LDN] = Gs;  // free after the last product
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = dbp[j];
  __syncthreads();
  if (tid < BN && n0 + tid < D) {
    float t = 0.f;
    for (int r = 0; r < 16; ++r) t += red[r][tid];
    db[(long long)a * D + n0 + tid] = t;
  }
}

// One block per arm sums that arm's partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
recon_fwdbwd_reduce(const float* __restrict__ part_sum,
                    const int* __restrict__ part_mism, int n_per_arm,
                    float* __restrict__ out) {
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0;
  long long m = 0;
  for (int i = tid; i < n_per_arm; i += REDUCE_THREADS) {
    s += (double)part_sum[(long long)a * n_per_arm + i];
    m += (long long)part_mism[(long long)a * n_per_arm + i];
  }
  __shared__ double ss[REDUCE_THREADS];
  __shared__ long long sm[REDUCE_THREADS];
  ss[tid] = s;
  sm[tid] = m;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      ss[tid] += ss[tid + stride];
      sm[tid] += sm[tid + stride];
    }
    __syncthreads();
  }
  if (tid == 0) {
    out[2 * a] = (float)ss[0];
    out[2 * a + 1] = (float)sm[0];
  }
}

}  // namespace
