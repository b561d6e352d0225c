// Fused three-head ZINB loss of the training step: the per-arm loss sum
// AND its gradients with respect to the decoder hidden h and the three
// output layers, without materialising any (A, B, D) tensor: not the
// pre-activations, not r/p/z, not the three cotangents.  Hand-written for
// Hopper (sm_90a), bound with ctypes.  Two entry points share the code:
//
//   zinb_fwdbwd_*  replaces dvae_tpu/ops/zinb_pallas.py `_fwdbwd_kernel`
//                  (:450), launched by `_fwdbwd_call` (:532, pallas_call at
//                  :543): loss and UNSCALED gradients (cotangent 1 on every
//                  arm's sum) in one call; the autograd backward scales them
//                  by the per-arm cotangent (:609-619);
//   zinb_bwd_*     replaces `_bwd_kernel` (:338), launched by `_bwd_call`
//                  (:409, pallas_call at :420): the gradients for a given
//                  per-arm cotangent g (A,), no loss, psi(r) - psi(k+r) from
//                  two digamma calls as that kernel has it (:374-375).
//
// Per arm a, with the element math of zinb_math.cuh giving the cotangents
// g_r, g_p, g_z of the three pre-activations (masked at the ragged edges,
// g_r gated by y_r > 0):
//
//     dh_a   = g_r W_r^T + g_p W_p^T + g_z W_z^T
//     dW_*_a = h_a^T g_*,     db_*_a = sum_rows g_*
//
// g_* is rounded to h's type for the dh and dW products and kept in f32
// for db, as the TPU kernel does (:522-528).  The counts are taken from x
// per element (k = min(expm1(x), 1e12) on x converted to f32 first).
//
// Operands: h (A,B,F); W_r, W_p, W_z (A,F,D); b_* (A,D); x (B,D) shared
// (arm stride 0) or per-arm (A,B,D); all f32 or all bf16.  Outputs, all
// f32: loss (A,), dh (A,B,F), dW (3,A,F,D) and db (3,A,D) in the head
// order r, p, z.  F <= 128.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   nine products (three each of forward, dh, dW) of 2*A*B*F*D = 25.2 GFLOP
//   -> 226 GFLOP, 3.38 ms in f32 on the FP32 cores (67 TFLOP/s); bytes
//   (operands read once, outputs written once, about 212 MB in f32)
//   -> 0.063 ms.  Bound by operations.  The bound leaves out the epilogue:
//   1.26e8 elements with nine log/exp calls and five divisions each.
//
// Design.  dh reduces over D and the three dW over B, so no single tiling
// finishes both without partials.  Weighed: (a) one pass over (row group,
// column group) blocks with dh and dW partials in a workspace: a full wave
// of 132 blocks at A = 5 needs 27 groups per arm, and every group of rows
// costs one 30 MB set of dW partials, every group of columns one 10 MB dh
// partial, i.e. 190-800 MB of scratch however the 27 are split, next to a
// limit of one (A,B,D) tensor (503 MB) for the whole step; (b) two passes
// with the forward recomputed, as csrc/recon_fwdbwd.cu does.  This file
// takes (b): no workspace beyond the block partials of the loss (a few
// hundred floats), each reduction inside one block, bit-identical repeats.
//   pass 1, blocks (arm, 64-row tile) walking every 64-column tile of D:
//     three y tiles = h W_* (K = F), the element math (loss partials, the
//     three g tiles into shared memory), dh += sum_heads g_* W_*^T in
//     registers; dh is complete when the walk ends;
//   pass 2, blocks (arm, 64-column tile) walking every 64-row tile of B:
//     the y tiles and the cotangents recomputed (no loss terms), the three
//     dW += h^T g_* in registers, db summed in f32.
// The price: twelve products instead of nine, and the element math (the
// transcendentals) twice, except the loss-only logs.  Products run as SIMT
// FMAs on operands staged in shared memory as f32; no tensor cores yet.

#include <stdint.h>

#include "zinb_math.cuh"

namespace {

using zinb::round_as;
using zinb::to_f32;

constexpr int BM = 64;        // rows (cells) of a tile
constexpr int BN = 64;        // columns (genes) of a tile
constexpr int FP = 128;       // largest hidden width (F <= FP)
constexpr int THREADS = 256;  // 16 x 16 threads
constexpr int APAD = 4;       // keeps float4 alignment, spreads banks
constexpr int LDM = BM + APAD;
constexpr int LDN = BN + APAD;
constexpr int REDUCE_THREADS = 256;

template <typename T>
struct Heads {
  const T* w[3];
  const T* b[3];
};

// Hidden width rounded up to the 16 units one thread column strides over.
__host__ __device__ inline int padded_f(int F) { return (F + 15) / 16 * 16; }

// Shared memory of pass 1, the larger: three W tiles of padded_f(F) rows
// (the dh product strides over them), the h tile of F rows, three 64x64 g
// tiles.  Pass 2 holds one h tile of padded_f(F) rows and three W tiles of
// F rows, which is no more.
inline size_t smem_bytes(int F) {
  return sizeof(float) * ((size_t)3 * padded_f(F) * LDN + (size_t)F * LDM +
                          (size_t)3 * BN * LDM);
}

// Hs[k][m] = h[a, m0 + m, k] for k < F, zero outside the array and for the
// padding rows F <= k < Fp.
template <typename T>
__device__ __forceinline__ void load_h_tile(const T* __restrict__ ha, int m0,
                                            int B, int F, int Fp,
                                            float (*Hs)[LDM]) {
  for (int idx = threadIdx.x; idx < BM * Fp; idx += THREADS) {
    const int m = idx / Fp, k = idx % Fp;
    const int row = m0 + m;
    Hs[k][m] = (row < B && k < F) ? to_f32(ha[(long long)row * F + k]) : 0.f;
  }
}

// Ws[k][n] = W[a, k, n0 + n] for k < F, zero outside and for F <= k < Fp.
template <typename T>
__device__ __forceinline__ void load_w_tile(const T* __restrict__ wa, int n0,
                                            int F, int Fp, int D,
                                            float (*Ws)[LDN]) {
  for (int idx = threadIdx.x; idx < Fp * BN; idx += THREADS) {
    const int k = idx / BN, n = idx % BN;
    const int col = n0 + n;
    Ws[k][n] = (k < F && col < D) ? to_f32(wa[(long long)k * D + col]) : 0.f;
  }
}

// acc[hd][i][j] = sum_{k<F} Hs[k][ty*4+i] * Ws[hd][k][tx*4+j]
__device__ __forceinline__ void product_hw3(float (*Hs)[LDM], float (*Ws)[LDN],
                                            int w_rows, int F, int tx, int ty,
                                            float acc[3][4][4]) {
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hd][i][j] = 0.f;
  for (int k = 0; k < F; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&Hs[k][ty * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int hd = 0; hd < 3; ++hd) {
      const float4 bv =
          *reinterpret_cast<const float4*>(&Ws[hd * w_rows + k][tx * 4]);
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[hd][i][j] = fmaf(a4[i], b4[j], acc[hd][i][j]);
    }
  }
}

// Element math of one thread's 4x4 outputs: acc (pre-bias y of the three
// heads) becomes the three cotangents in place (0 outside the arrays);
// with LOSS the loss terms are added to s.
template <typename T, bool LOSS, bool TWO_DIGAMMA>
__device__ __forceinline__ void epilogue(float acc[3][4][4],
                                         const Heads<T>& heads, int a,
                                         const T* __restrict__ xa, int m0,
                                         int n0, int B, int D, float eps,
                                         float one_m_eps, float ga, int tx,
                                         int ty, float& s) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    const bool col_ok = col < D;
    float bias[3] = {0.f, 0.f, 0.f};
    if (col_ok) {
#pragma unroll
      for (int hd = 0; hd < 3; ++hd)
        bias[hd] = to_f32(heads.b[hd][(long long)a * D + col]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float loss = 0.f, g_r = 0.f, g_p = 0.f, g_z = 0.f;
      if (col_ok && row < B) {
        const float xv = to_f32(xa[(long long)row * D + col]);
        zinb::element<LOSS, true, TWO_DIGAMMA>(
            acc[0][i][j] + bias[0], acc[1][i][j] + bias[1],
            acc[2][i][j] + bias[2], xv, eps, one_m_eps, ga, loss, g_r, g_p,
            g_z);
      }
      if (LOSS) s += loss;
      acc[0][i][j] = g_r;
      acc[1][i][j] = g_p;
      acc[2][i][j] = g_z;
    }
  }
}

// Pass 1: grid (ceil(B/BM), A).  Loss partials (LOSS) and the complete dh.
template <typename T, bool LOSS, bool TWO_DIGAMMA>
__global__ void __launch_bounds__(THREADS)
zinb_rows(const T* __restrict__ h, Heads<T> heads, const T* __restrict__ x,
          long long x_arm_stride, const float* __restrict__ g, int B, int F,
          int D, float eps, float one_m_eps, float* __restrict__ part_sum,
          float* __restrict__ dh) {
  extern __shared__ __align__(16) float smem[];
  const int Fp = padded_f(F);
  // Ws: three tiles of Fp rows (the dh product strides to Fp); Hs: F rows
  float(*Ws)[LDN] = reinterpret_cast<float(*)[LDN]>(smem);
  float(*Hs)[LDM] = reinterpret_cast<float(*)[LDM]>(smem + (size_t)3 * Fp * LDN);
  float(*Gt)[LDM] = reinterpret_cast<float(*)[LDM]>(
      smem + (size_t)3 * Fp * LDN + (size_t)F * LDM);

  const int a = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* xa = x + (long long)a * x_arm_stride;
  const T* tag = nullptr;
  const float ga = g ? g[a] : 1.f;
  const int nj = Fp / 16;

  load_h_tile(h + (long long)a * B * F, m0, B, F, F, Hs);

  float dacc[4][8];  // dh rows ty*4+i, hidden units tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.f;
  float s = 0.f;

  for (int n0 = 0; n0 < D; n0 += BN) {
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
      load_w_tile(heads.w[hd] + (long long)a * F * D, n0, F, Fp, D,
                  Ws + hd * Fp);
    __syncthreads();
    float acc[3][4][4];
    product_hw3(Hs, Ws, Fp, F, tx, ty, acc);
    epilogue<T, LOSS, TWO_DIGAMMA>(acc, heads, a, xa, m0, n0, B, D, eps,
                                   one_m_eps, ga, tx, ty, s);
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Gt[hd * BN + tx * 4 + j][ty * 4 + i] = round_as(acc[hd][i][j], tag);
    __syncthreads();
    // dh[m][f] += sum_heads sum_n g[m][n] * W[f][n]
    const int kmax = min(BN, D - n0);
#pragma unroll
    for (int hd = 0; hd < 3; ++hd) {
      for (int k = 0; k < kmax; ++k) {
        const float4 gv =
            *reinterpret_cast<const float4*>(&Gt[hd * BN + k][ty * 4]);
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (j < nj) {
            const float wv = Ws[hd * Fp + tx + 16 * j][k];
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dacc[i][j] = fmaf(g4[i], wv, dacc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

  float* dha = dh + (long long)a * B * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = tx + 16 * j;
      if (f < F) dha[(long long)row * F + f] = dacc[i][j];
    }
  }

  if (LOSS) {
    // block reduction of the loss in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    __shared__ float warp_s[THREADS / 32];
    const int lane = tid % 32, warp = tid / 32;
    if (lane == 0) warp_s[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float bs = 0.f;
      for (int i = 0; i < THREADS / 32; ++i) bs += warp_s[i];
      part_sum[(long long)a * gridDim.x + blockIdx.x] = bs;
    }
  }
}

// Pass 2: grid (ceil(D/BN), A).  The three dW and db of one column tile.
template <typename T, bool TWO_DIGAMMA>
__global__ void __launch_bounds__(THREADS)
zinb_cols(const T* __restrict__ h, Heads<T> heads, const T* __restrict__ x,
          long long x_arm_stride, const float* __restrict__ g, int A, int B,
          int F, int D, float eps, float one_m_eps, float* __restrict__ dw,
          float* __restrict__ db) {
  extern __shared__ __align__(16) float smem[];
  const int Fp = padded_f(F);
  // Hs: Fp rows (the dW product strides to Fp); Ws: three tiles of F rows
  float(*Hs)[LDM] = reinterpret_cast<float(*)[LDM]>(smem);
  float(*Ws)[LDN] = reinterpret_cast<float(*)[LDN]>(smem + (size_t)Fp * LDM);
  float(*Gs)[LDN] = reinterpret_cast<float(*)[LDN]>(
      smem + (size_t)Fp * LDM + (size_t)3 * F * LDN);

  const int a = blockIdx.y;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* ha = h + (long long)a * B * F;
  const T* xa = x + (long long)a * x_arm_stride;
  const T* tag = nullptr;
  const float ga = g ? g[a] : 1.f;
  const int ni = Fp / 16;

#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
    load_w_tile(heads.w[hd] + (long long)a * F * D, n0, F, F, D, Ws + hd * F);

  float wacc[3][8][4];  // dW hidden units ty + 16*i, columns tx*4+j
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wacc[hd][i][j] = 0.f;
  float dbp[3][4];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int j = 0; j < 4; ++j) dbp[hd][j] = 0.f;
  float s_unused = 0.f;

  for (int m0 = 0; m0 < B; m0 += BM) {
    load_h_tile(ha, m0, B, F, Fp, Hs);
    __syncthreads();
    float acc[3][4][4];
    product_hw3(Hs, Ws, F, F, tx, ty, acc);
    epilogue<T, false, TWO_DIGAMMA>(acc, heads, a, xa, m0, n0, B, D, eps,
                                    one_m_eps, ga, tx, ty, s_unused);
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          dbp[hd][j] += acc[hd][i][j];
          Gs[hd * BM + ty * 4 + i][tx * 4 + j] = round_as(acc[hd][i][j], tag);
        }
    __syncthreads();
    // dW[f][n] += sum_m h[m][f] * g[m][n]
    const int kmax = min(BM, B - m0);
    for (int k = 0; k < kmax; ++k) {
      float hv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) hv[i] = (i < ni) ? Hs[ty + 16 * i][k] : 0.f;
#pragma unroll
      for (int hd = 0; hd < 3; ++hd) {
        const float4 gv =
            *reinterpret_cast<const float4*>(&Gs[hd * BM + k][tx * 4]);
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i < ni) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              wacc[hd][i][j] = fmaf(hv[i], g4[j], wacc[hd][i][j]);
          }
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int hd = 0; hd < 3; ++hd) {
    float* dwa = dw + ((long long)hd * A + a) * F * D;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int f = ty + 16 * i;
      if (f >= F) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        if (col < D) dwa[(long long)f * D + col] = wacc[hd][i][j];
      }
    }
  }

  // db: the 16 row groups' column sums, added in a fixed order
  float(*red)[LDN] = Gs;  // free after the last product
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[hd * BM + ty][tx * 4 + j] = dbp[hd][j];
  __syncthreads();
  if (tid < 3 * BN) {
    const int hd = tid / BN, n = tid % BN;
    if (n0 + n < D) {
      float t = 0.f;
      for (int r = 0; r < 16; ++r) t += red[hd * BM + r][n];
      db[((long long)hd * A + a) * D + n0 + n] = t;
    }
  }
}

// One block per arm sums that arm's loss partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
zinb_fwdbwd_reduce(const float* __restrict__ part_sum, int n_per_arm,
                   float* __restrict__ out) {
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0;
  for (int i = tid; i < n_per_arm; i += REDUCE_THREADS)
    s += (double)part_sum[(long long)a * n_per_arm + i];
  __shared__ double ss[REDUCE_THREADS];
  ss[tid] = s;
  __syncthreads();
  for (int stride = REDUCE_THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) ss[tid] += ss[tid + stride];
    __syncthreads();
  }
  if (tid == 0) out[a] = (float)ss[0];
}

struct Args {
  const void *h, *w_r, *b_r, *w_p, *b_p, *w_z, *b_z, *x;
  long long x_arm_stride;
  int A, B, F, D;
  float eps, one_m_eps;
};

// SEPARATE: the backward for a given cotangent g (no loss, two digamma
// calls); else loss and unscaled gradients.
template <typename T, bool SEPARATE>
int launch(const Args& p, const void* g, void* part_sum, void* out, void* dh,
           void* dw, void* db, void* stream) {
  if (p.F > FP || p.F < 1 || p.A > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.F);
  cudaError_t e = cudaFuncSetAttribute(
      zinb_rows<T, !SEPARATE, SEPARATE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(zinb_cols<T, SEPARATE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Heads<T> heads;
  heads.w[0] = static_cast<const T*>(p.w_r);
  heads.w[1] = static_cast<const T*>(p.w_p);
  heads.w[2] = static_cast<const T*>(p.w_z);
  heads.b[0] = static_cast<const T*>(p.b_r);
  heads.b[1] = static_cast<const T*>(p.b_p);
  heads.b[2] = static_cast<const T*>(p.b_z);
  const T* hp = static_cast<const T*>(p.h);
  const T* xp = static_cast<const T*>(p.x);
  const float* gp = static_cast<const float*>(g);
  const dim3 g1((p.B + BM - 1) / BM, p.A);
  zinb_rows<T, !SEPARATE, SEPARATE><<<g1, THREADS, smem, st>>>(
      hp, heads, xp, p.x_arm_stride, gp, p.B, p.F, p.D, p.eps, p.one_m_eps,
      static_cast<float*>(part_sum), static_cast<float*>(dh));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((p.D + BN - 1) / BN, p.A);
  zinb_cols<T, SEPARATE><<<g2, THREADS, smem, st>>>(
      hp, heads, xp, p.x_arm_stride, gp, p.A, p.B, p.F, p.D, p.eps,
      p.one_m_eps, static_cast<float*>(dw), static_cast<float*>(db));
  err = cudaGetLastError();
  if (err != cudaSuccess || SEPARATE) return (int)err;
  zinb_fwdbwd_reduce<<<p.A, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(part_sum), (int)g1.x,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of block partials of the loss the scratch buffer holds per arm.
long long zinb_fwdbwd_partials_per_arm(int B) {
  return (long long)((B + BM - 1) / BM);
}

// Largest hidden width F the kernels take.
int zinb_fwdbwd_max_f() { return FP; }

#define ZINB_ARGS                                                           \
  const void *h, const void *w_r, const void *b_r, const void *w_p,         \
      const void *b_p, const void *w_z, const void *b_z, const void *x,     \
      long long x_arm_stride, int A, int B, int F, int D, float eps,        \
      float one_m_eps
#define ZINB_PACK                                                           \
  Args { h, w_r, b_r, w_p, b_p, w_z, b_z, x, x_arm_stride, A, B, F, D, eps, \
         one_m_eps }

int zinb_fwdbwd_f32(ZINB_ARGS, void* part_sum, void* out, void* dh, void* dw,
                    void* db, void* stream) {
  return launch<float, false>(ZINB_PACK, nullptr, part_sum, out, dh, dw, db,
                              stream);
}

int zinb_fwdbwd_bf16(ZINB_ARGS, void* part_sum, void* out, void* dh, void* dw,
                     void* db, void* stream) {
  return launch<__nv_bfloat16, false>(ZINB_PACK, nullptr, part_sum, out, dh,
                                      dw, db, stream);
}

int zinb_bwd_f32(const void* g, ZINB_ARGS, void* dh, void* dw, void* db,
                 void* stream) {
  return launch<float, true>(ZINB_PACK, g, nullptr, nullptr, dh, dw, db,
                             stream);
}

int zinb_bwd_bf16(const void* g, ZINB_ARGS, void* dh, void* dw, void* db,
                  void* stream) {
  return launch<__nv_bfloat16, true>(ZINB_PACK, g, nullptr, nullptr, dh, dw,
                                     db, stream);
}

}  // extern "C"
