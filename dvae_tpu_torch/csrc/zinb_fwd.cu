// Fused three-head ZINB loss, value only: the decoder's three output
// layers (NB rate r, success probability p, zero inflation z) and the
// zero-inflated negative-binomial negative log-likelihood summed per arm,
// without materialising any (A, B, D) tensor.  Hand-written for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/zinb_pallas.py `_fwd_kernel` (:269),
// launched by `_fwd` (:315, pallas_call at :321): the value-only forward of
// `fused_zinb` that eval and validation run.  Per arm a,
//
//     y_r = h_a W_r + b_r,  y_p = h_a W_p + b_p,  y_z = h_a W_z + b_z
//     out_a = sum_{b,d} zinb_nll(y_r, y_p, y_z, x)      (zinb_math.cuh)
//
// Operands: h (A,B,F); W_r, W_p, W_z (A,F,D); b_* (A,D); x (B,D) shared by
// every arm (arm stride 0) or per-arm (A,B,D), the log1p data: the counts
// k = min(expm1(x), 1e12) are taken per element here, from x in its own
// type, so no count tensor exists (the TPU op builds one outside its
// kernel, zinb_pallas.py:588).  All f32 or all bf16; products accumulate
// in f32, biases are added in f32.  Output (A,) f32.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   three products of 2*A*B*F*D = 25.2 GFLOP -> 75.5 GFLOP, 1.13 ms in f32
//   on the FP32 cores (67 TFLOP/s); 141 MB read in f32 -> 0.042 ms.  Bound
//   by operations.  The bound leaves out the epilogue: A*B*D = 1.26e8
//   elements with about nine log/exp calls and five divisions each.
// Design: one block per (arm, 128-row tile, 64-column tile); the three
// products run as one register-blocked SIMT GEMM sharing the h operand (8x4
// outputs per head and thread, operands staged in shared memory as f32),
// the loss epilogue works on the accumulators.  Each block writes its
// partial sum; a second pass reduces the partials per arm in a fixed order
// in double, so repeated launches agree bit for bit.  Ragged edges are
// masked: a masked element is never read and adds exactly 0 (an unmasked
// padded element would add -log(z + (1-z)(1-p)^r), not 0).  No tensor
// cores yet: bf16 runs at the f32 rate.

#include <stdint.h>

#include "zinb_math.cuh"

namespace {

using zinb::to_f32;

constexpr int BM = 128;       // rows (cells) per block tile
constexpr int BN = 64;        // columns (genes) per block tile
constexpr int BK = 8;         // depth (hidden units) per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 4 outputs per head each
constexpr int APAD = 4;
constexpr int REDUCE_THREADS = 256;

template <typename T>
struct Heads {
  const T* w[3];
  const T* b[3];
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
zinb_fwd_tiles(const T* __restrict__ h, Heads<T> heads,
               const T* __restrict__ x, long long x_arm_stride, int B, int F,
               int D, float eps, float one_m_eps,
               float* __restrict__ part_sum) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // h tile, transposed
  __shared__ __align__(16) float Bs[3][BK][BN];      // the heads' W tiles

  const int a = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* ha = h + (long long)a * B * F;

  float acc[3][8][4];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[hd][i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < B && gk < F) ? to_f32(ha[(long long)gm * F + gk]) : 0.f;
    }
#pragma unroll
    for (int hd = 0; hd < 3; ++hd) {
      const T* wa = heads.w[hd] + (long long)a * F * D;
#pragma unroll
      for (int r = 0; r < (BK * BN) / THREADS; ++r) {
        const int idx = tid + r * THREADS;
        const int k = idx / BN, n = idx % BN;
        const int gk = k0 + k, gn = n0 + n;
        Bs[hd][k][n] =
            (gk < F && gn < D) ? to_f32(wa[(long long)gk * D + gn]) : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
      for (int hd = 0; hd < 3; ++hd) {
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[hd][k][tx * 4]);
        const float bv[4] = {b0.x, b0.y, b0.z, b0.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[hd][i][j] = fmaf(av[i], bv[j], acc[hd][i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue: biases, the ZINB loss against x, masked
  const T* xa = x + (long long)a * x_arm_stride;
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx * 4 + j;
    if (col >= D) continue;
    const float b_r = to_f32(heads.b[0][(long long)a * D + col]);
    const float b_p = to_f32(heads.b[1][(long long)a * D + col]);
    const float b_z = to_f32(heads.b[2][(long long)a * D + col]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + ((i < 4) ? (ty * 4 + i) : (64 + ty * 4 + (i - 4)));
      if (row >= B) continue;
      const float xv = to_f32(xa[(long long)row * D + col]);
      float loss, g0, g1, g2;
      zinb::element<true, false, false>(acc[0][i][j] + b_r, acc[1][i][j] + b_p,
                                        acc[2][i][j] + b_z, xv, eps, one_m_eps,
                                        1.f, loss, g0, g1, g2);
      s += loss;
    }
  }

  // block reduction in a fixed order: warp shuffles, then thread 0
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
    part_sum[((long long)a * gridDim.y + blockIdx.y) * gridDim.x +
             blockIdx.x] = bs;
  }
}

// Second pass: one block per arm sums that arm's partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
zinb_fwd_reduce(const float* __restrict__ part_sum, int n_per_arm,
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

template <typename T>
int launch(const void* h, const void* w_r, const void* b_r, const void* w_p,
           const void* b_p, const void* w_z, const void* b_z, const void* x,
           long long x_arm_stride, int A, int B, int F, int D, float eps,
           float one_m_eps, void* part_sum, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Heads<T> heads;
  heads.w[0] = static_cast<const T*>(w_r);
  heads.w[1] = static_cast<const T*>(w_p);
  heads.w[2] = static_cast<const T*>(w_z);
  heads.b[0] = static_cast<const T*>(b_r);
  heads.b[1] = static_cast<const T*>(b_p);
  heads.b[2] = static_cast<const T*>(b_z);
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM, A);
  zinb_fwd_tiles<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), heads, static_cast<const T*>(x), x_arm_stride,
      B, F, D, eps, one_m_eps, static_cast<float*>(part_sum));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zinb_fwd_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(part_sum), (int)(grid.x * grid.y),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials the scratch buffer holds for each arm.
long long zinb_fwd_partials_per_arm(int B, int D) {
  return (long long)((D + BN - 1) / BN) * ((B + BM - 1) / BM);
}

// Largest row count one launch takes (grid.y limit).
long long zinb_fwd_max_rows() { return 65535LL * BM; }

int zinb_fwd_f32(const void* h, const void* w_r, const void* b_r,
                 const void* w_p, const void* b_p, const void* w_z,
                 const void* b_z, const void* x, long long x_arm_stride, int A,
                 int B, int F, int D, float eps, float one_m_eps,
                 void* part_sum, void* out, void* stream) {
  return launch<float>(h, w_r, b_r, w_p, b_p, w_z, b_z, x, x_arm_stride, A, B,
                       F, D, eps, one_m_eps, part_sum, out, stream);
}

int zinb_fwd_bf16(const void* h, const void* w_r, const void* b_r,
                  const void* w_p, const void* b_p, const void* w_z,
                  const void* b_z, const void* x, long long x_arm_stride,
                  int A, int B, int F, int D, float eps, float one_m_eps,
                  void* part_sum, void* out, void* stream) {
  return launch<__nv_bfloat16>(h, w_r, b_r, w_p, b_p, w_z, b_z, x,
                               x_arm_stride, A, B, F, D, eps, one_m_eps,
                               part_sum, out, stream);
}

}  // extern "C"
