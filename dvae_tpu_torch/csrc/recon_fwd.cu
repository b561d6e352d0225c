// Fused reconstruction-loss forward: decoder output layer + ReLU + MSE +
// binarized-mismatch count, without materialising the (A, B, D)
// reconstruction.  Hand-written for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/recon_pallas.py `_fwd_kernel` (:72),
// launched by `_fwd` (:107, pallas_call at :118): the value-only forward of
// `fused_recon_mse` that eval runs.  Per arm a it computes
//
//     sumsq_a = sum_{b,d} (relu(h_a W_a + bias_a) - x)^2
//     mism_a  = #{ (r > thr) != (x > thr) }
//
// Operands: h (A,B,F), W (A,F,D), bias (A,D), x (B,D) shared by every arm
// (arm stride 0) or per-arm (A,B,D); all f32 or all bf16, f32 accumulation.
// Output (A,2) f32: sumsq, mism.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   2*A*B*F*D = 25.2 GFLOP; 121 MB read in f32, 60 MB in bf16.
//   f32 on the FP32 cores (67 TFLOP/s): ~0.38 ms, bound by operations;
//   bf16 on the tensor cores (989 TFLOP/s): ~25 us, bound by bytes.
// What the design does about it: the reconstruction lives only in
// registers, so the bytes are the operands read once (x, the big one, is
// read exactly once per arm and never written); the product runs as a
// classic register-blocked SIMT GEMM (128x128 block tile, 8x8 outputs per
// thread, operands staged in shared memory as f32) with the loss epilogue
// fused onto the accumulators.  This first version does not use the tensor
// cores, so bf16 runs at the f32 CUDA-core rate; wgmma/TMA come later.
//
// The TPU kernel carries its sums across a sequential (nb, A) grid in SMEM.
// Blocks on Hopper run in no order, so each block (arm, row tile, column
// tile) writes its partial sum and integer mismatch count to a scratch
// buffer, and a second pass reduces them per arm in a fixed order (double
// and 64-bit integer sums): repeated runs agree bit for bit.  B*D = 25.2 M
// exceeds 2^24, so counts stay integer until the final f32 store.
// Ragged edges (D % 128, B % 128, F % 8) are masked: masked rows and
// columns contribute exactly 0 and are never read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // rows (cells) per block tile
constexpr int BN = 128;       // columns (genes) per block tile
constexpr int BK = 8;         // depth (hidden units) per shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 8 x 8 outputs each
constexpr int APAD = 4;       // keeps float4 alignment, spreads banks
constexpr int REDUCE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Row (or column) of the i-th of a thread's 8 outputs: two groups of 4,
// 64 apart, so each thread's shared-memory reads are two float4s.
__device__ __forceinline__ int sub_index(int t, int i) {
  return (i < 4) ? (t * 4 + i) : (64 + t * 4 + (i - 4));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
recon_fwd_tiles(const T* __restrict__ h, const T* __restrict__ w,
                const T* __restrict__ bias, const T* __restrict__ x,
                long long x_arm_stride, int B, int F, int D, float thr,
                int with_mism, float* __restrict__ part_sum,
                int* __restrict__ part_mism) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // h tile, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // W tile

  const int a = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const T* ha = h + (long long)a * B * F;
  const T* wa = w + (long long)a * F * D;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < F; k0 += BK) {
    // h tile: BM x BK values, 4 per thread; consecutive threads read
    // consecutive k of one row (contiguous in memory)
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int m = idx / BK, k = idx % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < B && gk < F) ? to_f32(ha[(long long)gm * F + gk]) : 0.f;
    }
    // W tile: BK x BN values, 4 per thread, rows of W contiguous
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < F && gn < D) ? to_f32(wa[(long long)gk * D + gn]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: bias, ReLU, squared error and mismatch against x, masked
  const T* xa = x + (long long)a * x_arm_stride;
  const T* ba = bias + (long long)a * D;
  float s = 0.f;
  int mm = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + sub_index(tx, j);
    if (col >= D) continue;
    const float bj = to_f32(ba[col]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = m0 + sub_index(ty, i);
      if (row >= B) continue;
      const float y = acc[i][j] + bj;
      const float rec = (y < 0.f) ? 0.f : y;  // NaN propagates, like relu
      const float xv = to_f32(xa[(long long)row * D + col]);
      const float e = rec - xv;
      s = fmaf(e, e, s);
      if (with_mism) mm += ((rec > thr) != (xv > thr)) ? 1 : 0;
    }
  }

  // block reduction in a fixed order: warp shuffles, then warp 0
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    mm += __shfl_down_sync(0xffffffffu, mm, off);
  }
  __shared__ float warp_s[THREADS / 32];
  __shared__ int warp_m[THREADS / 32];
  const int lane = tid % 32, warp = tid / 32;
  if (lane == 0) {
    warp_s[warp] = s;
    warp_m[warp] = mm;
  }
  __syncthreads();
  if (tid == 0) {
    float bs = 0.f;
    int bm = 0;
    for (int i = 0; i < THREADS / 32; ++i) {
      bs += warp_s[i];
      bm += warp_m[i];
    }
    const long long p =
        ((long long)a * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part_sum[p] = bs;
    part_mism[p] = bm;
  }
}

// Second pass: one block per arm sums that arm's partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
recon_fwd_reduce(const float* __restrict__ part_sum,
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

template <typename T>
int launch(const void* h, const void* w, const void* bias, const void* x,
           long long x_arm_stride, int A, int B, int F, int D, float thr,
           int with_mism, void* part_sum, void* part_mism, void* out,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((D + BN - 1) / BN, (B + BM - 1) / BM, A);
  recon_fwd_tiles<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const T*>(x), x_arm_stride, B,
      F, D, thr, with_mism, static_cast<float*>(part_sum),
      static_cast<int*>(part_mism));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  recon_fwd_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(part_sum),
      static_cast<const int*>(part_mism), (int)(grid.x * grid.y),
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of per-block partials the scratch buffers hold for each arm.
long long recon_fwd_partials_per_arm(int B, int D) {
  return (long long)((D + BN - 1) / BN) * ((B + BM - 1) / BM);
}

// Largest row count one launch takes (grid.y limit).
long long recon_fwd_max_rows() { return 65535LL * BM; }

int recon_fwd_f32(const void* h, const void* w, const void* bias,
                  const void* x, long long x_arm_stride, int A, int B, int F,
                  int D, float thr, int with_mism, void* part_sum,
                  void* part_mism, void* out, void* stream) {
  return launch<float>(h, w, bias, x, x_arm_stride, A, B, F, D, thr,
                       with_mism, part_sum, part_mism, out, stream);
}

int recon_fwd_bf16(const void* h, const void* w, const void* bias,
                   const void* x, long long x_arm_stride, int A, int B, int F,
                   int D, float thr, int with_mism, void* part_sum,
                   void* part_mism, void* out, void* stream) {
  return launch<__nv_bfloat16>(h, w, bias, x, x_arm_stride, A, B, F, D, thr,
                               with_mism, part_sum, part_mism, out, stream);
}

}  // extern "C"
