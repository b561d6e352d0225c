// Fused input dropout + encoder input layer fc1, forward and weight
// gradient, without materialising the dropped (A, B, D) input.
// Hand-written for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernels of dvae_tpu/ops/encoder_pallas.py:
//   * `_fwd_kernel` (:81, launched by `_fwd` :93, pallas_call :121):
//         y1_a = (x (.) mask_a / keep) W1_a + b1_a           (A, B, F)
//   * `_bwd_kernel` (:137, launched by `_bwd_call` :173, pallas_call :203):
//         dW1_a = (x (.) mask_a / keep)^T g_a,  db1_a = sum_rows g_a
// x is (B, D) shared by every arm (arm stride 0) or per-arm (A, B, D);
// W1 (A, D, F), b1 (A, F), g (A, B, F); all f32 or all bf16, f32
// accumulation.  y1 leaves in x's dtype, dW1/db1 in f32.
//
// The keep-mask.  The TPU kernel draws it on the chip from a seed per
// (arm, row tile) (`seed + a*nb + i_b`, :70), so forward and backward agree
// only because they share one tiling.  Here it is a counter-based
// Philox4x32-10 keyed by the seed and counted by (column/4, row, arm): one
// call gives the keep bits of four neighbouring columns, and any tiling
// that reads x in aligned groups of four columns redraws the same mask.
// The keep test is the TPU kernel's integer compare of 31 raw bits against
// keep * 2^31 (:72-73); rate 0 is an exact identity (:66-68); an explicit
// uint8 mask (A, B, D) takes precedence, even at rate 0 (:64).  The check
// entry `encoder_mask_u8` materialises the in-kernel mask through the same
// device function.
//
// Bound at the production shape (A=5, B=5000, D=5032, F=100), per call:
//   forward  2*A*B*D*F = 25.2 GFLOP -> 0.376 ms in f32 on the FP32 cores
//            (67 TFLOP/s); bytes: x read once (101 MB f32) -> 0.030 ms.
//   backward the same product count and bytes -> 0.376 ms in f32.
// What the design does about it: the dropped input lives only in shared
// memory, so the bytes are the operands read once per arm; the product is
// a register-blocked SIMT GEMM (64x128 block tile, 4x8 outputs per thread,
// operands staged in shared memory as f32).  No tensor cores yet: bf16
// runs at the f32 CUDA-core rate.  The Philox draw adds about 40 integer
// instructions per element, of the order of the 2*F = 200 flops each x
// element feeds, so the mask is not free; a later version can share one
// draw between the arms' column tiles, as this one does for F <= 128.
//
// Forward blocks own (arm, 64-row tile, 128-column tile of F) and walk D.
// Backward blocks own (arm, 64-gene tile of D, 128-column tile of F) and
// walk every row of the batch, so dW1 needs no reduction across blocks
// (the TPU kernel keeps the whole (A, D, F) accumulator in VMEM, :199-202)
// and repeated launches are bit-identical.  db1 is summed by the blocks of
// the first gene tile, in row order.  Ragged B (the 2,000-row tail) and
// ragged D are masked: rows and columns outside the arrays are never read
// and add exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "philox.cuh"  // philox4x32_10

namespace {

constexpr int BM = 64;        // rows of the output tile
constexpr int BN = 128;       // columns of the output tile (F)
constexpr int BK = 16;        // depth of one shared-memory stage
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 8 outputs each
constexpr int APAD = 4;       // keeps float4 alignment, spreads banks

constexpr int MODE_IDENTITY = 0;  // rate 0 and no mask: x as it is
constexpr int MODE_MASK = 1;      // explicit uint8 mask
constexpr int MODE_PHILOX = 2;    // mask drawn in the kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

constexpr uint32_t KEY1 = 0x5EED0001u;

// Keep bits of columns 4*col4 .. 4*col4+3 of (arm, row): bit j set = keep.
__device__ __forceinline__ unsigned keep4(uint32_t seed, int arm, int row,
                                          int col4, uint32_t thr) {
  const uint4 r = philox4x32_10(
      make_uint4((uint32_t)col4, (uint32_t)row, (uint32_t)arm, 0u), seed,
      KEY1);
  return ((r.x & 0x7fffffffu) < thr ? 1u : 0u) |
         ((r.y & 0x7fffffffu) < thr ? 2u : 0u) |
         ((r.z & 0x7fffffffu) < thr ? 4u : 0u) |
         ((r.w & 0x7fffffffu) < thr ? 8u : 0u);
}

// Four dropped x values of (arm, row) at columns col .. col+3 (col a
// multiple of 4), as f32; out-of-range columns and rows give 0.  The
// scaling rounds to T, as the TPU kernel's x * (1/keep) in x.dtype does.
template <typename T>
__device__ __forceinline__ void dropped4(
    const T* __restrict__ x, long long x_arm_stride,
    const uint8_t* __restrict__ mask, int mode, uint32_t seed, uint32_t thr,
    float scale, int a, int row, int col, int B, int D, float out[4]) {
  if (row >= B) {
#pragma unroll
    for (int j = 0; j < 4; ++j) out[j] = 0.f;
    return;
  }
  const long long base = (long long)a * x_arm_stride + (long long)row * D;
  unsigned keep = 0xFu;
  if (mode == MODE_PHILOX) keep = keep4(seed, a, row, col >> 2, thr);
  const float sc = to_f32(from_f32<T>(scale));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = col + j;
    float v = 0.f;
    if (c < D) {
      const float xv = to_f32(x[base + c]);
      if (mode == MODE_IDENTITY) {
        v = xv;
      } else {
        const bool k = (mode == MODE_PHILOX)
                           ? ((keep >> j) & 1u)
                           : (mask[((long long)a * B + row) * D + c] != 0);
        v = k ? to_f32(from_f32<T>(xv * sc)) : 0.f;
      }
    }
    out[j] = v;
  }
}

// Column of the j-th of a thread's 8 outputs: two groups of 4, 64 apart.
__device__ __forceinline__ int col_index(int tx, int j) {
  return (j < 4) ? (tx * 4 + j) : (64 + tx * 4 + (j - 4));
}

// acc[i][j] += sum_k As[k][ty*4+i] * Bs[k][col_index(tx, j)]
__device__ __forceinline__ void mma_tile(float (*As)[BM + APAD],
                                         float (*Bs)[BN], int tx,
                                         int ty, float acc[4][8]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
    const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
    const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
    const float a4[4] = {av.x, av.y, av.z, av.w};
    const float b8[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a4[i], b8[j], acc[i][j]);
  }
}

// Forward: grid (ceil(F/BN), ceil(B/BM), A).
template <typename T>
__global__ void __launch_bounds__(THREADS)
encoder_fwd_tiles(const T* __restrict__ x, long long x_arm_stride,
                  const T* __restrict__ w, const T* __restrict__ bias,
                  const uint8_t* __restrict__ mask, int mode, uint32_t seed,
                  uint32_t thr, float scale, int B, int D, int F,
                  T* __restrict__ y) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // dropped x, transposed
  __shared__ __align__(16) float Bs[BK][BN];         // W1 tile

  const int a = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* wa = w + (long long)a * D * F;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // x staging: thread owns row tid/4 and four neighbouring columns
  const int xm = tid / 4, xk = (tid % 4) * 4;
  for (int k0 = 0; k0 < D; k0 += BK) {
    float v[4];
    dropped4<T>(x, x_arm_stride, mask, mode, seed, thr, scale, a, m0 + xm,
                k0 + xk, B, D, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) As[xk + j][xm] = v[j];
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gk = k0 + k, gn = n0 + n;
      Bs[k][n] = (gk < D && gn < F) ? to_f32(wa[(long long)gk * F + gn]) : 0.f;
    }
    __syncthreads();
    mma_tile(As, Bs, tx, ty, acc);
    __syncthreads();
  }

  const T* ba = bias + (long long)a * F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + col_index(tx, j);
    if (col >= F) continue;
    const float bj = to_f32(ba[col]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (row < B)
        y[((long long)a * B + row) * F + col] = from_f32<T>(acc[i][j] + bj);
    }
  }
}

// Backward: grid (ceil(F/BN), ceil(D/BM), A); the block walks every row.
template <typename T>
__global__ void __launch_bounds__(THREADS)
encoder_bwd_tiles(const T* __restrict__ x, long long x_arm_stride,
                  const T* __restrict__ g, const uint8_t* __restrict__ mask,
                  int mode, uint32_t seed, uint32_t thr, float scale, int B,
                  int D, int F, float* __restrict__ dw,
                  float* __restrict__ db) {
  __shared__ __align__(16) float As[BK][BM + APAD];  // dropped x, [row][gene]
  __shared__ __align__(16) float Bs[BK][BN];         // g tile, [row][f]

  const int a = blockIdx.z;
  const int d0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* ga = g + (long long)a * B * F;
  const bool sums_db = blockIdx.y == 0;

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float dbs = 0.f;  // column n0 + tid of db1, threads tid < BN

  // x staging: thread owns row tid/16 and four neighbouring genes
  const int xr = tid / 16, xc = (tid % 16) * 4;
  for (int b0 = 0; b0 < B; b0 += BK) {
    float v[4];
    dropped4<T>(x, x_arm_stride, mask, mode, seed, thr, scale, a, b0 + xr,
                d0 + xc, B, D, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) As[xr][xc + j] = v[j];
#pragma unroll
    for (int r = 0; r < (BK * BN) / THREADS; ++r) {
      const int idx = tid + r * THREADS;
      const int k = idx / BN, n = idx % BN;
      const int gb = b0 + k, gn = n0 + n;
      Bs[k][n] = (gb < B && gn < F) ? to_f32(ga[(long long)gb * F + gn]) : 0.f;
    }
    __syncthreads();
    mma_tile(As, Bs, tx, ty, acc);
    if (sums_db && tid < BN) {
#pragma unroll
      for (int k = 0; k < BK; ++k) dbs += Bs[k][tid];
    }
    __syncthreads();
  }

  float* dwa = dw + (long long)a * D * F;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + col_index(tx, j);
    if (col >= F) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gene = d0 + ty * 4 + i;
      if (gene < D) dwa[(long long)gene * F + col] = acc[i][j];
    }
  }
  if (sums_db && tid < BN && n0 + tid < F) db[(long long)a * F + n0 + tid] = dbs;
}

// Check entry: the keep-mask the kernels draw, as uint8 (A, B, D).
__global__ void encoder_mask_tiles(uint32_t seed, uint32_t thr, int A, int B,
                                   int D, uint8_t* __restrict__ out) {
  const int n4 = (D + 3) / 4;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)A * B * n4) return;
  const int col4 = (int)(i % n4);
  const int row = (int)((i / n4) % B);
  const int a = (int)(i / ((long long)n4 * B));
  const unsigned keep = keep4(seed, a, row, col4, thr);
  for (int j = 0; j < 4; ++j) {
    const int c = col4 * 4 + j;
    if (c < D) out[((long long)a * B + row) * D + c] = (keep >> j) & 1u;
  }
}

int check_grid(int A, int rows, int F) {
  if (A > 65535 || (rows + BM - 1) / BM > 65535 || (F + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidConfiguration;
  return 0;
}

template <typename T>
int launch_fwd(const void* x, long long x_arm_stride, const void* w,
               const void* bias, const void* mask, int mode, unsigned seed,
               unsigned thr, float scale, int A, int B, int D, int F, void* y,
               void* stream) {
  if (int e = check_grid(A, B, F)) return e;
  const dim3 grid((F + BN - 1) / BN, (B + BM - 1) / BM, A);
  encoder_fwd_tiles<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), x_arm_stride, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const uint8_t*>(mask), mode,
      seed, thr, scale, B, D, F, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, long long x_arm_stride, const void* g,
               const void* mask, int mode, unsigned seed, unsigned thr,
               float scale, int A, int B, int D, int F, void* dw, void* db,
               void* stream) {
  if (int e = check_grid(A, D, F)) return e;
  const dim3 grid((F + BN - 1) / BN, (D + BM - 1) / BM, A);
  encoder_bwd_tiles<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), x_arm_stride, static_cast<const T*>(g),
      static_cast<const uint8_t*>(mask), mode, seed, thr, scale, B, D, F,
      static_cast<float*>(dw), static_cast<float*>(db));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int encoder_fwd_f32(const void* x, long long x_arm_stride, const void* w,
                    const void* bias, const void* mask, int mode,
                    unsigned seed, unsigned thr, float scale, int A, int B,
                    int D, int F, void* y, void* stream) {
  return launch_fwd<float>(x, x_arm_stride, w, bias, mask, mode, seed, thr,
                           scale, A, B, D, F, y, stream);
}

int encoder_fwd_bf16(const void* x, long long x_arm_stride, const void* w,
                     const void* bias, const void* mask, int mode,
                     unsigned seed, unsigned thr, float scale, int A, int B,
                     int D, int F, void* y, void* stream) {
  return launch_fwd<__nv_bfloat16>(x, x_arm_stride, w, bias, mask, mode, seed,
                                   thr, scale, A, B, D, F, y, stream);
}

int encoder_bwd_f32(const void* x, long long x_arm_stride, const void* g,
                    const void* mask, int mode, unsigned seed, unsigned thr,
                    float scale, int A, int B, int D, int F, void* dw,
                    void* db, void* stream) {
  return launch_bwd<float>(x, x_arm_stride, g, mask, mode, seed, thr, scale,
                           A, B, D, F, dw, db, stream);
}

int encoder_bwd_bf16(const void* x, long long x_arm_stride, const void* g,
                     const void* mask, int mode, unsigned seed, unsigned thr,
                     float scale, int A, int B, int D, int F, void* dw,
                     void* db, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, x_arm_stride, g, mask, mode, seed, thr,
                                   scale, A, B, D, F, dw, db, stream);
}

int encoder_mask_u8(unsigned seed, unsigned thr, int A, int B, int D,
                    void* out, void* stream) {
  const long long n = (long long)A * B * ((D + 3) / 4);
  const long long blocks = (n + 255) / 256;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  encoder_mask_tiles<<<(unsigned)blocks, 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      seed, thr, A, B, D, static_cast<uint8_t*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
