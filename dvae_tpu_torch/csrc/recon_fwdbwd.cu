// Fused reconstruction-loss forward AND backward of the training step:
// decoder output layer + ReLU + MSE + binarized-mismatch count, with the
// unscaled gradients of the loss sum, without materialising the (A, B, D)
// reconstruction or its cotangent.  Hand-written for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/recon_pallas.py `_fwdbwd_kernel`
// (:239), launched by `_fwdbwd_call` (:299, pallas_call at :310).  Per arm
// a, with r = relu(h_a W_a + bias_a) and the row/column mask of the edge
// tiles (:288-296),
//
//     sumsq_a = sum (r - x)^2,   mism_a = #{ (r > thr) != (x > thr) }
//     gm      = 2 * 1[r > 0] * (r - x)                       (never stored)
//     dh_a    = gm W_a^T,  dW_a = h_a^T gm,  db_a = sum_rows gm
//
// gm is rounded to h's dtype for the two products and kept in f32 for db
// and the sums, as the TPU kernel does (:270, :281).  The gradients are
// those of the loss sum with cotangent 1; the autograd backward scales
// them by the per-arm cotangent (recon_pallas.py:366-383).
//
// The same two passes also serve as the separate backward for a given
// per-arm cotangent g (A,), replacing `_bwd_kernel` (:143), launched by
// `_bwd_call` (:190, pallas_call at :202): gm = 2 g_a 1[r > 0] (r - x), no
// sums (entry points recon_bwd_*).  Its bound is that of the fused call:
// the forward product is recomputed in the kernel by definition.
//
// Operands: h (A,B,F), W (A,F,D), bias (A,D), x (B,D) shared (arm stride 0)
// or per-arm (A,B,D); all f32 or all bf16.  Outputs, all f32: (A,2) sums,
// dh (A,B,F), dW (A,F,D), db (A,D).  F <= 128.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   three products of 2*A*B*F*D = 25.2 GFLOP each, 75.5 GFLOP -> 1.127 ms
//   in f32 on the FP32 cores (67 TFLOP/s); bytes (operands read once,
//   outputs written once, 142 MB f32) -> 0.042 ms.  Bound by operations.
// Design.  dh reduces over D and dW over B, so no single tiling finishes
// both without an (A,B,D)-sized scratch (about 400 MB of partials here).
// Two passes instead, each deterministic:
//   pass 1, blocks (arm, 64-row tile) walking every 64-column tile of D:
//     r tile = h W (K = F), loss epilogue into block partials, gm tile
//     into shared memory, dh += gm W^T (K = the tile's columns) in
//     registers; dh is complete when the walk ends;
//   pass 2, blocks (arm, 64-column tile) walking every 64-row tile of B:
//     r tile recomputed, gm into shared memory, dW += h^T gm (K = the
//     tile's rows) in registers, db summed in f32.
// The recompute costs a fourth product (1.50 ms at the f32 FP32-core
// rate), the price of keeping both reductions inside one block each.  The
// block partials of the sums are reduced per arm in a fixed order (double
// and 64-bit integer), so repeated launches agree bit for bit.  Products
// run as SIMT FMAs on operands staged in shared memory as f32 (4x4 and
// 4x8 / 8x4 outputs per thread); no tensor cores yet.

#include "recon_tiles.cuh"

namespace {

// Pass 1: grid (ceil(B/BM), A).  Sums partials (unless SEPARATE: the
// backward for a given cotangent g) and the complete dh.
template <typename T, bool SEPARATE>
__global__ void __launch_bounds__(THREADS)
recon_fwdbwd_rows(const T* __restrict__ h, const T* __restrict__ w,
                  const T* __restrict__ bias, const T* __restrict__ x,
                  long long x_arm_stride, const float* __restrict__ g, int B,
                  int F, int D, float thr, int with_mism,
                  float* __restrict__ part_sum, int* __restrict__ part_mism,
                  float* __restrict__ dh) {
  extern __shared__ __align__(16) float smem[];
  float(*Hs)[LDM] = reinterpret_cast<float(*)[LDM]>(smem);
  float(*Ws)[LDN] = reinterpret_cast<float(*)[LDN]>(smem + FP * LDM);
  float(*Gt)[LDM] = reinterpret_cast<float(*)[LDM]>(smem + FP * LDM + FP * LDN);

  const int a = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* wa = w + (long long)a * F * D;
  const T* ba = bias + (long long)a * D;
  const T* xa = x + (long long)a * x_arm_stride;
  const T* tag = nullptr;
  const float two_g = SEPARATE ? 2.f * g[a] : 2.f;

  load_h_tile(h + (long long)a * B * F, m0, B, F, Hs);

  float dacc[4][8];  // dh rows ty*4+i, hidden units tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.f;
  float s = 0.f;
  int mm = 0;

  for (int n0 = 0; n0 < D; n0 += BN) {
    load_w_tile(wa, n0, F, D, Ws);
    __syncthreads();
    float acc[4][4], gm[4][4];
    product_hw(Hs, Ws, F, tx, ty, acc);
    loss_epilogue(acc, ba, xa, m0, n0, B, D, thr, with_mism, two_g, tx, ty, s,
                  mm, gm);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Gt[tx * 4 + j][ty * 4 + i] = round_as(gm[i][j], tag);
    __syncthreads();
    // dh[m][f] += sum_n gm[m][n] * W[f][n]
    const int kmax = min(BN, D - n0);
    for (int k = 0; k < kmax; ++k) {
      const float4 gv = *reinterpret_cast<const float4*>(&Gt[k][ty * 4]);
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float wv = Ws[tx + 16 * j][k];
#pragma unroll
        for (int i = 0; i < 4; ++i) dacc[i][j] = fmaf(g4[i], wv, dacc[i][j]);
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

  if (SEPARATE) return;  // the separate backward writes no sums
  store_block_sums(s, mm, (long long)a * gridDim.x + blockIdx.x, part_sum,
                   part_mism);
}

template <typename T, bool SEPARATE>
int launch(const void* h, const void* w, const void* bias, const void* x,
           long long x_arm_stride, const void* g, int A, int B, int F, int D,
           float thr, int with_mism, void* part_sum, void* part_mism,
           void* out, void* dh, void* dw, void* db, void* stream) {
  if (F > FP || F < 1 || A > 65535) return (int)cudaErrorInvalidValue;
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        recon_fwdbwd_rows<T, SEPARATE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(recon_fwdbwd_cols<T, SEPARATE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    attrs_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* hp = static_cast<const T*>(h);
  const T* wp = static_cast<const T*>(w);
  const T* bp = static_cast<const T*>(bias);
  const T* xp = static_cast<const T*>(x);
  const float* gp = static_cast<const float*>(g);
  const dim3 g1((B + BM - 1) / BM, A);
  recon_fwdbwd_rows<T, SEPARATE><<<g1, THREADS, SMEM_BYTES, st>>>(
      hp, wp, bp, xp, x_arm_stride, gp, B, F, D, thr, with_mism,
      static_cast<float*>(part_sum), static_cast<int*>(part_mism),
      static_cast<float*>(dh));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((D + BN - 1) / BN, A);
  recon_fwdbwd_cols<T, SEPARATE><<<g2, THREADS, SMEM_BYTES, st>>>(
      hp, wp, bp, xp, x_arm_stride, gp, B, F, D, static_cast<float*>(dw),
      static_cast<float*>(db));
  err = cudaGetLastError();
  if (err != cudaSuccess || SEPARATE) return (int)err;
  recon_fwdbwd_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(part_sum), static_cast<const int*>(part_mism),
      (int)g1.x, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of block partials the scratch buffers hold for each arm.
long long recon_fwdbwd_partials_per_arm(int B) {
  return (long long)((B + BM - 1) / BM);
}

// Largest hidden width F the kernel takes.
int recon_fwdbwd_max_f() { return FP; }

int recon_fwdbwd_f32(const void* h, const void* w, const void* bias,
                     const void* x, long long x_arm_stride, int A, int B,
                     int F, int D, float thr, int with_mism, void* part_sum,
                     void* part_mism, void* out, void* dh, void* dw, void* db,
                     void* stream) {
  return launch<float, false>(h, w, bias, x, x_arm_stride, nullptr, A, B, F,
                              D, thr, with_mism, part_sum, part_mism, out, dh,
                              dw, db, stream);
}

int recon_fwdbwd_bf16(const void* h, const void* w, const void* bias,
                      const void* x, long long x_arm_stride, int A, int B,
                      int F, int D, float thr, int with_mism, void* part_sum,
                      void* part_mism, void* out, void* dh, void* dw,
                      void* db, void* stream) {
  return launch<__nv_bfloat16, false>(h, w, bias, x, x_arm_stride, nullptr,
                                      A, B, F, D, thr, with_mism, part_sum,
                                      part_mism, out, dh, dw, db, stream);
}

// The separate backward: dh, dW, db for the per-arm cotangent g (A,) f32.
int recon_bwd_f32(const void* g, const void* h, const void* w,
                  const void* bias, const void* x, long long x_arm_stride,
                  int A, int B, int F, int D, void* dh, void* dw, void* db,
                  void* stream) {
  if (!g) return (int)cudaErrorInvalidValue;
  return launch<float, true>(h, w, bias, x, x_arm_stride, g, A, B, F, D, 0.f,
                             0, nullptr, nullptr, nullptr, dh, dw, db, stream);
}

int recon_bwd_bf16(const void* g, const void* h, const void* w,
                   const void* bias, const void* x, long long x_arm_stride,
                   int A, int B, int F, int D, void* dh, void* dw, void* db,
                   void* stream) {
  if (!g) return (int)cudaErrorInvalidValue;
  return launch<__nv_bfloat16, true>(h, w, bias, x, x_arm_stride, g, A, B, F,
                                     D, 0.f, 0, nullptr, nullptr, nullptr, dh,
                                     dw, db, stream);
}

}  // extern "C"
