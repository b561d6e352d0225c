// The whole MSE decoder in one call: trunk fc6..fc10 (Linear + ReLU), output
// layer fc11 + ReLU, the reconstruction loss sums and, in training, the
// complete backward with cotangent 1.  Neither the (A, B, D) reconstruction
// nor its cotangent, nor any trunk activation of the backward, is left in
// device memory for autograd.  Hand-written for Hopper (sm_90a), bound with
// ctypes.
//
// Replaces the TPU kernels of dvae_tpu/ops/decoder_pallas.py: `_fwd_kernel`
// (:115, launched by `_fwd` :188, pallas_call at :194), the value-only
// forward of `fused_decoder_mse` that eval runs (entry points
// decoder_fwd_*), and `_fwdbwd_kernel` (:211, launched by `_fwdbwd_call`
// :269, pallas_call at :289), the training forward with the unscaled
// gradients (entry points decoder_fwdbwd_*).  Per arm a:
//
//     h_1 = relu(z W_6 + b_6), h_i = relu(h_{i-1} W_{5+i} + b_{5+i}), i <= 5
//     r   = relu(h_5 W_11 + b_11)
//     sumsq_a = sum (r - x)^2,   mism_a = #{ (r > thr) != (x > thr) }
//     gm  = 2 * 1[r > 0] * (r - x)                          (never stored)
//     dW_11 = h_5^T gm, db_11 = sum_rows gm, g_5 = 1[h_5 > 0] (gm W_11^T)
//     dW_i  = h_{i-1}^T g_i, db_i = sum_rows g_i,
//     g_{i-1} = 1[h_{i-1} > 0] (g_i W_i^T),  dz = g_1 W_6^T
//
// The widths are read off the weights (fc6: C+S -> L, fc7: L -> F, fc8..10:
// F -> F, fc11: F -> D).  Activations are rounded to the operand type after
// each ReLU, gm and every g after its gate, for the products; the bias
// gradients sum the unrounded values; products accumulate in f32; dz leaves
// in the operand type (decoder_pallas.py:104-107, :250-266).  The ReLUs and
// gates are comparisons, so a NaN propagates.
//
// Operands: z (A,B,Z); W_i (A,in_i,out_i), b_i (A,out_i); W_11 (A,F,D),
// b_11 (A,D); x (B,D) shared (arm stride 0) or per-arm (A,B,D); all f32 or
// all bf16.  Outputs: (A,2) f32 sums; in training also dz (A,B,Z) in the
// operand type and, in f32, dW_i, db_i, dW_11, db_11.  Every trunk output
// width <= 128; Z is bounded by the shared memory (see decoder_smem_bytes).
//
// Bound at the production shape (A=5, B=5000, Z=94, L=10, F=100, D=5032):
//   forward 2*A*B*(94*10 + 10*100 + 3*100^2 + 100*5032) = 26.76 GFLOP ->
//   0.40 ms in f32 on the FP32 cores (67 TFLOP/s); forward + backward three
//   times that, 1.20 ms.  Bytes (operands read once, outputs written once):
//   about 114 MB forward, 135 MB in training -> 0.034 / 0.040 ms.  Bound by
//   operations; 94% of them are the three fc11 products.
// Design.  The TPU kernel walks a sequential grid with every arm's gradient
// accumulators resident in its fast memory; a CUDA grid has neither the
// order nor the room (dW_11 alone is 10 MB).  Instead:
//   pass 1, blocks (arm, 64-row tile): the z tile and the trunk run in
//     shared memory (weights read through L1/L2: one arm's trunk is 128 KB
//     and every block of the arm reads it); h_5 stays in shared memory and
//     the block walks every 64-column tile of D as the fused recon kernel
//     does: r tile = h_5 W_11, loss epilogue into block partials, and in
//     training gm into shared memory and g_5 += gm W_11^T in registers.
//     In training all five activations of the tile stay resident (137 KB
//     at the production shape), so the trunk backward follows at once in
//     the same block: gate, db and dW partials of the tile's 64 rows, the
//     next g from a transposed weight chunk staged in shared memory, and
//     dz written once.  h_5 is stashed as (A,B,F) in the operand type;
//   pass 2 (training): blocks (arm, 64-column tile) walking every row tile:
//     dW_11 and db_11 with r recomputed from the stashed h_5, the column
//     pass of the fused recon kernel (recon_tiles.cuh), so dW_11 and db_11
//     equal that kernel's bit for bit on the same h_5;
//   pass 3: fixed-order reductions in double of the block partials: the
//     loss sums per arm, and in training the trunk gradients (one partial
//     vector of 32,150 floats per row tile: 50.8 MB at B = 5000).
// Nothing of size (A,B,D) is written; repeated launches agree bit for bit.
// Rows past B are loaded as zeros and masked in the loss, so their gm and
// every g are exactly 0 and they add nothing to any gradient.  Products are
// SIMT FMAs on f32 operands in shared memory; no tensor cores yet.

#include "recon_tiles.cuh"

namespace {

constexpr int N_TRUNK = 5;      // fc6..fc10
constexpr int WP = 128;         // widest trunk layer output: 16 threads x 8
constexpr int NCH = 32;         // output units of a staged W^T chunk
constexpr int LDW = WP + 1;     // its row stride (conflict-free both ways)
constexpr int GRAD_THREADS = 256;
// dynamic shared memory a block may take: the card's 232,448 bytes less
// 1 KB for the static arrays of the block reductions
constexpr int MAX_SMEM = 232448 - 1024;

// Shared-memory plan and operands of the trunk, passed by value.
template <typename T>
struct Trunk {
  const T* w[N_TRUNK];
  const T* b[N_TRUNK];
  int width[N_TRUNK + 1];    // width[0] = Z, width[l + 1] = outputs of layer l
  int act_off[N_TRUNK + 1];  // float offset of activation l, laid [k][LDM]
  int s0_off, s1_off;        // two scratch tiles
  int w_off[N_TRUNK];        // offsets into one tile's gradient partials
  int b_off[N_TRUNK];
  int n_grad;                // their length
};

// Where the reduced trunk gradients go: segment s of the partial vector
// (W_6, b_6, W_7, ...) becomes the contiguous (A, size_s) block at
// off_s * A of the output.
struct Segments {
  int off[2 * N_TRUNK];
  int size[2 * N_TRUNK];
};

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float relu_nan(float y) {
  return (y < 0.f) ? 0.f : y;  // NaN propagates, like relu
}

// Pass 1: grid (ceil(B/BM), A).
template <typename T, bool TRAIN>
__global__ void __launch_bounds__(THREADS)
decoder_rows(const T* __restrict__ z, const Trunk<T> tr,
             const T* __restrict__ w11, const T* __restrict__ b11,
             const T* __restrict__ x, long long x_arm_stride, int B, int D,
             float thr, int with_mism, float* __restrict__ part_sum,
             int* __restrict__ part_mism, T* __restrict__ h5,
             float* __restrict__ part_grad, T* __restrict__ dz) {
  extern __shared__ __align__(16) float smem[];
  const int a = blockIdx.y;
  const int m0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const T* tag = nullptr;
  const int Z = tr.width[0];
  const int F = tr.width[N_TRUNK];

  // z tile, transposed: zs[k][m] = z[a, m0 + m, k], zero past B
  {
    float* zs = smem + tr.act_off[0];
    const T* za = z + (long long)a * B * Z;
    for (int idx = tid; idx < BM * Z; idx += THREADS) {
      const int m = idx / Z, k = idx % Z;
      const int row = m0 + m;
      zs[k * LDM + m] = (row < B) ? to_f32(za[(long long)row * Z + k]) : 0.f;
    }
  }
  __syncthreads();

  // trunk forward: rows ty*4+i, output units tx + 16*j
  for (int l = 0; l < N_TRUNK; ++l) {
    const int K = tr.width[l], N = tr.width[l + 1];
    const float* hin = smem + tr.act_off[l];
    float* hout = smem + tr.act_off[l + 1];
    const T* wl = tr.w[l] + (long long)a * K * N;
    const T* bl = tr.b[l] + (long long)a * N;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4 hv = *reinterpret_cast<const float4*>(&hin[k * LDM + ty * 4]);
      const float h4[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        const float wv = (col < N) ? to_f32(wl[(long long)k * N + col]) : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(h4[i], wv, acc[i][j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < N) {
        const float bj = to_f32(bl[col]);
        float4 o;
        o.x = round_as(relu_nan(acc[0][j] + bj), tag);
        o.y = round_as(relu_nan(acc[1][j] + bj), tag);
        o.z = round_as(relu_nan(acc[2][j] + bj), tag);
        o.w = round_as(relu_nan(acc[3][j] + bj), tag);
        *reinterpret_cast<float4*>(&hout[col * LDM + ty * 4]) = o;
      }
    }
    __syncthreads();
  }

  float(*Hs)[LDM] = reinterpret_cast<float(*)[LDM]>(smem + tr.act_off[N_TRUNK]);
  float(*Ws)[LDN] = reinterpret_cast<float(*)[LDN]>(smem + tr.s0_off);
  float(*Gt)[LDM] = reinterpret_cast<float(*)[LDM]>(smem + tr.s1_off);

  if (TRAIN) {  // stash h_5 for the column pass (exact: it is rounded already)
    T* h5a = h5 + (long long)a * B * F;
    for (int idx = tid; idx < BM * F; idx += THREADS) {
      const int m = idx / F, f = idx % F;
      const int row = m0 + m;
      if (row < B) store_as(&h5a[(long long)row * F + f], Hs[f][m]);
    }
  }

  // output layer and loss: walk the column tiles of D
  const T* wa = w11 + (long long)a * F * D;
  const T* ba = b11 + (long long)a * D;
  const T* xa = x + (long long)a * x_arm_stride;
  float dacc[4][8];  // g_5 rows ty*4+i, hidden units tx + 16*j
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) dacc[i][j] = 0.f;
  float s = 0.f;
  int mm = 0;
  for (int n0 = 0; n0 < D; n0 += BN) {
    // Ws[k][n] = W_11[a, k, n0 + n], rows k < F only
    for (int idx = tid; idx < F * BN; idx += THREADS) {
      const int k = idx / BN, n = idx % BN;
      const int col = n0 + n;
      Ws[k][n] = (col < D) ? to_f32(wa[(long long)k * D + col]) : 0.f;
    }
    __syncthreads();
    float acc[4][4], gm[4][4];
    product_hw(Hs, Ws, F, tx, ty, acc);
    loss_epilogue(acc, ba, xa, m0, n0, B, D, thr, with_mism, 2.f, tx, ty, s,
                  mm, gm);
    if (TRAIN) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          Gt[tx * 4 + j][ty * 4 + i] = round_as(gm[i][j], tag);
      __syncthreads();
      // g_5[m][f] += sum_n gm[m][n] * W_11[f][n]
      const int kmax = min(BN, D - n0);
      for (int k = 0; k < kmax; ++k) {
        const float4 gv = *reinterpret_cast<const float4*>(&Gt[k][ty * 4]);
        const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int f = tx + 16 * j;
          const float wv = (f < F) ? Ws[f][k] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) dacc[i][j] = fmaf(g4[i], wv, dacc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  store_block_sums(s, mm, (long long)a * gridDim.x + blockIdx.x, part_sum,
                   part_mism);
  if (!TRAIN) return;

  // trunk backward on the resident activations
  float* gp = part_grad
              + ((long long)a * gridDim.x + blockIdx.x) * tr.n_grad;
  float* sc = smem + tr.s0_off;  // the gated, rounded g of this layer [n][m]
  float* sn = smem + tr.s1_off;  // scratch: db partials, then W^T chunks
  for (int l = N_TRUNK - 1; l >= 0; --l) {
    const int K = tr.width[l], N = tr.width[l + 1];
    const float* hin = smem + tr.act_off[l];
    const float* hout = smem + tr.act_off[l + 1];
    // gate by this layer's output; db sums the unrounded values
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      if (col < N) {
        const float4 hv =
            *reinterpret_cast<const float4*>(&hout[col * LDM + ty * 4]);
        const float g0 = (hv.x > 0.f) ? dacc[0][j] : 0.f;
        const float g1 = (hv.y > 0.f) ? dacc[1][j] : 0.f;
        const float g2 = (hv.z > 0.f) ? dacc[2][j] : 0.f;
        const float g3 = (hv.w > 0.f) ? dacc[3][j] : 0.f;
        sn[ty * WP + col] = (g0 + g1) + (g2 + g3);
        float4 o;
        o.x = round_as(g0, tag);
        o.y = round_as(g1, tag);
        o.z = round_as(g2, tag);
        o.w = round_as(g3, tag);
        *reinterpret_cast<float4*>(&sc[col * LDM + ty * 4]) = o;
      }
    }
    __syncthreads();
    if (tid < N) {  // the 16 row groups' sums, added in a fixed order
      float t = 0.f;
      for (int r = 0; r < 16; ++r) t += sn[r * WP + tid];
      gp[tr.b_off[l] + tid] = t;
    }
    // dW[k][n] = sum_m hin[k][m] * g[n][m]: units k = kb + ty + 16*i,
    // n = tx + 16*j (indices past the widths are clamped and not stored)
    for (int kb = 0; kb < K; kb += WP) {
      float wacc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) wacc[i][j] = 0.f;
      for (int m = 0; m < BM; ++m) {
        float hv[8], gv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          hv[i] = hin[min(kb + ty + 16 * i, K - 1) * LDM + m];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          gv[j] = sc[min(tx + 16 * j, N - 1) * LDM + m];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            wacc[i][j] = fmaf(hv[i], gv[j], wacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int k = kb + ty + 16 * i;
        if (k >= K) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = tx + 16 * j;
          if (n < N) gp[tr.w_off[l] + k * N + n] = wacc[i][j];
        }
      }
    }
    __syncthreads();  // the db partials are read before sn is staged over
    // the next g: rows ty*4+i, input units kb + tx + 16*j
    const T* wl = tr.w[l] + (long long)a * K * N;
    for (int kb = 0; kb < K; kb += WP) {
      const int kw = min(WP, K - kb);
      float acc[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int n0 = 0; n0 < N; n0 += NCH) {
        const int nw = min(NCH, N - n0);
        // sn[n][k] = W[kb + k][n0 + n]
        for (int idx = tid; idx < kw * NCH; idx += THREADS) {
          const int k = idx / NCH, n = idx % NCH;
          sn[n * LDW + k] =
              (n < nw) ? to_f32(wl[(long long)(kb + k) * N + n0 + n]) : 0.f;
        }
        __syncthreads();
        for (int n = 0; n < nw; ++n) {
          const float4 gv =
              *reinterpret_cast<const float4*>(&sc[(n0 + n) * LDM + ty * 4]);
          const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = tx + 16 * j;
            const float wv = (k < kw) ? sn[n * LDW + k] : 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(g4[i], wv, acc[i][j]);
          }
        }
        __syncthreads();
      }
      if (l == 0) {  // dz, in the operand type
        T* dza = dz + (long long)a * B * Z;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = m0 + ty * 4 + i;
          if (row >= B) continue;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int k = kb + tx + 16 * j;
            if (k < K) store_as(&dza[(long long)row * Z + k], acc[i][j]);
          }
        }
      } else {  // K <= WP: one chunk
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dacc[i][j] = acc[i][j];
      }
    }
    float* t = sc;
    sc = sn;
    sn = t;
  }
}

// Pass 3 (training): grid (ceil(n_grad / GRAD_THREADS), A).  Each thread
// sums one trunk gradient entry over the arm's row tiles, in order.
__global__ void __launch_bounds__(GRAD_THREADS)
decoder_grad_reduce(const float* __restrict__ part_grad, int n_tiles,
                    int n_grad, const Segments seg, int A,
                    float* __restrict__ out) {
  const int p = blockIdx.x * GRAD_THREADS + threadIdx.x;
  const int a = blockIdx.y;
  if (p >= n_grad) return;
  const float* pa = part_grad + (long long)a * n_tiles * n_grad + p;
  double s = 0.0;
  for (int t = 0; t < n_tiles; ++t) s += (double)pa[(long long)t * n_grad];
  int sidx = 2 * N_TRUNK - 1;
  while (sidx > 0 && p < seg.off[sidx]) --sidx;
  out[(long long)seg.off[sidx] * A + (long long)a * seg.size[sidx]
      + (p - seg.off[sidx])] = (float)s;
}

// The shared-memory plan for the given widths; returns its size in bytes,
// or -1 where a width is out of range.
template <typename T>
long long plan(const int* widths, bool train, Trunk<T>* tr) {
  int wmax = 0;
  for (int l = 0; l <= N_TRUNK; ++l) {
    if (widths[l] < 1) return -1;
    if (l > 0 && widths[l] > WP) return -1;
    if (l > 0 && widths[l] > wmax) wmax = widths[l];
    if (tr) tr->width[l] = widths[l];
  }
  long long at = 0;
  int off[N_TRUNK + 1];
  if (train) {  // every activation stays for the backward
    for (int l = 0; l <= N_TRUNK; ++l) {
      off[l] = (int)at;
      at += (long long)widths[l] * LDM;
    }
  } else {      // the z tile and two buffers in turns
    off[0] = 0;
    at = (long long)widths[0] * LDM;
    for (int l = 1; l <= N_TRUNK; ++l)
      off[l] = (int)(at + (long long)(l % 2) * wmax * LDM);
    at += 2LL * wmax * LDM;
  }
  // scratch tiles: the W_11 tile (F rows) and the gm tile (BN rows) of the
  // walk; in the backward g [n][LDM] and db partials / W^T chunks
  const long long s_rows = wmax > BM ? wmax : BM;
  const long long s0 = at, s1 = at + s_rows * LDM;
  at = train ? s1 + s_rows * LDM : s1;
  if (at > (1LL << 28)) return -1;
  if (tr) {
    for (int l = 0; l <= N_TRUNK; ++l) tr->act_off[l] = off[l];
    tr->s0_off = (int)s0;
    tr->s1_off = (int)s1;
    int g = 0;
    for (int l = 0; l < N_TRUNK; ++l) {
      tr->w_off[l] = g;
      g += widths[l] * widths[l + 1];
      tr->b_off[l] = g;
      g += widths[l + 1];
    }
    tr->n_grad = g;
  }
  return at * (long long)sizeof(float);
}

int n_grad_of(const int* widths) {
  int g = 0;
  for (int l = 0; l < N_TRUNK; ++l) g += (widths[l] + 1) * widths[l + 1];
  return g;
}

// wb: host array of the 12 device pointers W_6, b_6, ..., W_10, b_10, W_11,
// b_11; widths: host array Z, out_6, ..., out_10.
template <typename T, bool TRAIN>
int launch(const void* z, const void* const* wb, const int* widths,
           const void* x, long long x_arm_stride, int A, int B, int D,
           float thr, int with_mism, void* part_sum, void* part_mism,
           void* out, void* h5, void* part_grad, void* dz, void* dtrunk,
           void* dw11, void* db11, void* stream) {
  Trunk<T> tr;
  const long long bytes = plan<T>(widths, TRAIN, &tr);
  if (bytes < 0 || bytes > MAX_SMEM || A < 1 || A > 65535 || B < 1 || D < 1)
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < N_TRUNK; ++l) {
    tr.w[l] = static_cast<const T*>(wb[2 * l]);
    tr.b[l] = static_cast<const T*>(wb[2 * l + 1]);
  }
  static bool attrs_set = false;
  if (!attrs_set) {
    cudaError_t e = cudaFuncSetAttribute(
        decoder_rows<T, TRAIN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (TRAIN) {
      e = cudaFuncSetAttribute(recon_fwdbwd_cols<T, false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
      if (e != cudaSuccess) return (int)e;
    }
    attrs_set = true;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* w11 = static_cast<const T*>(wb[2 * N_TRUNK]);
  const T* b11 = static_cast<const T*>(wb[2 * N_TRUNK + 1]);
  const T* xp = static_cast<const T*>(x);
  const int F = widths[N_TRUNK];
  const dim3 g1((B + BM - 1) / BM, A);
  decoder_rows<T, TRAIN><<<g1, THREADS, (size_t)bytes, st>>>(
      static_cast<const T*>(z), tr, w11, b11, xp, x_arm_stride, B, D, thr,
      with_mism, static_cast<float*>(part_sum), static_cast<int*>(part_mism),
      static_cast<T*>(h5), static_cast<float*>(part_grad),
      static_cast<T*>(dz));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (TRAIN) {
    const dim3 g2((D + BN - 1) / BN, A);
    recon_fwdbwd_cols<T, false><<<g2, THREADS, SMEM_BYTES, st>>>(
        static_cast<const T*>(h5), w11, b11, xp, x_arm_stride, nullptr, B, F,
        D, static_cast<float*>(dw11), static_cast<float*>(db11));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Segments seg;
    for (int l = 0; l < N_TRUNK; ++l) {
      seg.off[2 * l] = tr.w_off[l];
      seg.size[2 * l] = widths[l] * widths[l + 1];
      seg.off[2 * l + 1] = tr.b_off[l];
      seg.size[2 * l + 1] = widths[l + 1];
    }
    const dim3 g3((tr.n_grad + GRAD_THREADS - 1) / GRAD_THREADS, A);
    decoder_grad_reduce<<<g3, GRAD_THREADS, 0, st>>>(
        static_cast<const float*>(part_grad), (int)g1.x, tr.n_grad, seg, A,
        static_cast<float*>(dtrunk));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  recon_fwdbwd_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(part_sum), static_cast<const int*>(part_mism),
      (int)g1.x, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Row tiles of one arm: the block partials each scratch buffer holds.
long long decoder_partials_per_arm(int B) {
  return (long long)((B + BM - 1) / BM);
}

// Length of one row tile's trunk-gradient partial vector (and of one arm's
// reduced trunk gradients): sum of (in + 1) * out over fc6..fc10.
long long decoder_grad_len(const int* widths) { return n_grad_of(widths); }

// Dynamic shared memory a block needs for these widths (-1: a trunk output
// wider than 128, or a width below 1), and the most a block may take.
long long decoder_smem_bytes(const int* widths, int train) {
  return plan<float>(widths, train != 0, nullptr);
}
long long decoder_max_smem() { return MAX_SMEM; }

int decoder_fwd_f32(const void* z, const void* const* wb, const int* widths,
                    const void* x, long long x_arm_stride, int A, int B,
                    int D, float thr, int with_mism, void* part_sum,
                    void* part_mism, void* out, void* stream) {
  return launch<float, false>(z, wb, widths, x, x_arm_stride, A, B, D, thr,
                              with_mism, part_sum, part_mism, out, nullptr,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              stream);
}

int decoder_fwd_bf16(const void* z, const void* const* wb, const int* widths,
                     const void* x, long long x_arm_stride, int A, int B,
                     int D, float thr, int with_mism, void* part_sum,
                     void* part_mism, void* out, void* stream) {
  return launch<__nv_bfloat16, false>(z, wb, widths, x, x_arm_stride, A, B, D,
                                      thr, with_mism, part_sum, part_mism,
                                      out, nullptr, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, stream);
}

// Training: also h5 (A,B,F) scratch in the operand type, part_grad
// (A * tiles * grad_len) f32 scratch, dz (A,B,Z) in the operand type,
// dtrunk (A * grad_len) f32 laid out layer-major (dW_6 (A,in,out), db_6
// (A,out), dW_7, ...), dW_11 (A,F,D) and db_11 (A,D) f32.
int decoder_fwdbwd_f32(const void* z, const void* const* wb,
                       const int* widths, const void* x,
                       long long x_arm_stride, int A, int B, int D, float thr,
                       int with_mism, void* part_sum, void* part_mism,
                       void* out, void* h5, void* part_grad, void* dz,
                       void* dtrunk, void* dw11, void* db11, void* stream) {
  return launch<float, true>(z, wb, widths, x, x_arm_stride, A, B, D, thr,
                             with_mism, part_sum, part_mism, out, h5,
                             part_grad, dz, dtrunk, dw11, db11, stream);
}

int decoder_fwdbwd_bf16(const void* z, const void* const* wb,
                        const int* widths, const void* x,
                        long long x_arm_stride, int A, int B, int D,
                        float thr, int with_mism, void* part_sum,
                        void* part_mism, void* out, void* h5, void* part_grad,
                        void* dz, void* dtrunk, void* dw11, void* db11,
                        void* stream) {
  return launch<__nv_bfloat16, true>(z, wb, widths, x, x_arm_stride, A, B, D,
                                     thr, with_mism, part_sum, part_mism, out,
                                     h5, part_grad, dz, dtrunk, dw11, db11,
                                     stream);
}

}  // extern "C"
