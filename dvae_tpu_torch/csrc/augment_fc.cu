// The frozen augmenter's fused linear layer on Hopper (sm_90a), bound with
// ctypes:
//
//     Y = relu(((X W + b) - mean) * rstd) [* (mask > 0)]
//
// X (M, K) with rows 16-byte aligned (any row stride that is), W (K, N)
// prepared once (below), b (N), the batch norm's running mean and
// rstd = rsqrt(var + eps) (N, f32; none for fc11), and for a ZINB
// augmenter's output layer the mask of the input: row r of Y is
// multiplied by (mask[r % mask_rows] > 0).  Every layer the augmenter
// routes here (fc1-fc11) ends in a ReLU after a batch norm without affine
// parameters, or after none; the others (the noise layer with its affine
// bnz and ELU, fc_mu, fc_sigma) stay plain.  Y is written
// straight into the caller's (M, N) view, any even row stride.  All f32 or
// all bf16 (X, W, b, Y); f32 accumulation.
//
// Why it exists: it replaces no TPU kernel.  The JAX package leaves the
// augmenter's products to XLA (dvae_tpu/augment/augmenter.py), and the port
// left them to cuBLAS, whose f32 product for K or N = 1006 (D/5, rows not
// 16-byte aligned) is the SIMT kernel `cutlass_80_simt_sgemm_256x128_8x4_nn
// _align1` at ~51 TFLOP/s, followed by four to six elementwise passes over
// each (A, B, ·) output.  That was half of the augmented training step.
//
// What bounds it: operations.  One augmented step (A=5, B=5000, D=5032,
// H=500: fc1-fc4 on B rows, fc5 and fc6-fc11 on A·B rows) is 415 GFLOP of
// products, 253 of them fc11's; each layer's bytes (X, W, Y once) are far
// below its operations at the card's 3.35 TB/s (fc11's 503 MB output: 0.15
// ms).  f32 operands need 3xTF32 to keep f32's accuracy (one TF32 product
// fails the augmented cell's check of the views by 20x), three TF32
// products a product: 2.5 ms of the tensor cores' 495 TFLOP/s a step, 0.84
// ms counted once; bf16 one product at 989.
//
// Design, on the tensor cores through `wgmma` (csrc/wgmma.cuh); the times
// and readings quoted are an H100 80GB HBM3's at 700 W:
//   * W is prepared once per weight tensor by the wrapper, in PyTorch
//     (ops/augment.py `prepare_weight`, cached on the tensor and its
//     version): K padded with zeros to a multiple of the stage's KT (32 f32,
//     64 bf16), N to the tile's 128, cut into (128 columns x KT) tiles of
//     K-major core matrices (the layout a B operand without swizzle reads),
//     and for f32 split into its tf32 halves hi + lo (rounded to nearest,
//     every NaN made the quiet one first, so that both encodings stay NaN,
//     fault C5).  A stage's B tile is one bulk copy.  Within a stage the K
//     order is permuted (`k_order` there, the same as zinb_fwdbwd.cu's
//     pass 2): a thread's A values of a stage are then 8 (f32) or 16 (bf16)
//     consecutive columns of its two rows, two 16-byte reads a row.
//   * X is read as it lies, by TMA boxes of 128 rows x 128 bytes with the
//     128-byte swizzle (so the reads above fall on distinct banks); columns
//     past K and rows past M arrive as zeros.  The A operand goes from
//     shared memory to registers and, for f32, is split there into tf32
//     halves (integer rounding after quiet_nan, mma.cuh split_tf32_bits):
//     the activations are read once, and no layer writes split planes for
//     the next one.
//   * Blocks of two consumer warpgroups (64 rows each: a 128 x 128 tile)
//     and one producer warpgroup, persistent: one block an SM walks tiles
//     t = blockIdx.x, + gridDim.x, ..., in groups of 16 row tiles with the
//     row tile fastest, so the blocks at work at one time share 16 row
//     panels of X and a few column panels of W in L2.  One producer thread
//     keeps a ring of stages (4 f32 of 48 KB, 6 bf16 of 32 KB) filled
//     across tiles, so one tile's epilogue overlaps the next one's loads.
//     The producer warpgroup hands most of its registers to the consumers
//     (setmaxnreg 40 / 232): a consumer thread holds 128 sums (the tile's
//     and the run's) and 32 A registers, which spilled at the even share
//     of 168 a thread (fc11's shape, f32, an epilogue of stores alone:
//     4.39 ms spilled, 2.13 ms not).
//   * m64n128k8 tf32 products, three a k step (lo hi, hi lo, hi hi:
//     3xTF32), or m64n128k16 bf16, summed from zero in a run accumulator
//     over a stage (f32, 32 values of K) or four (bf16, 256), which is
//     then added to the tile's sum rounded to nearest: the tensor cores
//     round a sum toward zero, at the size of what it holds (over fc1's
//     K = 5032 a single accumulator drifts, mma.cuh `add4`).  So an f32
//     run sums its eight small products (lo hi, hi lo) before its four
//     large ones (hi hi), and only four of its twelve sums round at the
//     size of the result.  The augmented training cell's first views
//     read 1.9e-6 to 3.5e-6 of float64 on eight seeds this way, and
//     2.7e-6 to 4.9e-6 through the cuBLAS products this kernel replaced;
//     one-stage runs with the products interleaved read 3.7e-6 to 4.9e-6
//     and two-stage ones 6.2e-6 to 8.4e-6 (three seeds), 7% faster at
//     fc11's shape.
//   * The epilogue is the arithmetic of the plain layer
//     (augment/augmenter.py `_lin`, `_bn`, the ReLU) in its order,
//     without contraction into fused multiply-adds: + b, - mean, * rstd,
//     ReLU, * mask; bf16 rounds where the plain bf16 layer
//     does (the product, the bias add, the batch norm's output).  Each
//     warp puts its sums through its rows of a staging buffer 32 columns
//     at a time and stores whole 128-byte runs of rows, the per-column
//     parameters loaded once for the tile.  At fc11's shape, f32, with
//     two-stage runs: a first form (four activations branched on in the
//     unrolled epilogue, two columns a store straight from the fragments)
//     took 5.3 ms against 1.7 ms without an epilogue; the fragments stored
//     straight with one activation fixed at compile time 3.7 ms; this form
//     2.3 ms (2.4 ms
//     with the one-stage runs above, 105 TFLOP/s counted once, against
//     5.9 ms for cuBLAS's product and the elementwise passes).
// Every sum runs in an order fixed by the shape: repeated launches are
// bit-identical.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int BM = 128;                   // rows of a tile: two warpgroups
constexpr int BN = 128;                   // columns of a tile: N of m64n128
constexpr int CONSUMERS = 256;            // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
constexpr int ROW_BYTES = 128;            // bytes of K a stage: a swizzle row
constexpr int GROUP_M = 16;               // row tiles a raster group
constexpr uint32_t A_BYTES = BM * ROW_BYTES;
// registers a thread (setmaxnreg): the producer gives most of its share to
// the consumers, whose 128 accumulators and A fragments need 200-odd
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
// the epilogue's staging: 32 columns of the tile at a time, rows padded to
// 40 floats so that a warp's fragment stores fall on distinct banks
constexpr int EPI_COLS = 32, EPI_PITCH = 40;
constexpr uint32_t EPI_BYTES = BM * EPI_PITCH * 4;

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int PLANES = 2;  // tf32 hi and lo
  static constexpr int STAGES = 4;
  static constexpr int RUN = 1;     // stages a run: 32 values of K
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int STAGES = 6;
  static constexpr int RUN = 4;     // 256 values of K
};

// K a stage
template <typename T>
__host__ __device__ constexpr int kt() {
  return ROW_BYTES / (int)sizeof(T);
}
// a stage's W tile, every plane
template <typename T>
__host__ __device__ constexpr uint32_t b_bytes() {
  return (uint32_t)(Traits<T>::PLANES * BN * ROW_BYTES);
}
// a stage: a multiple of 1,024 bytes (the swizzle's atom)
template <typename T>
__host__ __device__ constexpr uint32_t stage_bytes() {
  return A_BYTES + b_bytes<T>();
}
// the ring, the epilogue's staging, and 1,024 bytes to align the ring
template <typename T>
__host__ __device__ constexpr size_t smem_bytes() {
  return 1024 + (size_t)Traits<T>::STAGES * stage_bytes<T>() + EPI_BYTES;
}

// What the epilogue applies; a null pointer leaves its step out.
template <typename T>
struct Epi {
  const T* bias;       // (N)
  const float* mean;   // (N) running mean; null: no batch norm
  const float* rstd;   // (N) rsqrt(running var + eps)
  const T* mask;       // (mask_rows, N), row stride mask_ld
  long long mask_ld;
  int mask_rows;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Tile t of the walk: groups of GROUP_M row tiles, the row tile fastest.
__device__ __forceinline__ void tile_coords(int t, int n_mt, int n_nt,
                                            int& mt, int& nt) {
  const int per_group = GROUP_M * n_nt;
  const int g = t / per_group, first = g * GROUP_M;
  const int gm = min(n_mt - first, GROUP_M);
  const int r = t - g * per_group;
  mt = first + r % gm;
  nt = r / gm;
}

// One output of the epilogue: the plain layer's steps in its order.
template <bool F32>
__device__ __forceinline__ float epilogue_one(float v, bool bias, float bb,
                                              bool bn, float mn, float rs) {
  if (!F32) v = round_bf16(v);
  if (bias) {
    v = __fadd_rn(v, bb);
    if (!F32) v = round_bf16(v);
  }
  if (bn) {
    v = __fmul_rn(__fsub_rn(v, mn), rs);
    if (!F32) v = round_bf16(v);
  }
  return v < 0.f ? 0.f : v;  // ReLU; NaN stays NaN
}

// Four consecutive outputs: one 16-byte (f32) or 8-byte (bf16) store where
// ``vec`` (rows and base aligned) and all four lie inside N, else one a
// column that does.
__device__ __forceinline__ void store4(float* p, const float (&y)[4], int n,
                                       bool vec) {
  if (vec && n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(y[0], y[1], y[2], y[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = y[e];
  }
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&y)[4],
                                       int n, bool vec) {
  if (vec && n == 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(y[0], y[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(y[2], y[3]);
    uint2 u;
    u.x = *reinterpret_cast<uint32_t*>(&lo);
    u.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) p[e] = __float2bfloat16_rn(y[e]);
  }
}

// The epilogue of one warp's 16 x 128 sums, in four rounds of 32 columns
// through its 16 rows of the staging buffer: the fragments go in
// (acc[4 jj + 2 h + e] is row rl + 8 h, column 8 jj + 2 tq + e of the
// tile; wgmma's accumulator fragment), then each lane takes four columns
// of 4 of the 16 rows: the plain layer's steps, and stores of whole
// 128-byte runs of a row.  The per-column parameters of all four rounds
// are loaded first.
template <typename T>
__device__ __forceinline__ void epilogue(const float (&acc)[64], float* stg,
                                         int rl, int gq, int tq, int lane,
                                         int m0, int n0, int M, int N,
                                         const Epi<T>& ep, T* __restrict__ out,
                                         long long ldo, bool vec) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int ROUNDS = BN / EPI_COLS;
  const T* __restrict__ bias_p = ep.bias;
  const float* __restrict__ mean_p = ep.mean;
  const float* __restrict__ rstd_p = ep.rstd;
  const T* __restrict__ mask_p = ep.mask;
  const bool bias = bias_p != nullptr, bn = mean_p != nullptr;
  const bool masked = mask_p != nullptr;
  const int c4 = 4 * (lane % 8);  // this lane's columns of a round
  const int r0 = rl - gq;         // the warp's first row of the tile
  float bb[ROUNDS][4], mn[ROUNDS][4], rs[ROUNDS][4];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = min(n0 + EPI_COLS * r + c4 + e, N - 1);
      bb[r][e] = bias ? to_f32(bias_p[c]) : 0.f;
      mn[r][e] = bn ? mean_p[c] : 0.f;
      rs[r][e] = bn ? rstd_p[c] : 0.f;
    }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    __syncwarp();  // the warp's reads of the last round are done
#pragma unroll
    for (int j = 0; j < EPI_COLS / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * (4 * r + j) + 2 * h;
        *reinterpret_cast<float2*>(stg + (rl + 8 * h) * EPI_PITCH + 8 * j +
                                   2 * tq) = make_float2(acc[i], acc[i + 1]);
      }
    __syncwarp();
    const int col = n0 + EPI_COLS * r + c4;
    const int n = min(4, N - col);  // columns of the four inside N
    if (n <= 0) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int rw = r0 + 4 * q + lane / 8;  // row of the tile
      const int row = m0 + rw;
      if (row >= M) continue;
      const float4 v =
          *reinterpret_cast<const float4*>(stg + rw * EPI_PITCH + c4);
      const float a[4] = {v.x, v.y, v.z, v.w};
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = epilogue_one<F32>(a[e], bias, bb[r][e], bn, mn[r][e],
                                 rs[r][e]);
        if (masked && e < n) {
          const T m =
              mask_p[(long long)(row % ep.mask_rows) * ep.mask_ld + col + e];
          y[e] = __fmul_rn(y[e], to_f32(m) > 0.f ? 1.f : 0.f);
        }
      }
      store4(out + (long long)row * ldo + col, y, n, vec);
    }
  }
}

// ---------------------------------------------------------------------------
// The product: grid min(tiles, SMs) blocks of THREADS threads.  Warps 0-7
// are the two consumer warpgroups (rows 64 w.. of the tile), warps 8-11 the
// producer warpgroup, of which one thread works.  Iteration it (a stage's
// worth of K of some tile, counted over the block's whole walk) uses stage
// it % STAGES: full[s] completes when its bytes are in, empty[s] when both
// warpgroups' products on it are done.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
augment_fc_tiles(const __grid_constant__ CUtensorMap amap,
                 const T* __restrict__ wp, int M, int N, int nk, int n_mt,
                 int n_nt, Epi<T> ep, T* __restrict__ out, long long ldo,
                 int vec) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int STAGES = Traits<T>::STAGES, RUN = Traits<T>::RUN;
  constexpr int KT = kt<T>();
  constexpr uint32_t BB = b_bytes<T>(), SB = stage_bytes<T>();
  constexpr long long TILE_ELEMS = BB / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  unsigned char* const ring =
      smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);
  float* const stg = reinterpret_cast<float*>(ring + (size_t)STAGES * SB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_tiles = n_mt * n_nt;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {
    // producer: one thread announces a stage's bytes and asks for the X box
    // (TMA) and the W tile (one bulk copy of every plane)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS / 32 && lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        int mt, nt;
        tile_coords(t, n_mt, n_nt, mt, nt);
        const T* wt = wp + (long long)nt * nk * TILE_ELEMS;
        for (int c = 0; c < nk; ++c, ++it) {
          const int s = it % STAGES;
          wg::mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
          unsigned char* st = ring + (size_t)s * SB;
          wg::mbar_expect_tx(&full[s], SB);
          wg::tensor_load_2d(st, &amap, c * KT, mt * BM, &full[s]);
          wg::bulk_load(st + A_BYTES, wt + (long long)c * TILE_ELEMS, BB,
                        &full[s]);
        }
      }
    }
    __syncwarp();
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wgi = warp >> 2;  // the warpgroup: rows 64 wgi.. of the tile
  const int gq = lane >> 2, tq = lane & 3;
  const int rl = wgi * 64 + (warp & 3) * 16 + gq;  // and rl + 8
  float acc[64], run[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) run[i] = 0.f;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    int mt, nt;
    tile_coords(t, n_mt, n_nt, mt, nt);
    for (int c = 0; c < nk; ++c, ++it) {
      const int s = it % STAGES;
      wg::mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = ring + (size_t)s * SB;
      // 16-byte chunks 2 tq and 2 tq + 1 of rows rl and rl + 8, swizzled
      // by the row (rl % 8 == gq): K positions 8 tq.. (f32) or 16 tq..
      // (bf16) of the stage, in the order k_order gave W
      const uint4* r0 = reinterpret_cast<const uint4*>(st + rl * ROW_BYTES);
      const uint4* r1 = r0 + 8 * (ROW_BYTES / 16);
      const uint4 u0 = r0[(2 * tq) ^ gq], u1 = r0[(2 * tq + 1) ^ gq];
      const uint4 w0 = r1[(2 * tq) ^ gq], w1 = r1[(2 * tq + 1) ^ gq];
      const uint32_t v0[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const uint32_t v1[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
      const uint64_t bh = wg::desc(st + A_BYTES, 128, 8 * ROW_BYTES);
      wg::fence_acc(run);
      if constexpr (F32) {
        const uint64_t bl =
            wg::desc(st + A_BYTES + BN * ROW_BYTES, 128, 8 * ROW_BYTES);
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tc::split_tf32_bits(tc::quiet_nan(__uint_as_float(v0[2 * k])),
                              ah[k][0], al[k][0]);
          tc::split_tf32_bits(tc::quiet_nan(__uint_as_float(v1[2 * k])),
                              ah[k][1], al[k][1]);
          tc::split_tf32_bits(tc::quiet_nan(__uint_as_float(v0[2 * k + 1])),
                              ah[k][2], al[k][2]);
          tc::split_tf32_bits(tc::quiet_nan(__uint_as_float(v1[2 * k + 1])),
                              ah[k][3], al[k][3]);
        }
        wg::fence();
        // the small products first (a run's first starts from zero), the
        // large ones last
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint64_t o = (uint64_t)k * (256 >> 4);  // 2 core matrices
          wg::mma_tf32_rs_n128(run, al[k], bh + o, k | (c % RUN));
          wg::mma_tf32_rs_n128(run, ah[k], bl + o, 1);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wg::mma_tf32_rs_n128(run, ah[k], bh + (uint64_t)k * (256 >> 4), 1);
      } else {
        uint32_t ab[4][4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          ab[k][0] = v0[2 * k];
          ab[k][1] = v1[2 * k];
          ab[k][2] = v0[2 * k + 1];
          ab[k][3] = v1[2 * k + 1];
        }
        wg::fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wg::mma_bf16_rs_n128(run, ab[k], bh + (uint64_t)k * (256 >> 4),
                               k | (c % RUN));
      }
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(run);
      if ((tid & 127) == 0) wg::mbar_arrive(&empty[s]);
      // a run ends every RUN stages and at the tile's last stage
      if ((c + 1) % RUN == 0 || c + 1 == nk) {
        if (c < RUN) {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] = run[i];
        } else {
#pragma unroll
          for (int i = 0; i < 64; ++i) acc[i] += run[i];
        }
      }
    }
    epilogue<T>(acc, stg, rl, gq, tq, lane, mt * BM, nt * BN, M, N, ep,
                     out, ldo, vec != 0);
  }
}

// The map of X as a 2-D tensor (M rows of K values, row stride ldx) read in
// boxes of 128 rows x KT values with the 128-byte swizzle; 0 or a CUDA
// error.
template <typename T>
int x_tensor_map(CUtensorMap* m, const T* x, long long ldx, int M, int K) {
  wg::EncodeTiled enc = wg::encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t stride[1] = {(cuuint64_t)ldx * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)kt<T>(), (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      m, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(x), dim, stride, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

bool shape_ok(int M, int K, int N) {
  return M >= 1 && K >= 1 && N >= 1 && M <= 0x7fffffff - BM &&
         N <= 0x7fffffff - BN && cdiv(M, BM) * cdiv(N, BN) <= 0x7fffffff;
}

template <typename T>
int launch(const void* x_, long long ldx, int M, int K, const void* wp,
           int N, const void* bias, const void* mean, const void* rstd,
           const void* mask, long long mask_ld, int mask_rows, void* out_,
           long long ldo, void* stream) {
  const T* x = static_cast<const T*>(x_);
  T* out = static_cast<T*>(out_);
  if (!shape_ok(M, K, N) || ldx < K || ldo < N ||
      (mean != nullptr && rstd == nullptr) ||
      (mask != nullptr && (mask_rows < 1 || mask_ld < N)))
    return (int)cudaErrorInvalidValue;
  // TMA: a 16-byte aligned base and row stride
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (ldx * (long long)sizeof(T)) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  CUtensorMap amap = {};
  int rc = x_tensor_map<T>(&amap, x, ldx, M, K);
  if (rc) return rc;
  Epi<T> ep;
  ep.bias = static_cast<const T*>(bias);
  ep.mean = static_cast<const float*>(mean);
  ep.rstd = static_cast<const float*>(rstd);
  ep.mask = static_cast<const T*>(mask);
  ep.mask_ld = mask_ld;
  ep.mask_rows = mask_rows;
  // four columns a store where every row starts on its alignment
  const int vec = ldo % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(out) % (4 * sizeof(T)) == 0;
  const int n_mt = (int)cdiv(M, BM), n_nt = (int)cdiv(N, BN);
  const int nk = (int)cdiv(K, kt<T>());
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  auto kern = augment_fc_tiles<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes<T>());
  if (e != cudaSuccess) return (int)e;
  const long long tiles = (long long)n_mt * n_nt;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kern<<<grid, THREADS, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      amap, static_cast<const T*>(wp), M, N, nk, n_mt, n_nt, ep, out, ldo,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The constants the wrapper's weight layout and plain version follow:
// out = {rows a tile, columns a tile, K a stage, stages, shared memory
// bytes a block, row tiles a raster group, stages a run}.
int augment_fc_consts(int bf16, long long* out) {
  const long long f[7] = {BM,
                          BN,
                          kt<float>(),
                          Traits<float>::STAGES,
                          (long long)smem_bytes<float>(),
                          GROUP_M,
                          Traits<float>::RUN};
  const long long b[7] = {BM,
                          BN,
                          kt<__nv_bfloat16>(),
                          Traits<__nv_bfloat16>::STAGES,
                          (long long)smem_bytes<__nv_bfloat16>(),
                          GROUP_M,
                          Traits<__nv_bfloat16>::RUN};
  for (int i = 0; i < 7; ++i) out[i] = bf16 ? b[i] : f[i];
  return 0;
}

int augment_fc_f32(const void* x, long long ldx, int M, int K, const void* wp,
                   int N, const void* bias, const void* mean,
                   const void* rstd, const void* mask, long long mask_ld,
                   int mask_rows, void* out, long long ldo, void* stream) {
  return launch<float>(x, ldx, M, K, wp, N, bias, mean, rstd, mask, mask_ld,
                       mask_rows, out, ldo, stream);
}

int augment_fc_bf16(const void* x, long long ldx, int M, int K,
                    const void* wp, int N, const void* bias, const void* mean,
                    const void* rstd, const void* mask, long long mask_ld,
                    int mask_rows, void* out, long long ldo, void* stream) {
  return launch<__nv_bfloat16>(x, ldx, M, K, wp, N, bias, mean, rstd, mask,
                               mask_ld, mask_rows, out, ldo, stream);
}

}  // extern "C"
