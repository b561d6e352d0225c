// Fused reconstruction-loss forward: decoder output layer + ReLU + MSE +
// binarized-mismatch count, without materialising the (A, B, D)
// reconstruction.  Hand-written for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/recon_pallas.py `_fwd_kernel` (:72),
// launched by `_fwd` (:107, pallas_call at :118): the value-only forward of
// `fused_recon_mse` that eval, validation and alignment run.  Per arm a
//
//     sumsq_a = sum_{b,d} (relu(h_a W_a + bias_a) - x)^2
//     mism_a  = #{ (r > thr) != (x > thr) }
//
// Operands: h (A,B,F), W (A,F,D), bias (A,D), x (B,D) shared by every arm
// (arm stride 0) or per-arm (A,B,D); all f32 or all bf16, f32 accumulation.
// Output (A,2) f32: sumsq, mism.  Any F >= 1; B up to 65535 * 128 rows.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   2*A*B*F*D = 25.2 GFLOP: 0.0508 ms at the TF32 tensor-core peak (495
//   TFLOP/s; one TF32 product, the least work for f32 accuracy; the 3xTF32
//   split here does three, 0.153 ms), 0.0254 ms at the bf16 peak (989);
//   bytes read once, 121 MB f32 with shared x (0.036 ms at 3.35 TB/s) and
//   523 MB with per-arm x (0.156 ms), half that in bf16.
//
// Design, on the tensor cores through `wgmma` (csrc/wgmma.cuh):
//   1. `recon_fwd_prep` writes the operands once into a workspace, in the
//      layout the products read (K-major core matrices, no swizzle; K
//      padded with zeros to the product's k and cut into chunks, rows of h
//      to 128, columns of W to 64): h as 64-row tiles and W transposed, as
//      64-column tiles of W^T (a tf32 product reads both operands K-major).
//      f32 values are split there, once, into their tf32 halves hi + lo
//      (cvt.rna after tc::quiet_nan, so every NaN stays a NaN), where the
//      mma.sync kernels split each fragment in every warp that loads it;
//      bf16 values are copied as they are.  Production shape: 42,348,544
//      bytes of workspace in f32 (h 21,299,200, W^T 21,032,960, the block
//      partials 16,384), 11,413,504 in bf16.
//   2. `recon_fwd_tiles`, blocks (arm, 128-row block, slice of D) of two
//      consumer warpgroups (64 rows each) and one producer warp.  The arm
//      is the fastest grid index, so the A blocks of one row block and
//      slice run together and walk the same columns: a shared x tile comes
//      from HBM once and from L2 for the other arms (the TPU kernel's
//      "arms innermost" order).  When F's chunk fits (F <= 104 in f32, 416
//      in bf16) the h tile (hi and lo) stays in shared memory for the walk
//      and W^T tiles of 64 columns stream through a ring of mbarriers,
//      one bulk copy a stage, issued by the producer; else h chunks stream
//      beside them and K is walked in stages.  Each warpgroup runs
//      m64n64k8 tf32 products, three a k step (hi hi into one accumulator,
//      lo hi + hi lo into another: 3xTF32), or m64n64k16 bf16 products,
//      then the epilogue on its accumulators: bias, ReLU (NaN propagates),
//      squared error against x, mismatch count.  x comes into the ring
//      beside W^T as one TMA box of the tile (a 2-D tensor map, built
//      through the runtime's driver entry point, so no -lcuda) where its
//      rows are whole 16-byte runs and two such stages fit; else (f32 at
//      F = 100, rows not 16-byte aligned) the epilogue reads it from
//      global memory, issued while the products run, any alignment.  (One
//      bulk copy a row of the tile instead took 0.33 ms of bf16's 0.62:
//      128 small copies a tile.)  Shared memory, f32
//      at F = 100 (k chunk 104): h tile 106,496 bytes + two W^T stages of
//      53,248; bf16 (k 112): 28,672 + four stages of 14,336 (W^T) + 18,432
//      (x, 128 rows at a pitch of 72, so that the epilogue's reads fall on
//      distinct banks).
//   3. `recon_fwd_reduce`: the block partials (double and 64-bit integer,
//      summed in a fixed order inside each block) per arm in a fixed order.
// Rounding: the tensor cores round a sum toward zero; carried over the 13
// k steps of F = 104 in the two accumulators, the products stay within
// 5e-7 of f64 (numpy model, tests/test_torch_recon.py), so no run is
// summed apart.  Every sum runs in an order fixed by the shape: repeated
// launches are bit-identical, on any card.  Ragged B, D and F are zero
// padding in the workspace and masked in the epilogue: they contribute
// exactly 0.

#include <cuda.h>  // CUtensorMap and its enums; no driver library linked
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TR = 64;                 // rows (or columns) of a workspace tile
constexpr int BM = 2 * TR;             // rows a block: two warpgroups
constexpr int CONSUMERS = 256;         // two warpgroups
constexpr int THREADS = CONSUMERS + 32;  // and the producer warp
constexpr int MAX_STAGES = 4;
constexpr int SMEM_BUDGET = 225 * 1024;  // dynamic shared memory a block
// bytes a row of a k chunk may take (every plane): with the h tile resident
// (f32 k 104, bf16 416), and with h streaming beside W^T (64, 256)
constexpr int ROW_BYTES_RES = 832;
constexpr int ROW_BYTES_STREAM = 512;
// Block slots the slices of D fill: an H100 SXM's 132 SMs at one block an
// SM.  A constant, so that the plan, and with it the order of the sums,
// depends on the shape alone.
constexpr long long PLAN_SLOTS = 132;
constexpr int MAX_SPLIT = 8;
constexpr int REDUCE_THREADS = 256;
constexpr int MAX_ROW_BLOCKS = 65535;  // grid.y
// pitch (elements) of a staged x tile's rows: 64 + 8, so that the
// epilogue's reads of a warp fall on distinct banks (f32: two wavefronts
// of 64-bit reads, as few as they take)
constexpr int XP = TR + 8;

template <typename T>
struct Traits;
template <>
struct Traits<float> {
  static constexpr int PLANES = 2;  // tf32 hi and lo
  static constexpr int KS = 8;      // k of one product
};
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int PLANES = 1;
  static constexpr int KS = 16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// Everything of a launch that follows from the shape alone.
struct Plan {
  int kc, nk;          // k chunk (a multiple of KS) and chunks
  int rt, ct;          // 128-row blocks, 64-column tiles
  int n_split, tiles;  // slices of D and column tiles a slice
  int stages;
  int xs;              // x tiles staged in the ring, else read by the epilogue
  long long tile;      // elements of one workspace tile, every plane
  long long h_elems, w_elems;  // workspace elements of h and of W^T
  size_t smem;
};

inline long long align256(long long bytes) {
  return (bytes + 255) / 256 * 256;
}

template <typename T>
Plan make_plan(int A, int B, int F, int D) {
  constexpr int P = Traits<T>::PLANES, KS = Traits<T>::KS;
  constexpr int E = P * (int)sizeof(T);  // bytes a k value takes, planes
  Plan p;
  const int fk = cdiv(F, KS) * KS;
  if (fk * E <= ROW_BYTES_RES) {
    p.nk = 1;
    p.kc = fk;
  } else {
    p.nk = cdiv(fk, ROW_BYTES_STREAM / E);
    p.kc = cdiv(cdiv(fk, p.nk), KS) * KS;
  }
  p.rt = cdiv(B, BM);
  p.ct = cdiv(D, TR);
  // slices of D: the most even fill of whole waves of PLAN_SLOTS blocks,
  // counted in column tiles; ties to fewer slices; no empty slice
  double best = -1.0;
  p.n_split = 1;
  for (int s = 1; s <= MAX_SPLIT && s <= p.ct; ++s) {
    const int per = cdiv(p.ct, s);
    if ((long long)(s - 1) * per >= p.ct) continue;
    const long long blocks = (long long)A * p.rt * s;
    const long long waves = (blocks + PLAN_SLOTS - 1) / PLAN_SLOTS;
    const double eff =
        (double)A * p.rt * p.ct / (double)(waves * PLAN_SLOTS * per);
    if (eff > best + 1e-9) {
      best = eff;
      p.n_split = s;
    }
  }
  p.tiles = cdiv(p.ct, p.n_split);
  p.tile = (long long)TR * p.kc * P;
  p.h_elems = (long long)A * p.nk * (2LL * p.rt) * p.tile;
  p.w_elems = (long long)A * p.nk * p.ct * p.tile;
  const long long tb = p.tile * (long long)sizeof(T);
  const long long fixed = p.nk == 1 ? 2 * tb : 0;  // the resident h tile
  // x tiles go into the ring beside W^T when their rows are whole 16-byte
  // runs (a TMA box) and two stages of both fit
  const long long xb = (long long)BM * XP * (long long)sizeof(T);
  for (p.xs = ((long long)D * sizeof(T)) % 16 == 0; ; p.xs = 0) {
    const long long stage = (p.nk == 1 ? tb : 3 * tb) + (p.xs ? xb : 0);
    p.stages = (int)((SMEM_BUDGET - fixed) / stage);
    if (p.stages > MAX_STAGES) p.stages = MAX_STAGES;
    p.smem = (size_t)(fixed + p.stages * stage);
    if (p.stages >= 2 || !p.xs) break;
  }
  return p;
}

// The workspace: the prepared h, the prepared W^T, the block partials
// (double sums, then 64-bit counts), each at a multiple of 256 bytes.
struct Layout {
  long long h, w, sum, mism, bytes;
};

template <typename T>
Layout layout(int A, const Plan& p) {
  Layout l;
  const long long n_part = (long long)A * p.rt * p.n_split;
  l.h = 0;
  l.w = align256(p.h_elems * (long long)sizeof(T));
  l.sum = l.w + align256(p.w_elems * (long long)sizeof(T));
  l.mism = l.sum + align256(n_part * 8);
  l.bytes = l.mism + align256(n_part * 8);
  return l;
}

// ---------------------------------------------------------------------------
// 1. Prep: one thread a 16-byte group of the workspace (E16 k values of one
// row, every plane).  Tile t of chunk c of arm a holds the rows (or W's
// columns) 64 t.. and the k values kc c..; within a plane, element (r, k)
// of the tile lies at ((r / 8) (kc / E16) + k / E16) 8 + r % 8) E16 +
// k % E16.  The source element (row, k) is at src[a * arm + row * ld_row +
// k * ld_k]: h (ld_row F, ld_k 1), W as W^T (ld_row 1, ld_k D).
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
recon_fwd_prep(const T* __restrict__ src, long long arm, long long ld_row,
               long long ld_k, int rows, int F, int tiles, int kc, int nk,
               long long groups, T* __restrict__ dst) {
  constexpr int P = Traits<T>::PLANES;
  constexpr int E16 = 16 / (int)sizeof(T);
  const int kg_n = kc / E16;
  const long long plane = (long long)TR * kc;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += (long long)gridDim.x * blockDim.x) {
    long long q = i;
    const int rr = (int)(q % 8);
    q /= 8;
    const int kg = (int)(q % kg_n);
    q /= kg_n;
    const int rg = (int)(q % (TR / 8));
    q /= TR / 8;
    const int t = (int)(q % tiles);
    q /= tiles;
    const int c = (int)(q % nk);
    const long long a = q / nk;
    const int row = t * TR + rg * 8 + rr;
    const int k0 = c * kc + kg * E16;
    T* out = dst + ((a * nk + c) * tiles + t) * P * plane +
             ((long long)(rg * kg_n + kg) * 8 + rr) * E16;
    const T* s = src + a * arm + (long long)row * ld_row;
#pragma unroll
    for (int e = 0; e < E16; ++e) {
      const int k = k0 + e;
      const T v = (row < rows && k < F) ? s[(long long)k * ld_k] : T(0.f);
      if constexpr (P == 2) {
        uint32_t hi, lo;
        tc::split_tf32(tc::quiet_nan(v), hi, lo);
        out[e] = __uint_as_float(hi);
        out[plane + e] = __uint_as_float(lo);
      } else {
        out[e] = v;
      }
    }
  }
}

// The loss of one thread's 32 outputs of a column tile: y = acc (+ small,
// 3xTF32) + bias, r = relu(y) (NaN propagates), (r - x)^2 into sf[half]
// and, with MISM, [r > thr] != [x > thr] into mm; with MASK the outputs
// outside B x D (whose x may be stale) contribute exactly 0.
template <bool MISM, bool MASK, bool F32>
__device__ __forceinline__ void epilogue_f(const float (&big)[32],
                                           const float (&small)[32],
                                           const float (&xv)[8][2][2],
                                           const float (&bv)[8][2], int col0,
                                           int row0, int B, int D, float thr,
                                           float (&sf)[2], int& mm) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool col_ok = col0 + 8 * jj + e < D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * jj + 2 * half + e;
        const float y = (F32 ? big[i] + small[i] : big[i]) + bv[jj][e];
        const float r = (y < 0.f) ? 0.f : y;
        const float xe = xv[jj][half][e];
        float d = r - xe;
        bool ok = true;
        if (MASK) {
          ok = col_ok && row0 + 8 * half < B;
          d = ok ? d : 0.f;
        }
        sf[half] = fmaf(d, d, sf[half]);
        if (MISM) mm += (ok && ((r > thr) != (xe > thr))) ? 1 : 0;
      }
    }
}

// ---------------------------------------------------------------------------
// 2. Products and loss: grid (A, rt, n_split), THREADS threads.  Warps 0-7
// are the two consumer warpgroups (rows 64 w.. of the block), warp 8 the
// producer.  Iteration it = (column tile - first) * nk + chunk uses stage
// it % stages: full[s] completes when its bytes are in, empty[s] when both
// warpgroups' products on it are done.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
recon_fwd_tiles(const T* __restrict__ hw, const T* __restrict__ ww,
                const T* __restrict__ bias, const T* __restrict__ x,
                long long x_arm_stride, int B, int D, Plan pl, float thr,
                int with_mism, int xvec, const __grid_constant__ CUtensorMap
                xmap, double* __restrict__ part_sum,
                long long* __restrict__ part_mism) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int KS = Traits<T>::KS;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES], empty[MAX_STAGES], hbar;
  __shared__ double red_s[CONSUMERS / 32];
  __shared__ long long red_m[CONSUMERS / 32];

  const int a = blockIdx.x, rb = blockIdx.y;
  const int kc = pl.kc, nk = pl.nk, stages = pl.stages, xs = pl.xs;
  const long long tile = pl.tile;
  const bool resident = nk == 1;
  // resident: the h tile (2 tiles), then the stages at 2 tile; a stage is
  // [2 h tiles, unless resident][a W^T tile][x tile, if xs]
  T* const Hbuf = reinterpret_cast<T*>(smem_raw);
  T* const ring = Hbuf + (resident ? 2 * tile : 0);
  const long long w_off = resident ? 0 : 2 * tile, x_off = w_off + tile;
  const long long step = x_off + (xs ? (long long)BM * XP : 0);
  const int j0 = blockIdx.z * pl.tiles;
  const int j1 = min(pl.ct, j0 + pl.tiles);
  const int n_it = (j1 - j0) * nk;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* h_arm = hw + (long long)a * nk * (2LL * pl.rt) * tile;
  const T* w_arm = ww + (long long)a * nk * pl.ct * tile;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 2);
    }
    wg::mbar_init(&hbar, 1);
    wg::mbar_fence_init();
  }
  __syncthreads();

  double s_acc = 0.0;
  long long m_acc = 0;
  if (warp == CONSUMERS / 32) {
    // producer: one thread announces a stage's bytes and copies its tiles;
    // with xs the x box of the column tile (128 rows x 72 columns, read
    // through the tensor map xmap) comes with its last chunk
    const uint32_t tb = (uint32_t)(tile * sizeof(T));
    const uint32_t xb = (uint32_t)(BM * XP * sizeof(T));
    const int x_row = (x_arm_stride ? a * B : 0) + rb * BM;
    if (lane == 0) {
      if (resident) {
        wg::mbar_expect_tx(&hbar, 2 * tb);
        wg::bulk_load(Hbuf, h_arm + 2LL * rb * tile, 2 * tb, &hbar);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % stages;
        wg::mbar_wait(&empty[s], ((it / stages) & 1) ^ 1);
        const int j = j0 + it / nk, c = it % nk;
        T* st = ring + s * step;
        const bool with_x = xs && c == nk - 1;
        wg::mbar_expect_tx(&full[s],
                           (resident ? tb : 3 * tb) + (with_x ? xb : 0));
        if (!resident)
          wg::bulk_load(st, h_arm + ((long long)c * 2 * pl.rt + 2 * rb) * tile,
                        2 * tb, &full[s]);
        wg::bulk_load(st + w_off, w_arm + ((long long)c * pl.ct + j) * tile,
                      tb, &full[s]);
        if (with_x)
          wg::tensor_load_2d(st + x_off, &xmap, j * TR, x_row, &full[s]);
      }
    }
    __syncwarp();
  } else {
    const int wgi = warp >> 2;                 // the warpgroup: rows 64 wgi..
    const int gq = lane >> 2, tq = lane & 3;
    const int rl0 = wgi * TR + (warp & 3) * 16 + gq;  // and + 8, in the block
    const int row0 = rb * BM + rl0;
    const T* xa = x + (long long)a * x_arm_stride;
    const T* ba = bias + (long long)a * D;
    const uint32_t sbo = (uint32_t)(kc * sizeof(T) * 8);
    const long long plane = (long long)TR * kc;
    float big[32], small[32];
    if (resident) wg::mbar_wait(&hbar, 0);
    int it = 0;
    for (int j = j0; j < j1; ++j) {
#pragma unroll
      for (int i = 0; i < 32; ++i) big[i] = small[i] = 0.f;
      float xv[8][2][2], bv[8][2];
      int s = 0;
      for (int c = 0; c < nk; ++c, ++it) {
        s = it % stages;
        wg::mbar_wait(&full[s], (it / stages) & 1);
        const T* st = ring + s * step;
        const T* Hs = (resident ? Hbuf : st) + wgi * tile;
        const T* Ws = st + w_off;
        const uint64_t ah = wg::desc(Hs, 128, sbo), bh = wg::desc(Ws, 128, sbo);
        wg::fence_acc(big);
        if constexpr (F32) wg::fence_acc(small);
        wg::fence();
        for (int ks = 0; ks < kc / KS; ++ks) {
          const uint64_t o = (uint64_t)ks * (256 >> 4);  // 2 core matrices
          if constexpr (F32) {
            const uint64_t al = wg::desc(Hs + plane, 128, sbo);
            const uint64_t bl = wg::desc(Ws + plane, 128, sbo);
            wg::mma_tf32(big, ah + o, bh + o);
            wg::mma_tf32(small, al + o, bh + o);
            wg::mma_tf32(small, ah + o, bl + o);
          } else {
            wg::mma_bf16(big, ah + o, bh + o);
          }
        }
        wg::commit();
        if (c == nk - 1) {
          // the epilogue's bias, and without xs its x, loaded while the
          // products run
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int col = j * TR + 8 * jj + 2 * tq;
#pragma unroll
            for (int e = 0; e < 2; ++e)
              bv[jj][e] = col + e < D ? to_f32(ba[col + e]) : 0.f;
            if (xs) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              const int row = row0 + 8 * half;
              const T* xr = xa + (long long)row * D + col;
              if (row < B && xvec && col < D) {
                if constexpr (F32) {
                  const float2 v = __ldg(reinterpret_cast<const float2*>(xr));
                  xv[jj][half][0] = v.x;
                  xv[jj][half][1] = v.y;
                } else {
                  const __nv_bfloat162 v =
                      __ldg(reinterpret_cast<const __nv_bfloat162*>(xr));
                  xv[jj][half][0] = __low2float(v);
                  xv[jj][half][1] = __high2float(v);
                }
              } else {
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  xv[jj][half][e] =
                      row < B && col + e < D ? to_f32(xr[e]) : 0.f;
              }
            }
          }
        }
        wg::wait<0>();
        wg::fence_acc(big);
        if constexpr (F32) wg::fence_acc(small);
        // the stage is free once the products are done, or with xs once
        // the epilogue has read its x tile
        if ((tid & 127) == 0 && !(xs && c == nk - 1))
          wg::mbar_arrive(&empty[s]);
      }
      if (xs) {
        const T* Xs = ring + s * step + x_off;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const T* xr = Xs + (rl0 + 8 * half) * XP + 8 * jj + 2 * tq;
            if constexpr (F32) {
              const float2 v = *reinterpret_cast<const float2*>(xr);
              xv[jj][half][0] = v.x;
              xv[jj][half][1] = v.y;
            } else {
              const __nv_bfloat162 v =
                  *reinterpret_cast<const __nv_bfloat162*>(xr);
              xv[jj][half][0] = __low2float(v);
              xv[jj][half][1] = __high2float(v);
            }
          }
        wg::bar_sync(1 + wgi, 128);  // the warpgroup is done with the tile
        if ((tid & 127) == 0) wg::mbar_arrive(&empty[s]);
      }
      // epilogue: bias, ReLU, squared error and mismatch; the squared
      // errors summed in f32 by row half, then in double.  Branch-free, in
      // four compile-time forms (the edge masks only on an edge tile)
      float sf[2] = {0.f, 0.f};
      int mm = 0;
      const bool edge = (j + 1) * TR > D || row0 + 8 >= B;
      const int col0 = j * TR + 2 * tq;
      if (with_mism) {
        if (edge)
          epilogue_f<true, true, F32>(big, small, xv, bv, col0, row0, B, D,
                                      thr, sf, mm);
        else
          epilogue_f<true, false, F32>(big, small, xv, bv, col0, row0, B, D,
                                       thr, sf, mm);
      } else {
        if (edge)
          epilogue_f<false, true, F32>(big, small, xv, bv, col0, row0, B, D,
                                       thr, sf, mm);
        else
          epilogue_f<false, false, F32>(big, small, xv, bv, col0, row0, B,
                                        D, thr, sf, mm);
      }
      s_acc += (double)sf[0] + (double)sf[1];
      m_acc += mm;
    }
  }

  // block partial: warp sums, then the consumer warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s_acc += __shfl_down_sync(0xffffffffu, s_acc, off);
    m_acc += __shfl_down_sync(0xffffffffu, m_acc, off);
  }
  if (lane == 0 && warp < CONSUMERS / 32) {
    red_s[warp] = s_acc;
    red_m[warp] = m_acc;
  }
  __syncthreads();
  if (tid == 0) {
    double bs = 0.0;
    long long bm = 0;
    for (int i = 0; i < CONSUMERS / 32; ++i) {
      bs += red_s[i];
      bm += red_m[i];
    }
    const long long p =
        ((long long)a * gridDim.y + rb) * gridDim.z + blockIdx.z;
    part_sum[p] = bs;
    part_mism[p] = bm;
  }
}

// ---------------------------------------------------------------------------
// 3. One block per arm sums that arm's partials in a fixed order.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(REDUCE_THREADS)
recon_fwd_reduce(const double* __restrict__ part_sum,
                 const long long* __restrict__ part_mism, int n_per_arm,
                 float* __restrict__ out) {
  const int a = blockIdx.x;
  const int tid = threadIdx.x;
  double s = 0.0;
  long long m = 0;
  for (int i = tid; i < n_per_arm; i += REDUCE_THREADS) {
    s += part_sum[(long long)a * n_per_arm + i];
    m += part_mism[(long long)a * n_per_arm + i];
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

bool shape_ok(int A, int B, int F, int D) {
  return A >= 1 && A <= 65535 && B >= 1 && F >= 1 && D >= 1 &&
         cdiv(B, BM) <= MAX_ROW_BLOCKS && D <= 0x7fffffff - TR;
}

template <typename T>
int prep(const T* src, long long arm, long long ld_row, long long ld_k,
         int rows, int F, int tiles, const Plan& p, int A, T* dst,
         cudaStream_t st) {
  const long long groups =
      (long long)A * p.nk * tiles * TR * (p.kc / (16 / (int)sizeof(T)));
  long long blocks = (groups + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  recon_fwd_prep<T><<<(unsigned)blocks, 256, 0, st>>>(
      src, arm, ld_row, ld_k, rows, F, tiles, p.kc, p.nk, groups, dst);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, reached through the runtime's driver entry point
// (so the library needs no -lcuda); nullptr where the driver lacks it.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of x as a 2-D tensor (rows: B, or A * B for per-arm x; D
// columns) read in boxes of 128 rows x XP columns, so that a staged x tile
// keeps the pitch XP; 0 or a CUDA error.
template <typename T>
int x_tensor_map(CUtensorMap* m, const T* x, long long rows, int D) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)D * sizeof(T)};
  const cuuint32_t box[2] = {(cuuint32_t)XP, (cuuint32_t)BM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(
      m, std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      2, const_cast<T*>(x), dim, stride, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* h_, const void* w_, const void* bias_, const void* x_,
           long long x_arm_stride, int A, int B, int F, int D, float thr,
           int with_mism, void* ws_, void* out, void* stream) {
  if (!shape_ok(A, B, F, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  const T* x = static_cast<const T*>(x_);
  const Plan p = make_plan<T>(A, B, F, D);
  const Layout l = layout<T>(A, p);
  char* ws = static_cast<char*>(ws_);
  T* hw = reinterpret_cast<T*>(ws + l.h);
  T* ww = reinterpret_cast<T*>(ws + l.w);
  double* ps = reinterpret_cast<double*>(ws + l.sum);
  long long* pm = reinterpret_cast<long long*>(ws + l.mism);
  int err = prep<T>(h, (long long)B * F, F, 1, B, F, 2 * p.rt, p, A, hw, st);
  if (err) return err;
  err = prep<T>(w, (long long)F * D, 1, D, D, F, p.ct, p, A, ww, st);
  if (err) return err;
  // x as pairs: 2-element loads need an even D and aligned rows
  const int xvec = D % 2 == 0 && x_arm_stride % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % (2 * sizeof(T)) == 0;
  Plan pk = p;  // x staged only if every row starts on 16 bytes
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      (x_arm_stride * (long long)sizeof(T)) % 16 != 0)
    pk.xs = 0;
  const long long x_rows = x_arm_stride ? (long long)A * B : B;
  if (x_rows > 0x7fffffff - BM) pk.xs = 0;  // the box's row coordinate
  CUtensorMap xmap = {};
  if (pk.xs) {
    const int rc = x_tensor_map<T>(&xmap, x, x_rows, D);
    if (rc) return rc;
  }
  auto kern = recon_fwd_tiles<T>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(A, p.rt, p.n_split);
  kern<<<grid, THREADS, p.smem, st>>>(
      hw, ww, static_cast<const T*>(bias_), x, x_arm_stride, B, D, pk, thr,
      with_mism, xvec, xmap, ps, pm);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  recon_fwd_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      ps, pm, p.rt * p.n_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of the workspace a launch of the shape needs (its layout above);
// -1 if the shape is refused.
long long recon_fwd_workspace_bytes(int A, int B, int F, int D, int bf16) {
  if (!shape_ok(A, B, F, D)) return -1;
  if (bf16)
    return layout<__nv_bfloat16>(A, make_plan<__nv_bfloat16>(A, B, F, D))
        .bytes;
  return layout<float>(A, make_plan<float>(A, B, F, D)).bytes;
}

// The plan of the shape: out = {k chunk, chunks, row blocks, column tiles,
// slices of D, column tiles a slice, stages, x staged, shared memory
// bytes}.  0, or -1 if the shape is refused.
int recon_fwd_plan(int A, int B, int F, int D, int bf16, long long* out) {
  if (!shape_ok(A, B, F, D)) return -1;
  const Plan p = bf16 ? make_plan<__nv_bfloat16>(A, B, F, D)
                      : make_plan<float>(A, B, F, D);
  const long long v[9] = {p.kc, p.nk, p.rt, p.ct, p.n_split, p.tiles,
                          p.stages, p.xs, (long long)p.smem};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Largest row count one launch takes (grid.y limit).
long long recon_fwd_max_rows() { return (long long)MAX_ROW_BLOCKS * BM; }

int recon_fwd_f32(const void* h, const void* w, const void* bias,
                  const void* x, long long x_arm_stride, int A, int B, int F,
                  int D, float thr, int with_mism, void* ws, void* out,
                  void* stream) {
  return launch<float>(h, w, bias, x, x_arm_stride, A, B, F, D, thr,
                       with_mism, ws, out, stream);
}

int recon_fwd_bf16(const void* h, const void* w, const void* bias,
                   const void* x, long long x_arm_stride, int A, int B, int F,
                   int D, float thr, int with_mism, void* ws, void* out,
                   void* stream) {
  return launch<__nv_bfloat16>(h, w, bias, x, x_arm_stride, A, B, F, D, thr,
                               with_mism, ws, out, stream);
}

}  // extern "C"
