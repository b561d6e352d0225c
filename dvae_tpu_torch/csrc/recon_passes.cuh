// The two passes of the fused reconstruction loss's forward and backward
// on the tensor cores: kernel #2 (recon_fwdbwd.cu: the training call, and
// #3, its separate backward) and the output layer of the whole-decoder
// kernels #12 and #13 (decoder.cu, which run them on the trunk's last
// activation: the value-only form of pass 1 for #12, every pass for #13).
// Device code and the host-side plan and launch sequence; each source that
// includes it builds its own library, so dW and db of #13 equal #2's bit
// for bit on the same h.
//
// Design.  dh reduces over D and dW over B, so no single tiling finishes
// both without an (A,B,D)-sized scratch (about 400 MB of partials here).
// Two passes instead, each deterministic, both on the tensor cores
// (`mma.sync`, csrc/mma.cuh: 3xTF32 m16n8k8 for f32 operands, m16n8k16
// for bf16, f32 accumulation):
//   pass 1, `recon_rows`, blocks (64-row tile, arm, slice of D) of 4 warps,
//     each warp 16 rows, walking the slice 32 columns a step: the h tile
//     stays in shared memory for the walk; W and x tiles stream in by
//     cp.async in a ring of two stages; y = h W (K = F) for the warp's 16 x
//     32 outputs, the loss partials in registers, gm taken straight from
//     the y accumulators as the A fragments of dh += gm W^T (K = the step's
//     32 columns; for tf32 the k order of each 8 columns permuted to
//     (0,2,4,6,1,3,5,7) on both sides, so that the accumulator layout is
//     the A layout), the same W stage read both ways; dh kept in registers
//     along the slice.  The slices (2 at the production shape; `plan`, from
//     the shape and a fixed count of block slots, so that the grid fills
//     whole waves of an H100: 790 blocks on 264 slots) each leave a dh
//     partial: slice 0 into dh, the others into the dW buffer, which pass 2
//     overwrites afterwards; `recon_dh_reduce` adds them in slice order.
//     Two blocks an SM;
//   pass 2, `recon_cols`, blocks (64-column tile, arm) of 8 warps walking
//     every 64-row tile of B, h and x tiles by cp.async in a ring of three
//     (f32) or four (bf16) stages, the W tile resident for the walk: warp w
//     owns 32 columns, and of those y (recomputed) for 16 rows of each
//     step and dW for the hidden units 32 (w % 4)..; gm rounded to h's type
//     into shared memory between the two, db summed in f32 in registers; dW
//     += h^T gm with h read transposed (the row order of each 8 permuted as
//     above, so that a warp's loads fall on 32 banks), no sum across warps.
//     One block an SM: the 395 blocks of the production shape are 2.99
//     waves of 132, and each h tile serves 64 columns.
// f32 operands are split into tf32 halves by each warp on the fragments it
// loads, with integer rounding (mma.cuh split_tf32_bits: the bits of
// cvt.rna, faster than cvt.rna here; scripts/torch_kernel_variants.py
// recon_split, and recon_ablate for where the time goes; PERF.md §6).
// That split turns the card's own NaN (0x7FFFFFFF) into -0, so in f32 the
// passes read copies of h and W with every NaN quiet (`quiet_copy`,
// below), and the cotangent gm that they compute and split (a NaN of x
// gives it the card's NaN) is made quiet first (tc::quiet_nan).
// Sums of the tensor cores round toward zero, so runs of a few mma are
// summed from zero and added to the long-lived accumulators rounded to
// nearest (tc::add4): y four k steps of 8 (f32), dh one step's 32
// columns, dW 32 rows.  The loss partials of the blocks are reduced per
// arm in a fixed order (double and 64-bit integer).  Every sum runs in an
// order that depends on the shape alone, so repeated launches are
// bit-identical, on any card.
//
// Any F up to the shared memory's limit (max_f: 512 f32, 1,296 bf16 with
// dh; 656 and 1,552 value-only).  F <= FP (128) runs the forms above.  A
// wider F runs the wide forms (template flag WIDE), which walk F in
// chunks of KC = 128 as kernel #1 does:
//   pass 1 keeps the whole h tile resident and streams W by chunk: a step
//     is NK = ceil(F/128) stages of W rows (y summed over every chunk, in
//     the same runs as one long K), then one more stage of x and the W
//     rows of the block's own chunk of dh; the grid's z axis is (chunk of
//     dh, slice of D), each block recomputes y and keeps 16 tiles of dh in
//     registers, and only chunk 0 writes the loss partials;
//   pass 2 keeps the whole (F, 64) W tile resident (the limit on F) and
//     streams h by chunk: NK stages of h for y, then the h chunk of the
//     block's dW rows and x, which the cotangents overwrite in place; the
//     grid's z axis is the chunk of dW, and only chunk 0 writes db.
// Both recompute y once a chunk: a simple form, its time in PERF.md §6.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KS = 8;     // k of one mma (tf32)
  static constexpr int HPAD = 4;   // h pitches: padded F + HPAD
  static constexpr int LDW1 = 40;  // pass-1 W stage pitch
  static constexpr int LDW2 = 72;  // pass-2 resident W tile
  static constexpr int LDG = 68;   // pass-2 cotangent tile
  static constexpr int STAGES2 = 3;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int KS = 16;
  static constexpr int HPAD = 8;
  static constexpr int LDW1 = 40;
  static constexpr int LDW2 = 72;
  static constexpr int LDG = 72;
  static constexpr int STAGES2 = 4;
};
// The pitches keep every fragment load of a warp on 32 distinct banks (or
// 8 distinct 16-byte groups for ldmatrix).

constexpr int THREADS = 128;         // pass 1: 4 warps
constexpr int BM1 = 64, BN1 = 32;    // pass 1: rows a block, columns a step
constexpr int LDX1 = 40;             // pass-1 x tile pitch
constexpr int THREADS2 = 256;        // pass 2: 8 warps
constexpr int BN2 = 64, BM2 = 64;    // pass 2: columns a block, rows a step
constexpr int LDX2 = 72;             // pass-2 x tile pitch
constexpr int FP = 128;              // largest F of the resident forms
constexpr int KC = 128;              // the wide forms' chunk of F
constexpr int MAX_SPLIT = 8;
// dynamic shared memory a block may take on an H100
constexpr int SMEM_MAX = 232448;
// Block slots the row plan fills: an H100 SXM's 132 SMs at two blocks an
// SM.  A constant, not the card's count, so that the plan, and with it the
// order of the dh and loss sums, depends on the shape alone.
constexpr long long PLAN_SLOTS = 132 * 2;
constexpr int REDUCE_THREADS = 256;
// f32 y products: k steps of 8 summed apart before they join the
// accumulator (tc::add4)
constexpr int RUN_K = 4;

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// F rounded to the k of one mma: the depth of the y products
template <typename T>
__host__ __device__ inline int fk(int F) {
  return round_up(F, Cfg<T>::KS);
}

// chunks of KC the wide forms cut F into
__host__ __device__ inline int n_chunks(int F) { return (F + KC - 1) / KC; }
// rows of W a pass-1 stage holds: all of F, or one chunk in the wide form
template <typename T>
__host__ __device__ inline int stage1_rows(int F, bool wide) {
  return wide ? KC : fk<T>(F);
}
template <typename T>
__host__ __device__ inline int stage1_elems(int F, bool wide) {
  return stage1_rows<T>(F, wide) * Cfg<T>::LDW1 + BM1 * LDX1;
}
template <typename T>
size_t smem_rows(int F, bool wide = false) {
  return sizeof(T) * ((size_t)BM1 * (fk<T>(F) + Cfg<T>::HPAD) +
                      2 * (size_t)stage1_elems<T>(F, wide));
}
// FT, the 8-wide tiles of F that dh covers (13 for F <= 104, else 16),
// fixes the loop bounds at compile time: the deepest y product and, in
// pass 2, the hidden units of the h stage (the dW m-tiles of 16).
template <typename T, int FT>
__host__ __device__ constexpr int kmax() {
  return std::is_same<T, float>::value ? 8 * FT : (8 * FT + 15) / 16 * 16;
}
template <int FT>
__host__ __device__ constexpr int hcols() {
  return (8 * FT + 15) / 16 * 16;
}
template <typename T, int FT>
__host__ __device__ constexpr int stage2_elems() {
  return BM2 * (hcols<FT>() + Cfg<T>::HPAD + LDX2);
}
template <typename T, int FT>
size_t smem_cols(int F) {
  return sizeof(T) * ((size_t)fk<T>(F) * Cfg<T>::LDW2 +
                      (size_t)Cfg<T>::STAGES2 * stage2_elems<T, FT>() +
                      (size_t)BM2 * Cfg<T>::LDG);
}
// The wide pass 2: the W tile of every F, a ring of two h chunks, and the
// x tile that the cotangents overwrite in place.
template <typename T>
__host__ __device__ constexpr int ldh_wide() {
  return KC + Cfg<T>::HPAD;
}
template <typename T>
size_t smem_cols_wide(int F) {
  return sizeof(T) * ((size_t)fk<T>(F) * Cfg<T>::LDW2 +
                      2 * (size_t)BM2 * ldh_wide<T>() +
                      (size_t)BM2 * Cfg<T>::LDG);
}
// Largest F the passes take: every F up to FP, and beyond it the wide
// forms while their shared memory fits a block (pass 2's resident W tile
// sets the limit with dh; pass 1's resident h tile without).
template <typename T>
int max_f(bool dh) {
  int f = FP;
  for (int g = FP + Cfg<T>::KS;; g += Cfg<T>::KS) {
    if (smem_rows<T>(g, true) + 64 > (size_t)SMEM_MAX) break;
    if (dh && smem_cols_wide<T>(g) > (size_t)SMEM_MAX) break;
    f = g;
  }
  return f;
}

// Where the dh partial of slice s goes: slice 0 into dh itself, the others
// into the dW buffer (pass 2 overwrites it afterwards).
struct Partials {
  float* dh;
  float* in_dw;
  long long stride;  // A * B * F
  __device__ float* part(int s) const {
    return s == 0 ? dh : in_dw + (long long)(s - 1) * stride;
  }
};

// ---------------------------------------------------------------------------
// Pass 1: grid (ceil(B/BM1), A, n_split), in the wide form (ceil(B/BM1), A,
// n_split * chunks of dh).  Loss partials (unless SEPARATE) and, with DH,
// dh; FT: the number of 8-wide tiles of F the dh accumulators cover (and
// the depth bound of y a chunk).  Without DH (the value-only form) no dh
// product and no dh partial: the same y products, loss epilogue and
// partials, so its sums equal the training form's bit for bit.  A step is
// NS stages of the ring: one (W of all F and x) in the resident form; in
// the wide form NK chunks of W for y, then x and the block's dh chunk of W.
// ---------------------------------------------------------------------------
template <typename T, bool SEPARATE, int FT, bool DH, bool WIDE>
__global__ void __launch_bounds__(THREADS, 2)
recon_rows(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ bias, const T* __restrict__ x,
           long long x_arm_stride, const float* __restrict__ g, int B, int F,
           int D, int cols_per_split, int n_split, float thr, int with_mism,
           int vec_h, int vec_d, float* __restrict__ part_sum,
           int* __restrict__ part_mism, Partials dhp) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int NJ = BN1 / 8;  // n-tiles of y a step
  constexpr int KMAX = kmax<T, FT>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int FK = fk<T>(F);
  const int LDH = FK + C::HPAD;
  const int KW = stage1_rows<T>(F, WIDE);  // rows of W a stage
  const int w_elems = KW * C::LDW1;
  const int stage_elems = stage1_elems<T>(F, WIDE);
  T* const Hs = sm;
  T* const stages = sm + BM1 * LDH;

  const int a = blockIdx.y;
  const int m0 = blockIdx.x * BM1;
  const int split = WIDE ? blockIdx.z % n_split : blockIdx.z;
  const int fc = WIDE ? blockIdx.z / n_split : 0;  // the block's dh chunk
  const int NK = WIDE ? n_chunks(FK) : 1;          // chunks of y a step
  const int NS = WIDE ? NK + 1 : 1;                // stages a step
  // rows of W in the dh chunk
  const int fk_dh = WIDE ? min(KC, FK - KC * fc) : FK;
  const int d_begin = split * cols_per_split;
  const int d_end = min(D, d_begin + cols_per_split);
  const int nsteps = d_end > d_begin ? (d_end - d_begin + BN1 - 1) / BN1 : 0;
  const int nq = nsteps * NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const T* wa = w + (long long)a * F * D;
  const T* ba = bias + (long long)a * D;
  const T* xa = x + (long long)a * x_arm_stride;
  const float two_g = SEPARATE ? 2.f * g[a] : 2.f;

  auto issue = [&](int q) {
    T* st = stages + (q & 1) * stage_elems;
    const int step = WIDE ? q / NS : q, j = WIDE ? q % NS : 0;
    const int col0 = d_begin + step * BN1;
    if (j < NK || DH) {  // the chunk j of W, or the dh chunk's
      const int k0 = WIDE ? KC * (j < NK ? j : fc) : 0;
      tc::load_tile_c<BN1, THREADS>(st, C::LDW1, wa + (long long)k0 * D + col0,
                                    D, KW, F - k0, D - col0, vec_d, tid);
    }
    if (j == NS - 1)
      tc::load_tile_c<BN1, THREADS>(st + w_elems, LDX1,
                                    xa + (long long)m0 * D + col0, D, BM1,
                                    B - m0, D - col0, vec_d, tid);
  };

  tc::load_tile(Hs, LDH, h + ((long long)a * B + m0) * F, F, BM1, FK, B - m0,
                F, vec_h, tid, THREADS);
  if (nq > 0) issue(0);
  tc::cp_commit();

  float dacc[FT][4];
#pragma unroll
  for (int n = 0; n < FT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dacc[n][i] = 0.f;
  float s = 0.f;
  int mm = 0;
  float acc[NJ][4];  // y of the warp's 16 rows and the step's 32 columns

  for (int q = 0; q < nq; ++q) {
    tc::cp_wait<0>();
    __syncthreads();  // this stage's tiles are in; the other buffer is free
    if (q + 1 < nq) issue(q + 1);
    tc::cp_commit();
    const T* Ws = stages + (q & 1) * stage_elems;
    const T* Xs = Ws + w_elems;
    const int step = WIDE ? q / NS : q, j = WIDE ? q % NS : 0;
    const int col0 = d_begin + step * BN1;

    if (j == 0) {
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[jj][i] = 0.f;
    }
    if (j < NK) {
      // y += h W over the chunk's k: columns hk.. of the h tile, the rows
      // of the stage
      const int hk = KC * j;
      const int kend = WIDE ? min(KC, FK - hk) : FK;
      if constexpr (F32) {
#pragma unroll
        for (int k0 = 0; k0 < KMAX; k0 += 8 * RUN_K) {
          if (k0 >= kend) break;
          float run[NJ][4];  // a run of RUN_K k steps, summed apart
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) tc::zero4(run[jj]);
#pragma unroll
          for (int r = 0; r < RUN_K; ++r) {
            const int kk = k0 + 8 * r;
            if (kk < kend) {
              const float* hr = Hs + (r0 + gq) * LDH + hk + kk + tq;
              const tc::SplitA Af =
                  tc::split_a_bits(hr[0], hr[8 * LDH], hr[4], hr[8 * LDH + 4]);
#pragma unroll
              for (int jj = 0; jj < NJ; ++jj) {
                const float* wc = Ws + (kk + tq) * C::LDW1 + 8 * jj + gq;
                tc::mma_3xtf32(run[jj], run[jj], Af,
                               tc::split_b_bits(wc[0], wc[4 * C::LDW1]));
              }
            }
          }
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) tc::add4(acc[jj], run[jj]);
        }
      } else {
        const int qd = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < KMAX; kk += 16) {
          if (kk >= kend) break;
          const T* hr = Hs + (r0 + gq) * LDH + hk + kk + 2 * tq;
          const uint32_t Af[4] = {tc::ld_u32(hr), tc::ld_u32(hr + 8 * LDH),
                                  tc::ld_u32(hr + 8),
                                  tc::ld_u32(hr + 8 * LDH + 8)};
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p) {
            uint32_t b[4];
            tc::ldsm_x4_t(b, Ws + (kk + (qd & 1) * 8 + (lane & 7)) * C::LDW1 +
                                 16 * p + (qd >> 1) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            tc::mma_bf16(acc[2 * p], Af, b0);
            tc::mma_bf16(acc[2 * p + 1], Af, b1);
          }
        }
      }
    }
    if (j != NS - 1) continue;

    // loss epilogue: the accumulators become gm (f32) in place
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * jj + 2 * tq + e;
        const int col = col0 + cl;
        const bool col_ok = col < D;
        const float bj = col_ok ? to_f32(ba[col]) : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = r0 + gq + 8 * half;
          const int i = half * 2 + e;
          float gmv = 0.f;
          if (col_ok && m0 + rl < B) {
            const float y = acc[jj][i] + bj;
            const float r = (y < 0.f) ? 0.f : y;  // NaN propagates, like relu
            const float xv = to_f32(Xs[rl * LDX1 + cl]);
            const float d = r - xv;
            s = fmaf(d, d, s);
            if (with_mism) mm += ((r > thr) != (xv > thr)) ? 1 : 0;
            gmv = (r > 0.f) ? two_g * d : 0.f;
            // a NaN of x reaches gm as the card's NaN, which the split of
            // dh's product would drop: stored quiet (tc::quiet_nan)
            if constexpr (F32 && DH) gmv = tc::quiet_nan(gmv);
          }
          acc[jj][i] = gmv;
        }
      }
    }

    // dh += gm W^T, gm as A fragments; each step's 32 columns are summed
    // apart and then added (tc::add4)
    if constexpr (!DH) {
    } else if constexpr (F32) {
      // k slot t <-> column 2t, slot t+4 <-> column 2t+1 of each 8
      tc::SplitA Ag[NJ];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
        Ag[jj] = tc::split_a_bits(acc[jj][0], acc[jj][2], acc[jj][1],
                                  acc[jj][3]);
#pragma unroll
      for (int n = 0; n < FT; ++n) {
        if (8 * n < fk_dh) {
          float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const float2 wv = *reinterpret_cast<const float2*>(
                Ws + (8 * n + gq) * C::LDW1 + 8 * jj + 2 * tq);
            tc::mma_3xtf32(t, u, Ag[jj], tc::split_b_bits(wv.x, wv.y));
          }
          tc::add4(dacc[n], t, u);
        }
      }
    } else {
      uint32_t Ag[NJ / 2][4];  // gm rounded to bf16, 16 columns a k step
#pragma unroll
      for (int p = 0; p < NJ / 2; ++p) {
        Ag[p][0] = tc::pack_bf16(acc[2 * p][0], acc[2 * p][1]);
        Ag[p][1] = tc::pack_bf16(acc[2 * p][2], acc[2 * p][3]);
        Ag[p][2] = tc::pack_bf16(acc[2 * p + 1][0], acc[2 * p + 1][1]);
        Ag[p][3] = tc::pack_bf16(acc[2 * p + 1][2], acc[2 * p + 1][3]);
      }
#pragma unroll
      for (int n = 0; n < FT; ++n) {
        if (8 * n < fk_dh) {
          float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p) {
            const T* wr = Ws + (8 * n + gq) * C::LDW1 + 16 * p + 2 * tq;
            const uint32_t b[2] = {tc::ld_u32(wr), tc::ld_u32(wr + 8)};
            tc::mma_bf16(t, Ag[p], b);
          }
          tc::add4(dacc[n], t);
        }
      }
    }
  }

  tc::cp_wait<0>();  // nothing in flight when the block ends

  if constexpr (DH) {  // this slice's dh partial, of the block's chunk
    float* dst = dhp.part(split) + (long long)a * B * F;
#pragma unroll
    for (int n = 0; n < FT; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + r0 + gq + 8 * half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = KC * fc + 8 * n + 2 * tq + e;
          if (row < B && f < F)
            dst[(long long)row * F + f] = dacc[n][half * 2 + e];
        }
      }
    }
  }

  // the separate backward writes no sums; in the wide form chunk 0 does
  if (SEPARATE || fc != 0) return;
  // block reduction of the loss partials in a fixed order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    mm += __shfl_down_sync(0xffffffffu, mm, off);
  }
  __shared__ float warp_s[THREADS / 32];
  __shared__ int warp_m[THREADS / 32];
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
        ((long long)a * gridDim.x + blockIdx.x) * n_split + split;
    part_sum[p] = bs;
    part_mism[p] = bm;
  }
}

// dh = the slices' partials added in slice order.
__global__ void recon_dh_reduce(Partials p, int n_split, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = p.dh[i];
  for (int s = 1; s < n_split; ++s) v += p.part(s)[i];
  p.dh[i] = v;
}

// ---------------------------------------------------------------------------
// Pass 2: grid (ceil(D/BN2), A), in the wide form (ceil(D/BN2), A, chunks
// of dW).  dW and db of one column tile.  Warp w owns the columns 32 (w /
// 4).. of the tile; of those it computes y for the rows 16 (w % 4).. of
// each 64-row step and dW for the hidden units 32 (w % 4).. (of the
// block's chunk in the wide form).  A step is NS stages of the ring: one
// (h of all F and x) in the resident form; in the wide form NK chunks of h
// for y, then the h chunk of the block's dW rows, with x into the
// cotangent tile.
// ---------------------------------------------------------------------------
template <typename T, bool SEPARATE, int FT, bool WIDE>
__global__ void __launch_bounds__(THREADS2, 1)
recon_cols(const T* __restrict__ h, const T* __restrict__ w,
           const T* __restrict__ bias, const T* __restrict__ x,
           long long x_arm_stride, const float* __restrict__ g, int B, int F,
           int D, int vec_h, int vec_d, float* __restrict__ dw,
           float* __restrict__ db) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int S = WIDE ? 2 : C::STAGES2;
  constexpr int NJ = 4;  // n-tiles of a warp's y and dW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int FK = fk<T>(F);
  constexpr int HC = WIDE ? KC : hcols<FT>();  // h columns a stage holds
  constexpr int KMAX = kmax<T, FT>();
  constexpr int LDH = HC + C::HPAD;
  // x lies in the stage, or (wide) in the cotangent tile it turns into
  constexpr int LDX = WIDE ? C::LDG : LDX2;
  constexpr int stage_elems = WIDE ? BM2 * LDH : stage2_elems<T, FT>();
  T* const Ws = sm;  // the block's W tile, loaded once
  T* const stages = Ws + FK * C::LDW2;
  T* const Gs = stages + S * stage_elems;  // the cotangent tile

  const int a = blockIdx.y;
  const int n0 = blockIdx.x * BN2;
  const int fc = WIDE ? blockIdx.z : 0;  // the block's chunk of dW rows
  const int NK = WIDE ? n_chunks(FK) : 1;
  const int NS = WIDE ? NK + 1 : 1;
  const int nsteps = (B + BM2 - 1) / BM2;
  const int nq = nsteps * NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wr = warp & 3, c0 = 32 * (warp >> 2);  // the warp's columns
  const int r0 = 16 * wr;  // the warp's rows of a step (y)
  const int f0 = 32 * wr;  // the warp's hidden units (dW), in the chunk
  const bool has_m0 = KC * fc + f0 < F, has_m1 = KC * fc + f0 + 16 < F;
  const T* ha = h + (long long)a * B * F;
  const T* xa = x + (long long)a * x_arm_stride;
  const float two_g = SEPARATE ? 2.f * g[a] : 2.f;

  auto issue = [&](int q) {
    T* st = stages + (q % S) * stage_elems;
    const int step = WIDE ? q / NS : q, j = WIDE ? q % NS : 0;
    const int m0 = step * BM2;
    const int hk = WIDE ? KC * (j < NK ? j : fc) : 0;
    tc::load_tile_c<HC, THREADS2>(st, LDH, ha + (long long)m0 * F + hk, F,
                                  BM2, B - m0, F - hk, vec_h, tid);
    if (j == NS - 1)
      tc::load_tile_c<BN2, THREADS2>(WIDE ? Gs : st + BM2 * LDH, LDX,
                                     xa + (long long)m0 * D + n0, D, BM2,
                                     B - m0, D - n0, vec_d, tid);
  };
  tc::load_tile_c<BN2, THREADS2>(Ws, C::LDW2, w + (long long)a * F * D + n0,
                                 D, FK, F, D - n0, vec_d, tid);
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < nq) issue(p);
    tc::cp_commit();
  }

  float bj[NJ][2];  // bias of the lane's columns
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + c0 + 8 * j + 2 * tq + e;
      bj[j][e] = col < D ? to_f32(bias[(long long)a * D + col]) : 0.f;
    }
  float wacc[2][NJ][4];  // dW: hidden units f0 + 16 mi.., columns 8 n..
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < NJ; ++n) tc::zero4(wacc[mi][n]);
  float dbp[NJ][2];
#pragma unroll
  for (int j = 0; j < NJ; ++j) dbp[j][0] = dbp[j][1] = 0.f;
  float acc[NJ][4];  // y of the warp's 16 rows and 32 columns

  for (int q = 0; q < nq; ++q) {
    tc::cp_wait<S - 2>();
    __syncthreads();  // tiles in; the freed buffer and Gs may be rewritten
    if (q + S - 1 < nq) issue(q + S - 1);
    tc::cp_commit();
    const T* Hs = stages + (q % S) * stage_elems;
    const T* Xs = WIDE ? Gs : Hs + BM2 * LDH;
    const int step = WIDE ? q / NS : q, sj = WIDE ? q % NS : 0;
    const int m0 = step * BM2;

    if (sj == 0) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) tc::zero4(acc[j]);
    }
    if (sj < NK) {
      // y += h W over the chunk's k: the stage's columns, W's rows wk..
      const int wk = KC * sj;
      const int kend = WIDE ? min(KC, FK - wk) : FK;
      if constexpr (F32) {
#pragma unroll
        for (int k0 = 0; k0 < KMAX; k0 += 8 * RUN_K) {
          if (k0 >= kend) break;
          float run[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j) tc::zero4(run[j]);
#pragma unroll
          for (int r = 0; r < RUN_K; ++r) {
            const int kk = k0 + 8 * r;
            if (kk < kend) {
              const float* hr = Hs + (r0 + gq) * LDH + kk + tq;
              const tc::SplitA Af =
                  tc::split_a_bits(hr[0], hr[8 * LDH], hr[4], hr[8 * LDH + 4]);
#pragma unroll
              for (int j = 0; j < NJ; ++j) {
                const float* wc =
                    Ws + (wk + kk + tq) * C::LDW2 + c0 + 8 * j + gq;
                tc::mma_3xtf32(run[j], run[j], Af,
                               tc::split_b_bits(wc[0], wc[4 * C::LDW2]));
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NJ; ++j) tc::add4(acc[j], run[j]);
        }
      } else {
        const int qd = lane >> 3;
#pragma unroll
        for (int kk = 0; kk < KMAX; kk += 16) {
          if (kk >= kend) break;
          const T* hr = Hs + (r0 + gq) * LDH + kk + 2 * tq;
          const uint32_t Af[4] = {tc::ld_u32(hr), tc::ld_u32(hr + 8 * LDH),
                                  tc::ld_u32(hr + 8),
                                  tc::ld_u32(hr + 8 * LDH + 8)};
#pragma unroll
          for (int p = 0; p < NJ / 2; ++p) {
            uint32_t b[4];
            tc::ldsm_x4_t(b, Ws + (wk + kk + (qd & 1) * 8 + (lane & 7)) *
                                     C::LDW2 +
                                 c0 + 16 * p + (qd >> 1) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            tc::mma_bf16(acc[2 * p], Af, b0);
            tc::mma_bf16(acc[2 * p + 1], Af, b1);
          }
        }
      }
    }
    if (sj != NS - 1) continue;

    // gm; db from the f32 values; the values rounded to h's type to Gs
    // (in the wide form over the x they were made from, element by element)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int cl0 = c0 + 8 * j + 2 * tq;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = r0 + gq + 8 * half;
        float xv[2];
        if constexpr (F32) {
          const float2 v = *reinterpret_cast<const float2*>(Xs + rl * LDX + cl0);
          xv[0] = v.x;
          xv[1] = v.y;
        } else {
          const __nv_bfloat162 v =
              *reinterpret_cast<const __nv_bfloat162*>(Xs + rl * LDX + cl0);
          xv[0] = __low2float(v);
          xv[1] = __high2float(v);
        }
        float gv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          gv[e] = 0.f;
          if (m0 + rl < B && n0 + cl0 + e < D) {
            const float y = acc[j][half * 2 + e] + bj[j][e];
            const float r = (y < 0.f) ? 0.f : y;
            const float d = r - xv[e];
            gv[e] = (r > 0.f) ? two_g * d : 0.f;
          }
          dbp[j][e] += gv[e];
        }
        if constexpr (F32)  // quiet, for dW's split; db sums gv as is
          *reinterpret_cast<float2*>(Gs + rl * C::LDG + cl0) =
              make_float2(tc::quiet_nan(gv[0]), tc::quiet_nan(gv[1]));
        else
          *reinterpret_cast<uint32_t*>(Gs + rl * C::LDG + cl0) =
              tc::pack_bf16(gv[0], gv[1]);
      }
    }
    __syncthreads();  // Gs complete

    // dW[f][col] += sum_rows h[row][f] gm[row][col]; each run of 32 rows
    // is summed apart and then added (tc::add4)
    if (has_m0) {
#pragma unroll
      for (int run0 = 0; run0 < BM2; run0 += 32) {
        float t[2][NJ][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int n = 0; n < NJ; ++n) tc::zero4(t[mi][n]);
        if constexpr (F32) {
          float u[2][NJ][4];
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < NJ; ++n) tc::zero4(u[mi][n]);
#pragma unroll
          for (int k = run0; k < run0 + 32; k += 8) {
            // k slot t <-> row k+2t, slot t+4 <-> row k+2t+1
            tc::SplitA Ak[2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi) {
              const float* hc = Hs + (k + 2 * tq) * LDH + f0 + 16 * mi + gq;
              if (mi == 0 || has_m1)
                Ak[mi] = tc::split_a_bits(hc[0], hc[8], hc[LDH], hc[LDH + 8]);
            }
#pragma unroll
            for (int n = 0; n < NJ; ++n) {
              const float* gc = Gs + (k + 2 * tq) * C::LDG + c0 + 8 * n + gq;
              const tc::SplitB Bf = tc::split_b_bits(gc[0], gc[C::LDG]);
              tc::mma_3xtf32(t[0][n], u[0][n], Ak[0], Bf);
              if (has_m1) tc::mma_3xtf32(t[1][n], u[1][n], Ak[1], Bf);
            }
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < NJ; ++n) tc::add4(wacc[mi][n], t[mi][n], u[mi][n]);
        } else {
          const int qd = lane >> 3;
#pragma unroll
          for (int k = run0; k < run0 + 32; k += 16) {
            uint32_t Ak[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
              if (mi == 0 || has_m1)
                tc::ldsm_x4_t(Ak[mi],
                              Hs + (k + (qd >> 1) * 8 + (lane & 7)) * LDH +
                                  f0 + 16 * mi + (qd & 1) * 8);
#pragma unroll
            for (int np = 0; np < NJ / 2; ++np) {
              uint32_t b[4];
              tc::ldsm_x4_t(b, Gs + (k + (qd & 1) * 8 + (lane & 7)) * C::LDG +
                                   c0 + (2 * np + (qd >> 1)) * 8);
              const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
              tc::mma_bf16(t[0][2 * np], Ak[0], b0);
              tc::mma_bf16(t[0][2 * np + 1], Ak[0], b1);
              if (has_m1) {
                tc::mma_bf16(t[1][2 * np], Ak[1], b0);
                tc::mma_bf16(t[1][2 * np + 1], Ak[1], b1);
              }
            }
          }
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int n = 0; n < NJ; ++n) tc::add4(wacc[mi][n], t[mi][n]);
        }
      }
    }
  }

  tc::cp_wait<0>();
  float* dwa = dw + (long long)a * F * D;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int f = KC * fc + f0 + 16 * mi + gq + 8 * half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + c0 + 8 * n + 2 * tq + e;
          if (f < F && col < D)
            dwa[(long long)f * D + col] = wacc[mi][n][half * 2 + e];
        }
      }

  // db: the sums over the lane groups, then the four row warps of each
  // column half, in a fixed order; in the wide form chunk 0 writes it
  __syncthreads();  // the last step's products are done with Gs
  float* red = reinterpret_cast<float*>(Gs);  // [4][BN2]
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbp[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) red[wr * BN2 + c0 + 8 * j + 2 * tq + e] = v;
    }
  __syncthreads();
  if (tid < BN2 && n0 + tid < D && fc == 0)
    db[(long long)a * D + n0 + tid] =
        ((red[tid] + red[BN2 + tid]) + red[2 * BN2 + tid]) +
        red[3 * BN2 + tid];
}

// One block per arm sums that arm's partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
recon_loss_reduce(const float* __restrict__ part_sum,
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

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// How pass 1 cuts D: n_split slices of cols_per_split columns (a multiple
// of the step), chosen so that the grid fills whole waves of PLAN_SLOTS
// blocks; ties go to fewer slices; no more slices than the dW buffer holds
// dh partials for (D / B of them beyond dh itself).  At A=5, D=5032:
// B=5000 gives 2 slices of 2,528 columns, B=2000 gives 3.
struct RowPlan {
  int n_split, cols_per_split, row_tiles;
};

RowPlan plan(int A, int B, int D) {
  RowPlan p;
  p.row_tiles = (B + BM1 - 1) / BM1;
  const int chunks = (D + BN1 - 1) / BN1;
  const long long cap = (long long)D / B;
  double best = -1.0;
  p.n_split = 1;
  for (int n = 1; n <= MAX_SPLIT && n <= chunks && n - 1 <= cap; ++n) {
    const long long blocks = (long long)p.row_tiles * A * n;
    const long long waves = (blocks + PLAN_SLOTS - 1) / PLAN_SLOTS;
    const double eff = (double)blocks / (double)(waves * PLAN_SLOTS);
    if (eff > best + 1e-9) {
      best = eff;
      p.n_split = n;
    }
  }
  p.cols_per_split = (chunks + p.n_split - 1) / p.n_split * BN1;
  return p;
}

// The shapes the passes take: the grid's limits, and F up to max_f (the
// wide forms' chunks of dh and dW on the grid's z axis with the slices).
template <typename T>
inline bool shape_ok(int A, int B, int F, int D, bool dh) {
  return F >= 1 && F <= max_f<T>(dh) && A >= 1 && A <= 65535 && B >= 1 &&
         B <= 0x7fffffff - BM1 && D >= 1 && D <= 0x7fffffff - BN2;
}

// Pass 1 and, with DH, the dh reduction and pass 2.
template <typename T, bool SEPARATE, bool DH, int FT, bool WIDE>
int launch_passes(const T* h, const T* w, const T* bias, const T* x,
                long long x_arm_stride, const float* g, int A, int B, int F,
                int D, float thr, int with_mism, const RowPlan& pl,
                int vec_h, int vec_d, float* part_sum, int* part_mism,
                float* dh, float* dw, float* db, cudaStream_t st) {
  Partials parts;
  parts.dh = dh;
  parts.in_dw = dw;
  parts.stride = (long long)A * B * F;
  // the wide forms' chunks of dh (pass 1) and of dW (pass 2)
  const int nch = WIDE ? n_chunks(fk<T>(F)) : 1;
  auto kern = recon_rows<T, SEPARATE, FT, DH, WIDE>;
  const size_t smem = smem_rows<T>(F, WIDE);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(pl.row_tiles, A, pl.n_split * (DH ? nch : 1));
  kern<<<grid, THREADS, smem, st>>>(h, w, bias, x, x_arm_stride, g, B, F, D,
                                    pl.cols_per_split, pl.n_split, thr,
                                    with_mism, vec_h, vec_d, part_sum,
                                    part_mism, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || !DH) return (int)err;
  if (pl.n_split > 1) {
    const long long n = parts.stride;
    recon_dh_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
        parts, pl.n_split, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kern2 = recon_cols<T, SEPARATE, FT, WIDE>;
  const size_t smem2 = WIDE ? smem_cols_wide<T>(F) : smem_cols<T, FT>(F);
  err = cudaFuncSetAttribute(
      kern2, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 g2((D + BN2 - 1) / BN2, A, nch);
  kern2<<<g2, THREADS2, smem2, st>>>(h, w, bias, x, x_arm_stride, g, B, F, D,
                                     vec_h, vec_d, dw, db);
  return (int)cudaGetLastError();
}

// NaNs of the f32 operands.  The integer split of the products
// (mma.cuh split_tf32_bits) turns the card's own NaN, 0x7FFFFFFF, into -0,
// so the operands a product splits are first copied with every NaN as
// 0x7FC00000 (tc::quiet_nan), which the split keeps, and the passes read
// the copies: one read and one write of the operands (scanning for NaNs
// instead and reading a copy only in an arm that holds one slowed the
// passes themselves more: PERF.md §6).  Array k is n[k] floats from p[k];
// its copy q[k] lies in the caller's workspace (quiet_workspace).
struct QuietCopy {
  static constexpr int MAX = 8;
  const float* p[MAX];
  float* q[MAX];
  long long n[MAX];
  int count;
};

// Floats of the workspace: the copies, each at a multiple of 64 floats
// (256 bytes, so that a copy keeps any cp.async alignment of its array).
// With ws set, the copies' addresses go to c->q.
inline long long quiet_workspace(QuietCopy* c, float* ws) {
  long long off = 0;
  for (int k = 0; k < c->count; ++k) {
    if (ws) c->q[k] = ws + off;
    off += (c->n[k] + 63) / 64 * 64;
  }
  return off;
}

__global__ void __launch_bounds__(256) quiet_copy(const QuietCopy c) {
  const long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (int k = 0; k < c.count; ++k)
    for (long long i = i0; i < c.n[k]; i += stride)
      c.q[k][i] = tc::quiet_nan(c.p[k][i]);
}

// The quiet copies into ws, on one stream.
inline int quiet_copies(QuietCopy& c, float* ws, cudaStream_t st) {
  quiet_workspace(&c, ws);
  quiet_copy<<<528, 256, 0, st>>>(c);
  return (int)cudaGetLastError();
}

// #2's f32 operands that the products split: h (A,B,F) and W (A,F,D)
inline QuietCopy recon_quiet_arrays(const void* h, const void* w, int A,
                                    int B, int F, int D) {
  QuietCopy c;
  c.count = 2;
  c.p[0] = static_cast<const float*>(h);
  c.n[0] = (long long)A * B * F;
  c.p[1] = static_cast<const float*>(w);
  c.n[1] = (long long)A * F * D;
  return c;
}

// The whole launch sequence on one stream: pass 1, the dh reduction,
// pass 2 and (unless SEPARATE) the loss reduction; without DH pass 1 in
// its value-only form and the loss reduction (dh, dw, db unused).
// quiet_ws (f32; nullptr: h and W hold no NaN but quiet ones): the
// workspace of the quiet copies of h and W, which the passes then read.
template <typename T, bool SEPARATE, bool DH = true>
int recon_launch(const void* h_, const void* w_, const void* bias_,
                 const void* x_, long long x_arm_stride, const void* g_,
                 int A, int B, int F, int D, float thr, int with_mism,
                 void* part_sum, void* part_mism, void* out, void* dh,
                 void* dw, void* db, void* quiet_ws, void* stream) {
  if (!shape_ok<T>(A, B, F, D, DH)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* h = static_cast<const T*>(h_);
  const T* w = static_cast<const T*>(w_);
  const T* bias = static_cast<const T*>(bias_);
  const T* x = static_cast<const T*>(x_);
  const float* g = static_cast<const float*>(g_);
  const int e = (int)sizeof(T);
  const int vec_h = tc::chunk_bytes(h, F, e, (long long)B * F);
  int vec_d = tc::chunk_bytes(x, D, e, x_arm_stride);
  const int vw = tc::chunk_bytes(w, D, e, (long long)F * D);
  vec_d = vw < vec_d ? vw : vec_d;
  const RowPlan pl = plan(A, B, D);
  float* ps = static_cast<float*>(part_sum);
  int* pm = static_cast<int*>(part_mism);
  float* dhp = static_cast<float*>(dh);
  float* dwp = static_cast<float*>(dw);
  float* dbp = static_cast<float*>(db);
  if (std::is_same<T, float>::value && quiet_ws) {
    QuietCopy c = recon_quiet_arrays(h, w, A, B, F, D);
    const int rc = quiet_copies(c, static_cast<float*>(quiet_ws), st);
    if (rc) return rc;
    h = reinterpret_cast<const T*>(c.q[0]);
    w = reinterpret_cast<const T*>(c.q[1]);
  }
  const int err =
      F <= 104 ? launch_passes<T, SEPARATE, DH, 13, false>(
                     h, w, bias, x, x_arm_stride, g, A, B, F, D, thr,
                     with_mism, pl, vec_h, vec_d, ps, pm, dhp, dwp, dbp, st)
      : F <= FP ? launch_passes<T, SEPARATE, DH, 16, false>(
                     h, w, bias, x, x_arm_stride, g, A, B, F, D, thr,
                     with_mism, pl, vec_h, vec_d, ps, pm, dhp, dwp, dbp, st)
                : launch_passes<T, SEPARATE, DH, 16, true>(
                     h, w, bias, x, x_arm_stride, g, A, B, F, D, thr,
                     with_mism, pl, vec_h, vec_d, ps, pm, dhp, dwp, dbp, st);
  if (err || SEPARATE) return err;
  recon_loss_reduce<<<A, REDUCE_THREADS, 0, st>>>(
      ps, pm, pl.row_tiles * pl.n_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
}  // namespace
