// The row pass of the fused three-head ZINB loss, shared by the value-only
// forward (zinb_fwd.cu, kernel #6) and the training kernels (zinb_fwdbwd.cu,
// pass 1 of #7 and #8).  Device code and the host-side plan; each source
// that includes it builds its own library.
//
// `zinb_rows` blocks own (64-row tile, arm, slice of D) and are 4 warps,
// each warp 16 rows, walking the slice 8 (f32) or 16 (bf16) columns a step:
// the three y tiles = h W_* (K = F) on the tensor cores (`mma.sync`,
// csrc/mma.cuh: 3xTF32 m16n8k8 for f32 operands, m16n8k16 for bf16), the
// element math of zinb_math.cuh on the accumulators and the loss partials
// of the block; with FT > 0 (the training kernels) also the cotangents and
// dh += sum_heads g_* W_*^T, the cotangents taken straight from the y
// accumulators as A fragments (for tf32 the k order of a step is permuted
// to (0,2,4,6,1,3,5,7) on both sides, so that the accumulator layout is the
// A layout), dh kept in registers for the walk and left as one partial per
// slice of D.
//
// FT = 0 is the value-only form: no dh accumulators, no cotangents, no dh
// product, so the y products and the element math keep the 128 registers
// of the training form's four blocks an SM to themselves; it stages the W
// and x tiles in a single buffer instead of two: the x values of a step go
// to registers right after the y products, the buffer is released, and the
// next step's tiles arrive while the element math runs (40 KB of shared
// memory f32, 35 KB bf16).  More blocks an SM, at fewer registers a
// thread, measured slower in both types (scripts/torch_kernel_variants.py
// zinb_blocks, PERF.md §6).
//
// Both forms cut D by the same `plan` (from the shape alone) and reduce the
// loss partials per arm in the same fixed order in double
// (`zinb_loss_reduce`), so the value-only loss equals the training
// kernel's loss bit for bit, and repeated launches are bit-identical on any
// card.
//
// F up to FP (128) runs the forms above.  A wider F runs the wide form
// (template flag WIDE; zinb_fwdbwd.cu's max_f gives the limit its shared
// memory sets), which walks F in chunks of KC = 128: the h tile stays
// resident, a step is NK = ceil(F/128) stages of the three heads' W rows
// (y summed over every chunk in the runs of one long K), then one more
// stage of x and, in the training form, the W rows of the block's own
// chunk of dh; a ring of two stages in both forms.  The grid's z axis is
// (chunk of dh, slice of D); each block recomputes y, and chunk 0 writes
// the loss partials, so the value-only loss still equals the training
// kernel's bit for bit.

#pragma once

#include <stdint.h>

#include <type_traits>

#include "mma.cuh"
#include "zinb_math.cuh"

namespace {

using zinb::round_as;
using zinb::to_f32;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int KS = 8;    // k of one mma (tf32)
  static constexpr int BN1 = 8;   // columns of a pass-1 step
  static constexpr int LDW1 = 8;  // pitches of the pass-1 W and x tiles
  static constexpr int LDX1 = 8;
  static constexpr int HPAD = 4;  // h tile pitch = padded F + HPAD
  // pass 2 keeps the cotangents split, {hi, lo} pairs (GELEM floats each)
  static constexpr int LDW2 = 40, LDX2 = 36, LDG2 = 34, GELEM = 2;
  static constexpr int STAGES2 = 2;
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int KS = 16;
  static constexpr int BN1 = 16;
  static constexpr int LDW1 = 24;
  static constexpr int LDX1 = 24;
  static constexpr int HPAD = 8;
  static constexpr int LDW2 = 40, LDX2 = 40, LDG2 = 40, GELEM = 1;
  static constexpr int STAGES2 = 3;
};
// The pitches keep every fragment load of a warp on 32 distinct banks (or
// 8 distinct 16-byte groups for ldmatrix).

constexpr int BM1 = 64, THREADS1 = 128;           // pass 1
constexpr int FP = 128;   // largest F of the resident forms
constexpr int KC = 128;   // the wide forms' chunk of F
// dynamic shared memory a block may take on an H100
constexpr int SMEM_MAX = 232448;
constexpr int MAX_SPLIT = 8;
// Block slots the row plan fills: an H100 SXM's 132 SMs at the training
// form's four blocks an SM.  A constant, not the card's count, so that the
// plan, and with it the order of the dh and loss sums, depends on the
// shape alone: the bits are the same on every card.
constexpr long long PLAN_SLOTS = 132 * 4;
constexpr int MAX_SPILL = 2;  // dh partials beyond the dW buffer's room
constexpr int REDUCE_THREADS = 256;
// f32 y products: k steps of 8 summed apart before they join the
// accumulator (tc::add4); the tensor cores round each sum toward zero
constexpr int RUN_K = 4;

// The row pass's ring: two stages for the training form, one for the
// value-only form (see the note at the top); two in the wide forms.
__host__ __device__ constexpr int rows_stages(bool dh, bool wide = false) {
  return dh || wide ? 2 : 1;
}
// chunks of KC the wide forms cut F into
__host__ __device__ inline int n_chunks(int F) { return (F + KC - 1) / KC; }

template <typename T>
struct Heads {
  const T* w[3];
  const T* b[3];
};

__host__ __device__ inline int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
// F rounded to the k of one mma: the depth of the y products
template <typename T>
__host__ __device__ inline int fk(int F) {
  return round_up(F, Cfg<T>::KS);
}

// rows of each head's W a stage holds: all of F, or one chunk (wide)
template <typename T>
__host__ __device__ inline int stage_rows(int F, bool wide) {
  return wide ? KC : fk<T>(F);
}
template <typename T>
size_t smem_rows(int F, bool dh, bool wide = false) {
  const int FK = fk<T>(F);
  return sizeof(T) *
         ((size_t)BM1 * (FK + Cfg<T>::HPAD) +
          (size_t)rows_stages(dh, wide) *
              (3 * (size_t)stage_rows<T>(F, wide) * Cfg<T>::LDW1 +
               (size_t)BM1 * Cfg<T>::LDX1));
}

// Where the dh partial of slice s goes: slice 0 into dh itself, the next
// `n_in_dw` into the dW buffer (pass 2 overwrites it afterwards), the rest
// into the spill buffer.
struct Partials {
  float* dh;
  float* in_dw;
  float* spill;
  long long stride;  // A * B * F
  int n_in_dw;
  __device__ float* part(int s) const {
    if (s == 0) return dh;
    s -= 1;
    return s < n_in_dw ? in_dw + s * stride
                       : spill + (s - n_in_dw) * stride;
  }
};

// ---------------------------------------------------------------------------
// Grid (ceil(B/BM1), A, n_split), in the wide form (ceil(B/BM1), A, n_split
// * chunks of dh).  Loss partials (LOSS) and, with FT > 0, dh; FT: the
// number of 8-wide tiles of F the dh accumulators cover.  A step is NS
// stages: one (the heads' W of all F and x) in the resident forms; in the
// wide form NK chunks of W for y, then x and the dh chunk's W.
// ---------------------------------------------------------------------------
template <typename T, bool LOSS, bool TWO_DIGAMMA, int FT, bool WIDE>
__global__ void __launch_bounds__(THREADS1, 4)
zinb_rows(const T* __restrict__ h, Heads<T> heads, const T* __restrict__ x,
          long long x_arm_stride, const float* __restrict__ g, int B, int F,
          int D, int cols_per_split, int n_split, float eps, float one_m_eps,
          int vec_h, int vec_d, float* __restrict__ part_sum, Partials dhp) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr bool DH = FT > 0;
  static_assert(DH || (LOSS && !TWO_DIGAMMA), "value-only: the loss alone");
  constexpr int STAGES = rows_stages(DH, WIDE);
  constexpr int NJ = C::BN1 / 8;  // n-tiles of a step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int FK = fk<T>(F);
  const int LDH = FK + C::HPAD;
  const int KW = stage_rows<T>(F, WIDE);  // rows of a head's W a stage
  const int w_elems = KW * C::LDW1;       // one head's W tile
  const int stage_elems = 3 * w_elems + BM1 * C::LDX1;
  T* const Hs = sm;
  T* const stages = sm + BM1 * LDH;

  const int a = blockIdx.y;
  const int m0 = blockIdx.x * BM1;
  const int split = WIDE ? blockIdx.z % n_split : blockIdx.z;
  const int fc = WIDE ? blockIdx.z / n_split : 0;  // the block's dh chunk
  const int NK = WIDE ? n_chunks(FK) : 1;          // chunks of y a step
  const int NS = WIDE ? NK + 1 : 1;                // stages a step
  const int fk_dh = WIDE ? min(KC, FK - KC * fc) : FK;
  const int d_begin = split * cols_per_split;
  const int d_end = min(D, d_begin + cols_per_split);
  const int nsteps =
      d_end > d_begin ? (d_end - d_begin + C::BN1 - 1) / C::BN1 : 0;
  const int nq = nsteps * NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;  // the warp's rows of the tile
  const T* ha = h + (long long)a * B * F;
  const T* xa = x + (long long)a * x_arm_stride;
  const float ga = g ? g[a] : 1.f;

  auto issue = [&](int q) {
    T* st = stages + (q % STAGES) * stage_elems;
    const int step = WIDE ? q / NS : q, j = WIDE ? q % NS : 0;
    const int col0 = d_begin + step * C::BN1;
    if (j < NK || DH) {  // the chunk j of W, or the dh chunk's
      const int k0 = WIDE ? KC * (j < NK ? j : fc) : 0;
#pragma unroll
      for (int hd = 0; hd < 3; ++hd)
        tc::load_tile_c<C::BN1, THREADS1>(
            st + hd * w_elems, C::LDW1,
            heads.w[hd] + (long long)a * F * D + (long long)k0 * D + col0, D,
            KW, F - k0, D - col0, vec_d, tid);
    }
    if (j == NS - 1)
      tc::load_tile_c<C::BN1, THREADS1>(st + 3 * w_elems, C::LDX1,
                                        xa + (long long)m0 * D + col0, D,
                                        BM1, B - m0, D - col0, vec_d, tid);
  };

  tc::load_tile(Hs, LDH, ha + (long long)m0 * F, F, BM1, FK, B - m0, F,
                vec_h, tid, THREADS1);
  if (nq > 0) issue(0);
  tc::cp_commit();

  float dacc[DH ? FT : 1][4];
#pragma unroll
  for (int n = 0; n < (DH ? FT : 1); ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dacc[n][i] = 0.f;
  float s = 0.f;
  // y = h W_* of the warp's 16 rows and the step's columns
  float acc[3][NJ][4];
  float run[3][4];  // f32: a run of RUN_K k steps, summed apart

  for (int q = 0; q < nq; ++q) {
    tc::cp_wait<0>();
    __syncthreads();  // this stage's tiles are in; the other buffer is free
    if constexpr (STAGES == 2) {
      if (q + 1 < nq) issue(q + 1);
      tc::cp_commit();
    }
    const T* Ws = stages + (q % STAGES) * stage_elems;
    const T* Xs = Ws + 3 * w_elems;
    const int step = WIDE ? q / NS : q, j = WIDE ? q % NS : 0;
    const int col0 = d_begin + step * C::BN1;

    if (j == 0) {
#pragma unroll
      for (int hd = 0; hd < 3; ++hd)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[hd][jj][i] = 0.f;
    }
    if (j < NK) {
      // the chunk's k: columns hk.. of the h tile, the stage's rows
      const int hk = KC * j;
      const int kend = WIDE ? min(KC, FK - hk) : FK;
      for (int kk = 0; kk < kend; kk += C::KS) {
        if constexpr (F32) {
          const float* hr = Hs + (r0 + gq) * LDH + hk + kk + tq;
          const tc::SplitA A =
              tc::split_a(hr[0], hr[8 * LDH], hr[4], hr[8 * LDH + 4]);
          const bool first = kk % (8 * RUN_K) == 0;
          const bool last =
              kk % (8 * RUN_K) == 8 * (RUN_K - 1) || kk + 8 >= kend;
#pragma unroll
          for (int hd = 0; hd < 3; ++hd) {
            const float* wc = Ws + hd * w_elems + (kk + tq) * C::LDW1 + gq;
            if (first) tc::zero4(run[hd]);
            tc::mma_3xtf32(run[hd], run[hd], A,
                           tc::split_b(wc[0], wc[4 * C::LDW1]));
            if (last) tc::add4(acc[hd][0], run[hd]);
          }
        } else {
          const T* hr = Hs + (r0 + gq) * LDH + hk + kk + 2 * tq;
          const uint32_t A[4] = {tc::ld_u32(hr), tc::ld_u32(hr + 8 * LDH),
                                 tc::ld_u32(hr + 8),
                                 tc::ld_u32(hr + 8 * LDH + 8)};
          const int qd = lane >> 3;
#pragma unroll
          for (int hd = 0; hd < 3; ++hd) {
            uint32_t b[4];
            tc::ldsm_x4_t(b, Ws + hd * w_elems +
                                 (kk + (qd & 1) * 8 + (lane & 7)) * C::LDW1 +
                                 (qd >> 1) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            tc::mma_bf16(acc[hd][0], A, b0);
            tc::mma_bf16(acc[hd][1], A, b1);
          }
        }
      }
    }
    if (j != NS - 1) continue;

    // the step's x values; the value-only form then releases its single
    // buffer, so that the next tiles arrive during the element math
    float xv[NJ][2][2];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int cl = 8 * jj + 2 * tq + e;
          const int rl = r0 + gq + 8 * half;
          xv[jj][e][half] = (col0 + cl < D && m0 + rl < B)
                                ? to_f32(Xs[rl * C::LDX1 + cl])
                                : 0.f;
        }
    if constexpr (STAGES == 1) {
      __syncthreads();  // every warp has read the buffer
      if (q + 1 < nq) issue(q + 1);
      tc::cp_commit();
    }

    // element math: the accumulators become the cotangents in place
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * jj + 2 * tq + e;
        const int col = col0 + cl;
        const bool col_ok = col < D;
        float bias[3] = {0.f, 0.f, 0.f};
        if (col_ok) {
#pragma unroll
          for (int hd = 0; hd < 3; ++hd)
            bias[hd] = to_f32(heads.b[hd][(long long)a * D + col]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rl = r0 + gq + 8 * half;
          const int i = half * 2 + e;
          float loss = 0.f, g_r = 0.f, g_p = 0.f, g_z = 0.f;
          if (col_ok && m0 + rl < B) {
            zinb::element<LOSS, DH, TWO_DIGAMMA>(
                acc[0][jj][i] + bias[0], acc[1][jj][i] + bias[1],
                acc[2][jj][i] + bias[2], xv[jj][e][half], eps, one_m_eps, ga,
                loss, g_r, g_p, g_z);
          }
          if (LOSS) s += loss;
          acc[0][jj][i] = g_r;
          acc[1][jj][i] = g_p;
          acc[2][jj][i] = g_z;
        }
      }
    }

    if constexpr (DH) {
      // dh += sum_heads g_* W_*^T, the cotangents as A fragments; each
      // step's three heads are summed apart and then added (see add4)
      if constexpr (F32) {
        // k slot t <-> column 2t, slot t+4 <-> column 2t+1
        tc::SplitA Ag[3];
#pragma unroll
        for (int hd = 0; hd < 3; ++hd)
          Ag[hd] = tc::split_a(acc[hd][0][0], acc[hd][0][2], acc[hd][0][1],
                               acc[hd][0][3]);
#pragma unroll
        for (int n = 0; n < FT; ++n) {
          if (8 * n < fk_dh) {
            float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int hd = 0; hd < 3; ++hd) {
              const float2 wv = *reinterpret_cast<const float2*>(
                  Ws + hd * w_elems + (8 * n + gq) * C::LDW1 + 2 * tq);
              tc::mma_3xtf32(t, u, Ag[hd], tc::split_b(wv.x, wv.y));
            }
            tc::add4(dacc[n], t, u);
          }
        }
      } else {
        uint32_t Ag[3][4];
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
          Ag[hd][0] = tc::pack_bf16(acc[hd][0][0], acc[hd][0][1]);
          Ag[hd][1] = tc::pack_bf16(acc[hd][0][2], acc[hd][0][3]);
          Ag[hd][2] = tc::pack_bf16(acc[hd][1][0], acc[hd][1][1]);
          Ag[hd][3] = tc::pack_bf16(acc[hd][1][2], acc[hd][1][3]);
        }
#pragma unroll
        for (int n = 0; n < FT; ++n) {
          if (8 * n < fk_dh) {
            float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int hd = 0; hd < 3; ++hd) {
              const T* wr =
                  Ws + hd * w_elems + (8 * n + gq) * C::LDW1 + 2 * tq;
              const uint32_t b[2] = {tc::ld_u32(wr), tc::ld_u32(wr + 8)};
              tc::mma_bf16(t, Ag[hd], b);
            }
            tc::add4(dacc[n], t);
          }
        }
      }
    }
  }

  tc::cp_wait<0>();  // nothing in flight when the block ends

  if constexpr (DH) {
    // this slice's dh partial, of the block's chunk
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

  if (LOSS && fc == 0) {
    // block reduction of the loss in a fixed order
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    __shared__ float warp_s[THREADS1 / 32];
    if (lane == 0) warp_s[warp] = s;
    __syncthreads();
    if (tid == 0) {
      float bs = 0.f;
      for (int i = 0; i < THREADS1 / 32; ++i) bs += warp_s[i];
      part_sum[((long long)a * gridDim.x + blockIdx.x) * n_split + split] =
          bs;
    }
  }
}

// One block per arm sums that arm's loss partials in a fixed order.
__global__ void __launch_bounds__(REDUCE_THREADS)
zinb_loss_reduce(const float* __restrict__ part_sum, int n_per_arm,
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

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

struct Args {
  const void *h, *w_r, *b_r, *w_p, *b_p, *w_z, *b_z, *x;
  long long x_arm_stride;
  int A, B, F, D;
  float eps, one_m_eps;
};

// The entry points' head arguments, and their packing into Args.
#define ZINB_ARGS                                                           \
  const void *h, const void *w_r, const void *b_r, const void *w_p,         \
      const void *b_p, const void *w_z, const void *b_z, const void *x,     \
      long long x_arm_stride, int A, int B, int F, int D, float eps,        \
      float one_m_eps
#define ZINB_PACK                                                           \
  Args { h, w_r, b_r, w_p, b_p, w_z, b_z, x, x_arm_stride, A, B, F, D, eps, \
         one_m_eps }

template <typename T>
Heads<T> heads_of(const Args& p) {
  Heads<T> heads;
  heads.w[0] = static_cast<const T*>(p.w_r);
  heads.w[1] = static_cast<const T*>(p.w_p);
  heads.w[2] = static_cast<const T*>(p.w_z);
  heads.b[0] = static_cast<const T*>(p.b_r);
  heads.b[1] = static_cast<const T*>(p.b_p);
  heads.b[2] = static_cast<const T*>(p.b_z);
  return heads;
}

// How the row pass cuts D: n_split slices of cols_per_split columns (a
// multiple of the step), chosen so that the grid fills whole waves of
// PLAN_SLOTS blocks; ties go to fewer slices; no more slices than the
// training kernel can place dh partials for.  At A=5, D=5032: B=5000 gives
// 4 slices of 1,264 columns (f32), the 3 partials beyond dh's own kept in
// the dW buffer (none spilled); B=2000 gives 3 slices.
struct RowPlan {
  int n_split, cols_per_split, row_tiles, n_in_dw, n_spill;
};

template <typename T>
RowPlan plan(int A, int B, int D) {
  RowPlan p;
  p.row_tiles = (B + BM1 - 1) / BM1;
  const int chunks = (D + Cfg<T>::BN1 - 1) / Cfg<T>::BN1;
  // room for partials in the dW buffer (3*A*F*D floats)
  const long long cap = (3LL * D) / B;
  double best = -1.0;
  p.n_split = 1;
  for (int n = 1; n <= MAX_SPLIT && n <= chunks; ++n) {
    if (n - 1 - cap > MAX_SPILL) break;
    const long long blocks = (long long)p.row_tiles * A * n;
    const long long waves = (blocks + PLAN_SLOTS - 1) / PLAN_SLOTS;
    const double eff = (double)blocks / (double)(waves * PLAN_SLOTS);
    if (eff > best + 1e-9) {
      best = eff;
      p.n_split = n;
    }
  }
  const int per = (chunks + p.n_split - 1) / p.n_split;
  p.cols_per_split = per * Cfg<T>::BN1;
  p.n_in_dw = (int)(cap < p.n_split - 1 ? cap : p.n_split - 1);
  p.n_spill = p.n_split - 1 - p.n_in_dw;
  return p;
}

// The shapes the row pass takes: the grid's limits, and F up to max_f (the
// wide form's chunks of dh on the grid's z axis with the slices).  max_f
// is the row pass's limit; zinb_fwdbwd.cu adds its column pass's.
inline bool shape_ok(int A, int B, int F, int D, int max_f) {
  return F >= 1 && F <= max_f && A >= 1 && A <= 65535 && B >= 1 &&
         B <= 0x7fffffff - BM1 && D >= 1;
}

// Largest F the row pass takes: every F up to FP, and beyond it the wide
// form while its shared memory (the resident h tile) fits a block.
template <typename T>
int max_f_rows(bool dh) {
  int f = FP;
  for (int g = FP + Cfg<T>::KS;
       smem_rows<T>(g, dh, true) + 64 <= (size_t)SMEM_MAX;
       g += Cfg<T>::KS)
    f = g;
  return f;
}

template <typename T>
int vec_of(const Args& p) {
  // chunk size every operand row allows (the W tiles and x share one)
  const int e = (int)sizeof(T);
  int vd = tc::chunk_bytes(p.x, p.D, e, p.x_arm_stride);
  const void* ws[3] = {p.w_r, p.w_p, p.w_z};
  for (int i = 0; i < 3; ++i) {
    const int c = tc::chunk_bytes(ws[i], p.D, e, (long long)p.F * p.D);
    vd = c < vd ? c : vd;
  }
  return vd;
}

template <typename T>
int vec_h_of(const Args& p) {
  return tc::chunk_bytes(p.h, p.F, (int)sizeof(T), (long long)p.B * p.F);
}

}  // namespace
