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
// order r, p, z.  F up to zinb_fwdbwd_max_f (616 f32, 1,440 bf16).
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   nine products (three each of forward, dh, dW) of 2*A*B*F*D = 25.2 GFLOP
//   = 226 GFLOP; on the tensor cores 0.46 ms at the TF32 peak (495 TFLOP/s)
//   for f32 operands taken as one TF32 product, 0.23 ms at the bf16 peak
//   (989 TFLOP/s); bytes (operands read once, outputs written once, about
//   212 MB in f32) 0.063 ms.  Bound by operations.  The bound leaves out the
//   epilogue: 1.26e8 elements with nine log/exp calls and five divisions
//   each, and the 3xTF32 split triples the tf32 work of f32 operands.
//
// Design.  dh reduces over D and the three dW over B, so no single tiling
// finishes both without partials.  Weighed: one pass over (row group,
// column group) blocks with dh and dW partials in a workspace (190-800 MB
// of scratch, next to a limit of one (A,B,D) tensor, 503 MB, for the whole
// step) against two passes with the forward recomputed; two passes:
//   pass 1, `zinb_rows` (csrc/zinb_rows.cuh, whose value-only form is the
//     forward #6 of zinb_fwd.cu), blocks (64-row tile, arm, slice of D) of
//     4 warps, each warp 16 rows, walking the slice 8 (f32) or 16 (bf16)
//     columns a step: three y tiles = h W_* (K = F), the element math (loss
//     partials, cotangents), then dh += sum_heads g_* W_*^T with the
//     cotangents taken straight from the y accumulators in registers as A
//     fragments (for tf32 the k order of a step is permuted to (0,2,4,6,
//     1,3,5,7) on both sides, so the accumulator layout is the A layout);
//     dh stays in registers for the walk.  The slices of D (4 at the
//     production shape, chosen from the shape so that the grid fills
//     whole waves of an H100; `plan`) each leave a dh partial; slice 0
//     writes dh, the others the dW buffer, which pass 2 overwrites later
//     (a spill buffer only beyond its room), and `zinb_dh_reduce` adds them
//     in slice order;
//   pass 2, `zinb_cols`, blocks (32-column tile, arm) of 8 warps walking
//     every 32-row tile of B: the y tiles and the cotangents recomputed (no
//     loss terms), the cotangents rounded to h's type into shared memory
//     (for f32 already split into tf32 halves, once, not by each of the
//     seven warps that read them), db summed in f32 in registers, and dW +=
//     h^T g_* with warp w owning the 16 hidden units 16w..16w+15 of all
//     three heads (no reduction across warps).
// Products: `mma.sync` (csrc/mma.cuh), m16n8k16 bf16 for bf16 operands and
// 3xTF32 m16n8k8 for f32 ones, f32 accumulation.  Operands are staged in
// their own type with `cp.async` in a ring of two stages (three for bf16
// in pass 2): the next W/x tile (pass 1) or h/x tile (pass 2) arrives
// while the current one's products and element math run.  Sums of the
// tensor cores round toward zero, so runs of a few mma are summed from
// zero and then added to the long-lived accumulators (mma.cuh `add4`).
// F up to FP (128) runs the passes above.  A wider F runs their wide forms,
// which walk F in chunks of KC = 128 (zinb_rows.cuh for pass 1):
//   pass 2, `zinb_cols_wide`, blocks (16-column tile, arm, chunk of dW
//     rows) of 8 warps walking every 32-row tile of B: the three (F, 16) W
//     tiles resident (16 columns, not 32, so that F up to 616 fits in f32),
//     h streamed by chunk in a ring of two: NK chunks for y (warps 0-3, one
//     16 x 8 tile each; y recomputed once a chunk of dW), then the chunk of
//     the block's dW rows with x, the element math and dW += h^T g_* with
//     warp w owning the 16 hidden units 16w.. of the chunk; chunk 0 writes
//     db.  A simple form; its time is in PERF.md §6.
// Occupancy: pass 1 four blocks of 4 warps an SM (52 KB of shared memory
// a block at F=100), pass 2 two blocks of 8 warps (113 KB f32, 65 KB
// bf16), i.e. 16 warps an SM in both; every instantiation reaches the
// 128-register cap, some with spills of 8-72 bytes (`ptxas -v`, which
// chip_smoke.py prints).  No workspace beyond the spill of dh partials
// (none at the production shape) and the loss partials; every sum runs in
// a fixed order that depends on the shape alone, so repeated launches are
// bit-identical, on any card.

#include "zinb_rows.cuh"  // pass 1, the plan, the loss reduction

namespace {

constexpr int BN2 = 32, BM2 = 32, THREADS2 = 256;  // pass 2

template <typename T>
size_t smem_cols(int F) {
  using C = Cfg<T>;
  const int FK = fk<T>(F), ldh = round_up(F, 16) + C::HPAD;
  return sizeof(T) * (3 * (size_t)FK * C::LDW2 +
                      (size_t)C::STAGES2 * BM2 * (ldh + C::LDX2) +
                      3 * (size_t)BM2 * C::LDG2 * C::GELEM);
}

// The wide pass 2 (F > FP): 16 columns a block, x in the ring's stage.
constexpr int BN2W = 16;
template <typename T>
struct CfgW;
template <>
struct CfgW<float> {
  static constexpr int LDW = 24, LDX = 24, LDG = 18;  // LDG: {hi, lo} pairs
};
template <>
struct CfgW<__nv_bfloat16> {
  static constexpr int LDW = 24, LDX = 24, LDG = 24;
};
template <typename T>
__host__ __device__ constexpr int ldh_wide() {
  return KC + Cfg<T>::HPAD;
}
template <typename T>
__host__ __device__ constexpr int stage_wide() {
  return BM2 * (ldh_wide<T>() + CfgW<T>::LDX);
}
template <typename T>
size_t smem_cols_wide(int F) {
  return sizeof(T) * (3 * (size_t)fk<T>(F) * CfgW<T>::LDW +
                      2 * (size_t)stage_wide<T>() +
                      3 * (size_t)BM2 * CfgW<T>::LDG * Cfg<T>::GELEM);
}

// Largest F the training kernels take: the row pass's limit and, past FP,
// the wide pass 2's shared memory (its three resident W tiles).
template <typename T>
int max_f() {
  const int rows = max_f_rows<T>(true);
  int f = FP;
  for (int g = FP + Cfg<T>::KS;
       g <= rows && smem_cols_wide<T>(g) <= (size_t)SMEM_MAX;
       g += Cfg<T>::KS)
    f = g;
  return f;
}

// dh = the slices' partials added in slice order.
__global__ void zinb_dh_reduce(Partials p, int n_split, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = p.dh[i];
  for (int s = 1; s < n_split; ++s) v += p.part(s)[i];
  p.dh[i] = v;
}

// ---------------------------------------------------------------------------
// Pass 2: grid (ceil(D/BN2), A).  The three dW and db of one column tile.
// ---------------------------------------------------------------------------
template <typename T, bool TWO_DIGAMMA>
__global__ void __launch_bounds__(THREADS2, 2)
zinb_cols(const T* __restrict__ h, Heads<T> heads, const T* __restrict__ x,
          long long x_arm_stride, const float* __restrict__ g, int A, int B,
          int F, int D, float eps, float one_m_eps, int vec_h, int vec_d,
          float* __restrict__ dw, float* __restrict__ db) {
  using C = Cfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int S = C::STAGES2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int FK = fk<T>(F);
  const int R16 = round_up(F, 16);  // hidden units the dW m-tiles cover
  const int LDH = R16 + C::HPAD;
  const int w_elems = FK * C::LDW2;
  const int stage_elems = BM2 * (LDH + C::LDX2);
  T* const Ws = sm;  // the block's three W tiles, loaded once
  T* const stages = Ws + 3 * w_elems;
  T* const Gs = stages + S * stage_elems;  // three cotangent tiles
  const int g_elems = BM2 * C::LDG2 * C::GELEM;

  const int a = blockIdx.y;
  const int n0 = blockIdx.x * BN2;
  const int nsteps = (B + BM2 - 1) / BM2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's y tile
  const T* ha = h + (long long)a * B * F;
  const T* xa = x + (long long)a * x_arm_stride;
  const float ga = g ? g[a] : 1.f;

#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
    tc::load_tile(Ws + hd * w_elems, C::LDW2,
                  heads.w[hd] + (long long)a * F * D + n0, D, FK, BN2, F,
                  D - n0, vec_d, tid, THREADS2);
  auto issue = [&](int step) {
    T* st = stages + (step % S) * stage_elems;
    const int m0 = step * BM2;
    tc::load_tile(st, LDH, ha + (long long)m0 * F, F, BM2, R16, B - m0, F,
                  vec_h, tid, THREADS2);
    tc::load_tile(st + BM2 * LDH, C::LDX2, xa + (long long)m0 * D + n0, D,
                  BM2, BN2, B - m0, D - n0, vec_d, tid, THREADS2);
  };
#pragma unroll
  for (int p = 0; p < S - 1; ++p) {
    if (p < nsteps) issue(p);
    tc::cp_commit();
  }

  float bias[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = n0 + 8 * wn + 2 * tq + e;
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
      bias[hd][e] = col < D ? to_f32(heads.b[hd][(long long)a * D + col]) : 0.f;
  }
  const bool has_m = 16 * warp < F;  // the warp owns hidden units 16w..
  float wacc[3][4][4];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) wacc[hd][n][i] = 0.f;
  float dbp[3][2];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd) dbp[hd][0] = dbp[hd][1] = 0.f;
  float s_unused = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    tc::cp_wait<S - 2>();
    __syncthreads();  // tiles in; the freed buffer and Gs may be rewritten
    if (step + S - 1 < nsteps) issue(step + S - 1);
    tc::cp_commit();
    const T* Hs = stages + (step % S) * stage_elems;
    const T* Xs = Hs + BM2 * LDH;
    const int m0 = step * BM2;

    // y tile of the warp: rows 16 wm.., columns 8 wn.., three heads
    float acc[3][4];
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[hd][i] = 0.f;
    float run[3][4];  // f32: a run of RUN_K k steps, summed apart
    for (int kk = 0; kk < FK; kk += C::KS) {
      if constexpr (F32) {
        const float* hr = Hs + (16 * wm + gq) * LDH + kk + tq;
        const tc::SplitA Af =
            tc::split_a(hr[0], hr[8 * LDH], hr[4], hr[8 * LDH + 4]);
        const bool first = kk % (8 * RUN_K) == 0;
        const bool last = kk % (8 * RUN_K) == 8 * (RUN_K - 1) || kk + 8 >= FK;
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
          const float* wc =
              Ws + hd * w_elems + (kk + tq) * C::LDW2 + 8 * wn + gq;
          if (first) tc::zero4(run[hd]);
          tc::mma_3xtf32(run[hd], run[hd], Af,
                         tc::split_b(wc[0], wc[4 * C::LDW2]));
          if (last) tc::add4(acc[hd], run[hd]);
        }
      } else {
        const T* hr = Hs + (16 * wm + gq) * LDH + kk + 2 * tq;
        const uint32_t Af[4] = {tc::ld_u32(hr), tc::ld_u32(hr + 8 * LDH),
                                tc::ld_u32(hr + 8),
                                tc::ld_u32(hr + 8 * LDH + 8)};
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
          uint32_t b[2];
          tc::ldsm_x2_t(b, Ws + hd * w_elems +
                               (kk + (lane & 15)) * C::LDW2 + 8 * wn);
          tc::mma_bf16(acc[hd], Af, b);
        }
      }
    }

    // element math; db from the f32 cotangents; the rounded ones to Gs
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int rl = 16 * wm + gq + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int cl = 8 * wn + 2 * tq + e;
        const int i = half * 2 + e;
        float g_r = 0.f, g_p = 0.f, g_z = 0.f;
        if (m0 + rl < B && n0 + cl < D) {
          const float xv = to_f32(Xs[rl * C::LDX2 + cl]);
          zinb::element<false, true, TWO_DIGAMMA>(
              acc[0][i] + bias[0][e], acc[1][i] + bias[1][e],
              acc[2][i] + bias[2][e], xv, eps, one_m_eps, ga, s_unused, g_r,
              g_p, g_z);
        }
        acc[0][i] = g_r;
        acc[1][i] = g_p;
        acc[2][i] = g_z;
        dbp[0][e] += g_r;
        dbp[1][e] += g_p;
        dbp[2][e] += g_z;
      }
      const int cl = 8 * wn + 2 * tq;
#pragma unroll
      for (int hd = 0; hd < 3; ++hd) {
        T* gp = Gs + hd * g_elems + (rl * C::LDG2 + cl) * C::GELEM;
        if constexpr (F32) {
          // split once here, not by each of the seven warps that read it
          uint32_t h0, l0, h1, l1;
          tc::split_tf32(acc[hd][half * 2], h0, l0);
          tc::split_tf32(acc[hd][half * 2 + 1], h1, l1);
          *reinterpret_cast<float4*>(gp) =
              make_float4(__uint_as_float(h0), __uint_as_float(l0),
                          __uint_as_float(h1), __uint_as_float(l1));
        } else {
          *reinterpret_cast<uint32_t*>(gp) =
              tc::pack_bf16(acc[hd][half * 2], acc[hd][half * 2 + 1]);
        }
      }
    }
    __syncthreads();  // Gs complete

    // dW[f][col] += sum_rows h[row][f] g[row][col]: hidden units 16w..
    if (has_m) {
      const int f0 = 16 * warp;
      // each step's 32 rows are summed apart and then added (see add4)
      if constexpr (F32) {
        tc::SplitA Ak[BM2 / 8];
#pragma unroll
        for (int k = 0; k < BM2 / 8; ++k) {
          // k slot t <-> row 8k+2t, slot t+4 <-> row 8k+2t+1
          const float* hc = Hs + (8 * k + 2 * tq) * LDH + f0 + gq;
          Ak[k] = tc::split_a(hc[0], hc[8], hc[LDH], hc[LDH + 8]);
        }
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < BM2 / 8; ++k) {
              const float2* gc =
                  reinterpret_cast<const float2*>(Gs + hd * g_elems) +
                  (8 * k + 2 * tq) * C::LDG2 + 8 * n + gq;
              const float2 g0 = gc[0], g1 = gc[C::LDG2];
              tc::SplitB Bf;
              Bf.hi[0] = __float_as_uint(g0.x);
              Bf.lo[0] = __float_as_uint(g0.y);
              Bf.hi[1] = __float_as_uint(g1.x);
              Bf.lo[1] = __float_as_uint(g1.y);
              tc::mma_3xtf32(t, u, Ak[k], Bf);
            }
            tc::add4(wacc[hd][n], t, u);
          }
        }
      } else {
        const int q = lane >> 3;
        uint32_t Ak[BM2 / 16][4];
#pragma unroll
        for (int k = 0; k < BM2 / 16; ++k)
          tc::ldsm_x4_t(Ak[k], Hs + (16 * k + (q >> 1) * 8 + (lane & 7)) * LDH +
                                   f0 + (q & 1) * 8);
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < BM2 / 16; ++k) {
              uint32_t b[4];
              tc::ldsm_x4_t(b, Gs + hd * g_elems +
                                   (16 * k + (q & 1) * 8 + (lane & 7)) *
                                       C::LDG2 +
                                   (2 * np + (q >> 1)) * 8);
              const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
              tc::mma_bf16(t0, Ak[k], b0);
              tc::mma_bf16(t1, Ak[k], b1);
            }
            tc::add4(wacc[hd][2 * np], t0);
            tc::add4(wacc[hd][2 * np + 1], t1);
          }
        }
      }
    }
  }

  tc::cp_wait<0>();
  if (has_m) {
#pragma unroll
    for (int hd = 0; hd < 3; ++hd) {
      float* dwa = dw + ((long long)hd * A + a) * F * D;
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int f = 16 * warp + gq + 8 * half;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * n + 2 * tq + e;
            if (f < F && col < D)
              dwa[(long long)f * D + col] = wacc[hd][n][half * 2 + e];
          }
        }
    }
  }

  // db: the sums over g of each lane group, then the two row halves, in a
  // fixed order
  __syncthreads();  // the last step's products are done with Gs
  float* red = reinterpret_cast<float*>(Gs);  // [2][3][BN2]
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = dbp[hd][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) red[(wm * 3 + hd) * BN2 + 8 * wn + 2 * tq + e] = v;
    }
  __syncthreads();
  if (tid < 3 * BN2) {
    const int hd = tid / BN2, c = tid % BN2;
    if (n0 + c < D)
      db[((long long)hd * A + a) * D + n0 + c] =
          red[hd * BN2 + c] + red[(3 + hd) * BN2 + c];
  }
}

// ---------------------------------------------------------------------------
// The wide pass 2: grid (ceil(D/BN2W), A, chunks of dW rows).  The three dW
// and db (chunk 0) of one 16-column tile; a step is NK stages of h chunks
// for y, then the block's chunk of h with x.
// ---------------------------------------------------------------------------
template <typename T, bool TWO_DIGAMMA>
__global__ void __launch_bounds__(THREADS2, 1)
zinb_cols_wide(const T* __restrict__ h, Heads<T> heads,
               const T* __restrict__ x, long long x_arm_stride,
               const float* __restrict__ g, int A, int B, int F, int D,
               float eps, float one_m_eps, int vec_h, int vec_d,
               float* __restrict__ dw, float* __restrict__ db) {
  using C = Cfg<T>;
  using CW = CfgW<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDH = ldh_wide<T>();
  constexpr int stage_elems = stage_wide<T>();
  constexpr int g_elems = BM2 * CW::LDG * C::GELEM;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int FK = fk<T>(F);
  const int w_elems = FK * CW::LDW;
  T* const Ws = sm;  // the block's three W tiles, loaded once
  T* const stages = Ws + 3 * w_elems;
  T* const Gs = stages + 2 * stage_elems;  // three cotangent tiles

  const int a = blockIdx.y;
  const int n0 = blockIdx.x * BN2W;
  const int fc = blockIdx.z;  // the block's chunk of dW rows
  const int NK = n_chunks(FK), NS = NK + 1;
  const int nq = (B + BM2 - 1) / BM2 * NS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bool has_y = warp < 4;  // warps 0-3 own a 16 x 8 y tile each
  const int wm = warp & 1, wn = (warp >> 1) & 1;
  const int f0 = 16 * warp;  // the warp's hidden units of the chunk (dW)
  const bool has_m = KC * fc + f0 < F;
  const T* ha = h + (long long)a * B * F;
  const T* xa = x + (long long)a * x_arm_stride;
  const float ga = g ? g[a] : 1.f;

#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
    tc::load_tile(Ws + hd * w_elems, CW::LDW,
                  heads.w[hd] + (long long)a * F * D + n0, D, FK, BN2W, F,
                  D - n0, vec_d, tid, THREADS2);
  auto issue = [&](int q) {
    T* st = stages + (q & 1) * stage_elems;
    const int m0 = q / NS * BM2, j = q % NS;
    const int hk = KC * (j < NK ? j : fc);
    tc::load_tile(st, LDH, ha + (long long)m0 * F + hk, F, BM2, KC, B - m0,
                  F - hk, vec_h, tid, THREADS2);
    if (j == NK)
      tc::load_tile(st + BM2 * LDH, CW::LDX, xa + (long long)m0 * D + n0, D,
                    BM2, BN2W, B - m0, D - n0, vec_d, tid, THREADS2);
  };
  issue(0);
  tc::cp_commit();

  float bias[3][2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int col = n0 + 8 * wn + 2 * tq + e;
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
      bias[hd][e] = col < D ? to_f32(heads.b[hd][(long long)a * D + col]) : 0.f;
  }
  float wacc[3][2][4];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd)
#pragma unroll
    for (int n = 0; n < 2; ++n) tc::zero4(wacc[hd][n]);
  float dbp[3][2];
#pragma unroll
  for (int hd = 0; hd < 3; ++hd) dbp[hd][0] = dbp[hd][1] = 0.f;
  float s_unused = 0.f;
  float acc[3][4];
  float run[3][4];  // f32: a run of RUN_K k steps, summed apart

  for (int q = 0; q < nq; ++q) {
    tc::cp_wait<0>();
    __syncthreads();  // tiles in; the other buffer and Gs may be rewritten
    if (q + 1 < nq) issue(q + 1);
    tc::cp_commit();
    const T* Hs = stages + (q & 1) * stage_elems;
    const T* Xs = Hs + BM2 * LDH;
    const int m0 = q / NS * BM2, j = q % NS;

    if (j == 0) {
#pragma unroll
      for (int hd = 0; hd < 3; ++hd) tc::zero4(acc[hd]);
    }
    if (j < NK && has_y) {
      // y += h W_* over the chunk's k: the stage's columns, W's rows wk..
      const int wk = KC * j;
      const int kend = min(KC, FK - wk);
      for (int kk = 0; kk < kend; kk += C::KS) {
        if constexpr (F32) {
          const float* hr = Hs + (16 * wm + gq) * LDH + kk + tq;
          const tc::SplitA Af =
              tc::split_a(hr[0], hr[8 * LDH], hr[4], hr[8 * LDH + 4]);
          const bool first = kk % (8 * RUN_K) == 0;
          const bool last =
              kk % (8 * RUN_K) == 8 * (RUN_K - 1) || kk + 8 >= kend;
#pragma unroll
          for (int hd = 0; hd < 3; ++hd) {
            const float* wc =
                Ws + hd * w_elems + (wk + kk + tq) * CW::LDW + 8 * wn + gq;
            if (first) tc::zero4(run[hd]);
            tc::mma_3xtf32(run[hd], run[hd], Af,
                           tc::split_b(wc[0], wc[4 * CW::LDW]));
            if (last) tc::add4(acc[hd], run[hd]);
          }
        } else {
          const T* hr = Hs + (16 * wm + gq) * LDH + kk + 2 * tq;
          const uint32_t Af[4] = {tc::ld_u32(hr), tc::ld_u32(hr + 8 * LDH),
                                  tc::ld_u32(hr + 8),
                                  tc::ld_u32(hr + 8 * LDH + 8)};
#pragma unroll
          for (int hd = 0; hd < 3; ++hd) {
            uint32_t b[2];
            tc::ldsm_x2_t(b, Ws + hd * w_elems +
                                 (wk + kk + (lane & 15)) * CW::LDW + 8 * wn);
            tc::mma_bf16(acc[hd], Af, b);
          }
        }
      }
    }
    if (j != NK) continue;

    // element math; db from the f32 cotangents; the rounded ones to Gs
    if (has_y) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = 16 * wm + gq + 8 * half;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cl = 8 * wn + 2 * tq + e;
          const int i = half * 2 + e;
          float g_r = 0.f, g_p = 0.f, g_z = 0.f;
          if (m0 + rl < B && n0 + cl < D) {
            const float xv = to_f32(Xs[rl * CW::LDX + cl]);
            zinb::element<false, true, TWO_DIGAMMA>(
                acc[0][i] + bias[0][e], acc[1][i] + bias[1][e],
                acc[2][i] + bias[2][e], xv, eps, one_m_eps, ga, s_unused,
                g_r, g_p, g_z);
          }
          acc[0][i] = g_r;
          acc[1][i] = g_p;
          acc[2][i] = g_z;
          dbp[0][e] += g_r;
          dbp[1][e] += g_p;
          dbp[2][e] += g_z;
        }
        const int cl = 8 * wn + 2 * tq;
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
          T* gp = Gs + hd * g_elems + (rl * CW::LDG + cl) * C::GELEM;
          if constexpr (F32) {
            uint32_t h0, l0, h1, l1;
            tc::split_tf32(acc[hd][half * 2], h0, l0);
            tc::split_tf32(acc[hd][half * 2 + 1], h1, l1);
            *reinterpret_cast<float4*>(gp) =
                make_float4(__uint_as_float(h0), __uint_as_float(l0),
                            __uint_as_float(h1), __uint_as_float(l1));
          } else {
            *reinterpret_cast<uint32_t*>(gp) =
                tc::pack_bf16(acc[hd][half * 2], acc[hd][half * 2 + 1]);
          }
        }
      }
    }
    __syncthreads();  // Gs complete

    // dW[f][col] += sum_rows h[row][f] g[row][col]: hidden units 16w.. of
    // the chunk; each step's 32 rows are summed apart and then added
    if (has_m) {
      if constexpr (F32) {
        tc::SplitA Ak[BM2 / 8];
#pragma unroll
        for (int k = 0; k < BM2 / 8; ++k) {
          // k slot t <-> row 8k+2t, slot t+4 <-> row 8k+2t+1
          const float* hc = Hs + (8 * k + 2 * tq) * LDH + f0 + gq;
          Ak[k] = tc::split_a(hc[0], hc[8], hc[LDH], hc[LDH + 8]);
        }
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int k = 0; k < BM2 / 8; ++k) {
              const float2* gc =
                  reinterpret_cast<const float2*>(Gs + hd * g_elems) +
                  (8 * k + 2 * tq) * CW::LDG + 8 * n + gq;
              const float2 g0 = gc[0], g1 = gc[CW::LDG];
              tc::SplitB Bf;
              Bf.hi[0] = __float_as_uint(g0.x);
              Bf.lo[0] = __float_as_uint(g0.y);
              Bf.hi[1] = __float_as_uint(g1.x);
              Bf.lo[1] = __float_as_uint(g1.y);
              tc::mma_3xtf32(t, u, Ak[k], Bf);
            }
            tc::add4(wacc[hd][n], t, u);
          }
        }
      } else {
        const int qd = lane >> 3;
        uint32_t Ak[BM2 / 16][4];
#pragma unroll
        for (int k = 0; k < BM2 / 16; ++k)
          tc::ldsm_x4_t(Ak[k], Hs + (16 * k + (qd >> 1) * 8 + (lane & 7)) *
                                        LDH +
                                   f0 + (qd & 1) * 8);
#pragma unroll
        for (int hd = 0; hd < 3; ++hd) {
          float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int k = 0; k < BM2 / 16; ++k) {
            uint32_t b[4];
            tc::ldsm_x4_t(b, Gs + hd * g_elems +
                                 (16 * k + (qd & 1) * 8 + (lane & 7)) *
                                     CW::LDG +
                                 (qd >> 1) * 8);
            const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
            tc::mma_bf16(t0, Ak[k], b0);
            tc::mma_bf16(t1, Ak[k], b1);
          }
          tc::add4(wacc[hd][0], t0);
          tc::add4(wacc[hd][1], t1);
        }
      }
    }
  }

  tc::cp_wait<0>();
  if (has_m) {
#pragma unroll
    for (int hd = 0; hd < 3; ++hd) {
      float* dwa = dw + ((long long)hd * A + a) * F * D;
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int f = KC * fc + f0 + gq + 8 * half;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + 8 * n + 2 * tq + e;
            if (f < F && col < D)
              dwa[(long long)f * D + col] = wacc[hd][n][half * 2 + e];
          }
        }
    }
  }

  // db (chunk 0): the sums over g of each lane group, then the two row
  // halves, in a fixed order
  __syncthreads();  // the last step's products are done with Gs
  float* red = reinterpret_cast<float*>(Gs);  // [2][3][BN2W]
  if (has_y) {
#pragma unroll
    for (int hd = 0; hd < 3; ++hd)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = dbp[hd][e];
        v += __shfl_xor_sync(0xffffffffu, v, 4);
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        if (gq == 0) red[(wm * 3 + hd) * BN2W + 8 * wn + 2 * tq + e] = v;
      }
  }
  __syncthreads();
  if (fc == 0 && tid < 3 * BN2W) {
    const int hd = tid / BN2W, c = tid % BN2W;
    if (n0 + c < D)
      db[((long long)hd * A + a) * D + n0 + c] =
          red[hd * BN2W + c] + red[(3 + hd) * BN2W + c];
  }
}

// Floats of scratch a launch needs: the loss partials, then the spilled
// dh partials.
template <typename T>
long long workspace_floats(int A, int B, int F, int D) {
  if (!shape_ok(A, B, F, D, max_f<T>())) return -1;
  const RowPlan p = plan<T>(A, B, D);
  return (long long)A * p.row_tiles * p.n_split +
         (long long)p.n_spill * A * B * F;
}

template <typename T, bool SEPARATE, int FT, bool WIDE>
int launch_rows(const Args& p, const Heads<T>& heads, const float* g,
                const RowPlan& plan, float* work, float* dh, float* dw,
                int vec_h, int vec_d, cudaStream_t st) {
  Partials parts;
  parts.dh = dh;
  parts.in_dw = dw;
  parts.stride = (long long)p.A * p.B * p.F;
  parts.n_in_dw = plan.n_in_dw;
  parts.spill = work + (long long)p.A * plan.row_tiles * plan.n_split;
  auto kern = zinb_rows<T, !SEPARATE, SEPARATE, FT, WIDE>;
  const size_t smem = smem_rows<T>(p.F, true, WIDE);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nch = WIDE ? n_chunks(fk<T>(p.F)) : 1;  // chunks of dh
  const dim3 grid(plan.row_tiles, p.A, plan.n_split * nch);
  kern<<<grid, THREADS1, smem, st>>>(
      static_cast<const T*>(p.h), heads, static_cast<const T*>(p.x),
      p.x_arm_stride, g, p.B, p.F, p.D, plan.cols_per_split, plan.n_split,
      p.eps, p.one_m_eps, vec_h, vec_d, work, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.n_split == 1) return (int)err;
  const long long n = parts.stride;
  zinb_dh_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      parts, plan.n_split, n);
  return (int)cudaGetLastError();
}

// Pass 2: the resident form for F <= FP, else the wide one.
template <typename T, bool SEPARATE>
int launch_cols(const Args& p, const Heads<T>& heads, const float* g,
                int vec_h, int vec_d, float* dw, float* db, cudaStream_t st) {
  const bool wide = p.F > FP;
  auto kern = wide ? &zinb_cols_wide<T, SEPARATE> : &zinb_cols<T, SEPARATE>;
  const size_t smem = wide ? smem_cols_wide<T>(p.F) : smem_cols<T>(p.F);
  cudaError_t ce = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 g2(wide ? (p.D + BN2W - 1) / BN2W : (p.D + BN2 - 1) / BN2, p.A,
                wide ? n_chunks(fk<T>(p.F)) : 1);
  kern<<<g2, THREADS2, smem, st>>>(
      static_cast<const T*>(p.h), heads, static_cast<const T*>(p.x),
      p.x_arm_stride, g, p.A, p.B, p.F, p.D, p.eps, p.one_m_eps, vec_h, vec_d,
      dw, db);
  return (int)cudaGetLastError();
}

// SEPARATE: the backward for a given cotangent g (no loss, two digamma
// calls); else loss and unscaled gradients.
template <typename T, bool SEPARATE>
int launch(const Args& p, const void* g, void* work, void* out, void* dh,
           void* dw, void* db, void* stream) {
  if (!shape_ok(p.A, p.B, p.F, p.D, max_f<T>()))
    return (int)cudaErrorInvalidValue;
  const RowPlan plan_ = plan<T>(p.A, p.B, p.D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Heads<T> heads = heads_of<T>(p);
  const float* gp = static_cast<const float*>(g);
  float* wk = static_cast<float*>(work);
  float* dhp = static_cast<float*>(dh);
  float* dwp = static_cast<float*>(dw);
  const int vec_h = vec_h_of<T>(p);
  const int vec_d = vec_of<T>(p);
  int e = p.F <= 104
          ? launch_rows<T, SEPARATE, 13, false>(p, heads, gp, plan_, wk, dhp,
                                                dwp, vec_h, vec_d, st)
      : p.F <= FP
          ? launch_rows<T, SEPARATE, 16, false>(p, heads, gp, plan_, wk, dhp,
                                                dwp, vec_h, vec_d, st)
          : launch_rows<T, SEPARATE, 16, true>(p, heads, gp, plan_, wk, dhp,
                                               dwp, vec_h, vec_d, st);
  if (e) return e;
  e = launch_cols<T, SEPARATE>(p, heads, gp, vec_h, vec_d, dwp,
                               static_cast<float*>(db), st);
  if (e || SEPARATE) return e;
  zinb_loss_reduce<<<p.A, REDUCE_THREADS, 0, st>>>(
      wk, plan_.row_tiles * plan_.n_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Floats of scratch one launch needs (loss partials and any dh partials
// beyond the dW buffer's room); -1 if the shape is refused.
long long zinb_fwdbwd_workspace(int bf16, int A, int B, int F, int D) {
  return bf16 ? workspace_floats<__nv_bfloat16>(A, B, F, D)
              : workspace_floats<float>(A, B, F, D);
}

// Largest hidden width F the kernels take in f32 (bf16 0) or bf16: past
// 128 the wide forms' shared memory sets it (max_f).
int zinb_fwdbwd_max_f(int bf16) {
  return bf16 ? max_f<__nv_bfloat16>() : max_f<float>();
}

int zinb_fwdbwd_f32(ZINB_ARGS, void* work, void* out, void* dh, void* dw,
                    void* db, void* stream) {
  return launch<float, false>(ZINB_PACK, nullptr, work, out, dh, dw, db,
                              stream);
}

int zinb_fwdbwd_bf16(ZINB_ARGS, void* work, void* out, void* dh, void* dw,
                     void* db, void* stream) {
  return launch<__nv_bfloat16, false>(ZINB_PACK, nullptr, work, out, dh, dw,
                                      db, stream);
}

int zinb_bwd_f32(const void* g, ZINB_ARGS, void* work, void* dh, void* dw,
                 void* db, void* stream) {
  return launch<float, true>(ZINB_PACK, g, work, nullptr, dh, dw, db,
                             stream);
}

int zinb_bwd_bf16(const void* g, ZINB_ARGS, void* work, void* dh, void* dw,
                  void* db, void* stream) {
  return launch<__nv_bfloat16, true>(ZINB_PACK, g, work, nullptr, dh, dw, db,
                                     stream);
}

}  // extern "C"
