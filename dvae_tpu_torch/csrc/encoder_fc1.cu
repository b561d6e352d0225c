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
//   forward  2*A*B*D*F = 25.2 GFLOP -> 0.051 ms at the TF32 peak (495
//            TFLOP/s) for f32 operands taken as one TF32 product, 0.025 ms
//            at the bf16 peak (989 TFLOP/s); bytes: x read once (101 MB
//            f32) -> 0.030 ms.  The 3xTF32 split triples the tf32 work.
//            The keep-mask adds a floor of its own: one Philox4x32-10 call
//            (about 90 integer instructions) per aligned group of four x
//            elements, 3.1e7 calls per forward, which `encoder_mask_u8`
//            (the same device function, 126 MB of uint8 out) times.
//   backward the same product count -> 0.051 ms (TF32) / 0.025 ms (bf16);
//            bytes: x and g read once, dW1 written once (121 MB f32).
//            The same Philox floor when the mask is drawn in the kernel.
// The forward (`encoder_fwd_tiles`) runs on the tensor cores: `mma.sync`
// m16n8k8 with the 3xTF32 split for f32 operands (csrc/mma.cuh; plain TF32
// would keep three digits), m16n8k16 for bf16, f32 accumulation.  Blocks
// own (arm, 64-row tile, 104-column tile of F: F=100 rounded up to 8, not
// 128) and walk D 32 deep; x and W1 stages arrive by cp.async in a ring of
// three, and the mask is applied to the landed x stage in shared memory
// (one Philox call per aligned group of four columns, as before), so the
// draw overlaps the copies in flight and the other blocks' products
// instead of stalling the loads.  68 KB of shared memory (f32) a block,
// three blocks of 4 warps an SM: 395 blocks make one wave of 132 SMs.
// The backward (`encoder_bwd_tiles`) runs on the tensor cores too, with
// the same building blocks: blocks own (arm, 64-gene tile of D, the
// 104-column tile of F) and walk every row of the batch, 32 (f32) or 64
// (bf16) rows a stage, so dW1 needs no reduction across blocks (the TPU
// kernel keeps the whole (A, D, F) accumulator in VMEM, :199-202) and
// repeated launches are bit-identical; the arm is the fastest grid axis,
// so a shared x stage is served to the A arms' blocks from L2.  db1 is
// summed by the blocks of the first gene tile, in row order.  Ragged B
// (the 2,000-row tail) and ragged D are masked: rows and columns outside
// the arrays are never read and add exactly 0.  Its note below says how
// the transposed operand and the split of g are read.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"     // mma.sync, cp.async
#include "philox.cuh"  // philox4x32_10

namespace {

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

// ---------------------------------------------------------------------------
// Forward (#4): tensor-core tiles
// ---------------------------------------------------------------------------
// Block (104-column tile of F, 64-row tile, arm) of 4 warps, each warp 16
// rows x 104 columns (13 accumulator tiles).  The x and W1 stages (32 deep)
// arrive by cp.async in a ring of three; the keep-mask is applied to the
// landed x stage in shared memory, one Philox call per aligned group of
// four columns, while the next stages are in flight; then the stage's
// products run on the tensor cores (3xTF32 m16n8k8 for f32, m16n8k16 for
// bf16).
constexpr int EM = 64, EN = 104, ENT = EN / 8, EK = 32;
constexpr int ESTAGES = 3, ETHREADS = 128;

template <typename T>
struct ECfg;
template <>
struct ECfg<float> {
  static constexpr int LDX = EK + 4;  // A loads: (4g + t) distinct banks
  static constexpr int LDW = EN;      // B loads: (8t + g) distinct banks
};
template <>
struct ECfg<__nv_bfloat16> {
  static constexpr int LDX = EK + 8;  // 20-word rows: distinct banks
  static constexpr int LDW = EN;      // 13 16-byte groups: ldmatrix rows
};

template <typename T>
__host__ __device__ constexpr int estage_elems() {
  return EM * ECfg<T>::LDX + EK * ECfg<T>::LDW;
}
template <typename T>
constexpr size_t esmem_bytes() {
  return sizeof(T) * (size_t)ESTAGES * estage_elems<T>();
}

// An x stage of ROWS x COLS in place (pitch LD, NT threads): x (.) mask /
// keep rounded to T, zero where dropped; row0/col0 place it in (B, D).
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void mask_stage(T* Xs,
                                           const uint8_t* __restrict__ mask,
                                           int mode, uint32_t seed,
                                           uint32_t thr, float sc, int a,
                                           int row0, int col0, int B, int D,
                                           int tid) {
  constexpr int G4 = COLS / 4;
  for (int i = tid; i < ROWS * G4; i += NT) {
    const int r = i / G4, c = (i % G4) * 4;
    const int row = row0 + r, col = col0 + c;
    if (row >= B || col >= D) continue;  // zero-filled already
    unsigned keep;
    if (mode == MODE_PHILOX) {
      keep = keep4(seed, a, row, col >> 2, thr);
    } else {
      const uint8_t* mr = mask + ((long long)a * B + row) * D + col;
      keep = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (col + j < D && mr[j] != 0) keep |= 1u << j;
    }
    T* xr = Xs + r * LD + c;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xr[j] = ((keep >> j) & 1u) ? from_f32<T>(to_f32(xr[j]) * sc)
                                 : from_f32<T>(0.f);
  }
}

// Forward: grid (ceil(F/EN), ceil(B/EM), A).
template <typename T>
__global__ void __launch_bounds__(ETHREADS, 3)
encoder_fwd_tiles(const T* __restrict__ x, long long x_arm_stride,
                  const T* __restrict__ w, const T* __restrict__ bias,
                  const uint8_t* __restrict__ mask, int mode, uint32_t seed,
                  uint32_t thr, float scale, int B, int D, int F, int vec_x,
                  int vec_w, T* __restrict__ y) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int LDX = ECfg<T>::LDX, LDW = ECfg<T>::LDW;
  extern __shared__ __align__(16) unsigned char esmem[];
  T* const stages = reinterpret_cast<T*>(esmem);

  const int a = blockIdx.z;
  const int m0 = blockIdx.y * EM;
  const int n0 = blockIdx.x * EN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const T* xa = x + (long long)a * x_arm_stride;
  const T* wa = w + (long long)a * D * F;
  const float sc = to_f32(from_f32<T>(scale));
  const int nsteps = (D + EK - 1) / EK;

  auto issue = [&](int step) {
    T* st = stages + (step % ESTAGES) * estage_elems<T>();
    const int k0 = step * EK;
    tc::load_tile(st, LDX, xa + (long long)m0 * D + k0, D, EM, EK, B - m0,
                  D - k0, vec_x, tid, ETHREADS);
    tc::load_tile(st + EM * LDX, LDW, wa + (long long)k0 * F + n0, F, EK, EN,
                  D - k0, F - n0, vec_w, tid, ETHREADS);
  };
  // The ring runs one stage ahead of the products: step s masks stage
  // s+1 (landed) and multiplies stage s (masked in step s-1) while stage
  // s+2 is in flight, with one barrier a step, so that the warps of a
  // block drift apart and the Philox draw of some overlaps the products of
  // others.
  static_assert(ESTAGES == 3, "the ring is masked one stage ahead");
  auto masked = [&](int step) {
    if (mode != MODE_IDENTITY && step < nsteps)
      mask_stage<T, EM, EK, ECfg<T>::LDX, ETHREADS>(
          stages + (step % ESTAGES) * estage_elems<T>(), mask, mode, seed,
          thr, sc, a, m0, step * EK, B, D, tid);
  };
  issue(0);
  tc::cp_commit();
  if (nsteps > 1) issue(1);
  tc::cp_commit();
  tc::cp_wait<1>();
  __syncthreads();
  masked(0);

  float acc[ENT][4];
#pragma unroll
  for (int n = 0; n < ENT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int step = 0; step < nsteps; ++step) {
    tc::cp_wait<0>();  // stage step+1 is in
    __syncthreads();   // stage step is masked; stage step-1's buffer is free
    if (step + 2 < nsteps) issue(step + 2);
    tc::cp_commit();
    masked(step + 1);
    const T* Xs = stages + (step % ESTAGES) * estage_elems<T>();
    const T* Ws = Xs + EM * LDX;
    // the stage's 32-deep products are summed apart and then added to the
    // accumulators (tc::add4)
    const T* xr = Xs + (16 * warp + gq) * LDX;
    if constexpr (F32) {
      tc::SplitA Ak[EK / 8];
#pragma unroll
      for (int k = 0; k < EK / 8; ++k) {
        const float* ar = xr + 8 * k + tq;
        Ak[k] = tc::split_a(ar[0], ar[8 * LDX], ar[4], ar[8 * LDX + 4]);
      }
#pragma unroll
      for (int n = 0; n < ENT; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < EK / 8; ++k) {
          const float* wr = Ws + (8 * k + tq) * LDW + 8 * n + gq;
          tc::mma_3xtf32(t, u, Ak[k], tc::split_b(wr[0], wr[4 * LDW]));
        }
        tc::add4(acc[n], t, u);
      }
    } else {
      const int q = lane >> 3;
      uint32_t Ak[EK / 16][4];
#pragma unroll
      for (int k = 0; k < EK / 16; ++k) {
        const T* ar = xr + 16 * k + 2 * tq;
        Ak[k][0] = tc::ld_u32(ar);
        Ak[k][1] = tc::ld_u32(ar + 8 * LDX);
        Ak[k][2] = tc::ld_u32(ar + 8);
        Ak[k][3] = tc::ld_u32(ar + 8 * LDX + 8);
      }
#pragma unroll
      for (int n = 0; n + 1 < ENT; n += 2) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < EK / 16; ++k) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, Ws + (16 * k + (q & 1) * 8 + (lane & 7)) * LDW +
                               (n + (q >> 1)) * 8);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          tc::mma_bf16(t0, Ak[k], b0);
          tc::mma_bf16(t1, Ak[k], b1);
        }
        tc::add4(acc[n], t0);
        tc::add4(acc[n + 1], t1);
      }
      float t[4] = {0.f, 0.f, 0.f, 0.f};  // the odd last tile
#pragma unroll
      for (int k = 0; k < EK / 16; ++k) {
        uint32_t b[2];
        tc::ldsm_x2_t(b, Ws + (16 * k + (lane & 15)) * LDW + (ENT - 1) * 8);
        tc::mma_bf16(t, Ak[k], b);
      }
      tc::add4(acc[ENT - 1], t);
    }
  }
  tc::cp_wait<0>();

  const T* ba = bias + (long long)a * F;
#pragma unroll
  for (int n = 0; n < ENT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * n + 2 * tq + e;
      if (col >= F) continue;
      const float bj = to_f32(ba[col]);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + 16 * warp + gq + 8 * half;
        if (row < B)
          y[((long long)a * B + row) * F + col] =
              from_f32<T>(acc[n][half * 2 + e] + bj);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward (#5): tensor-core tiles
// ---------------------------------------------------------------------------
// dW1_a[gene][f] = sum_rows xd_a[row][gene] g_a[row][f]: the contraction
// runs over the rows, so the A operand is the dropped x transposed (M =
// genes, K = rows) and B is g (K = rows, N = f).  Block (arm, 64-gene tile
// of D, 104-column tile of F) of 4 warps, each warp 16 genes x 104 columns
// (13 accumulator tiles); the block walks every row of the batch, so dW1
// needs no reduction across blocks and repeats are bit-identical.  The arm
// is the fastest grid axis: the A blocks of one gene tile run together and
// a shared x stage comes from L2, not A times from HBM.
//
// x and g stages (32 rows f32, 64 bf16) arrive by cp.async in a ring of
// three, zero-filled beyond B, D and F, so rows past the ragged tail are
// never read and add exactly 0.  Each step prepares the landed stage s+1
// (the keep-mask applied to x in shared memory, one Philox call per
// aligned group of four genes; db1 summed from g by the blocks of gene
// tile 0, one column a thread, in row order) before the products of stage
// s, with one barrier a step.  Products: f32 A fragments read by scalar
// ld.shared at Xs[k][m] (pitch 72 = 8 mod 32 words: a warp's 32 loads on
// distinct banks), both operands split into tf32 halves by the warp that
// reads them; bf16 both by ldmatrix.trans.  Each stage's products are
// summed from zero and added to the accumulators rounded to nearest
// (tc::add4).  Measured on the H100 (PERF.md §6): splitting g once a stage
// into {hi, lo} pairs in shared memory, as #7's column pass does, was
// slower than splitting it in each warp, because the pairs' room forces
// 16-row stages at three blocks an SM, and deeper stages pay more than the
// split saves.  68 KB of shared memory a block (f32 and bf16), three
// blocks of 4 warps an SM: the 395 blocks of the production shape make
// one wave of 132 SMs.
template <typename T>
struct BCfg;
template <>
struct BCfg<float> {
  static constexpr int RK = 32;    // rows a stage
  static constexpr int LDX = 72;   // A loads: (8t + g) distinct banks
  static constexpr int LDG = 104;  // B loads: (8t + g) distinct banks
};
template <>
struct BCfg<__nv_bfloat16> {
  static constexpr int RK = 64;
  static constexpr int LDX = 72;   // 144-byte rows: ldmatrix rows distinct
  static constexpr int LDG = 104;  // 13 16-byte groups: ldmatrix rows
};
constexpr int BD = 64, BN = EN, BNT = ENT;  // genes and F columns a block
constexpr int BSTAGES = 3, BTHREADS = 128;

template <typename T>
__host__ __device__ constexpr int bstage_elems() {
  return BCfg<T>::RK * (BCfg<T>::LDX + BCfg<T>::LDG);
}
template <typename T>
constexpr size_t bsmem_bytes() {
  return sizeof(T) * (size_t)BSTAGES * bstage_elems<T>();
}

// Backward: grid (A, ceil(D/BD), ceil(F/BN)).
template <typename T>
__global__ void __launch_bounds__(BTHREADS, 3)
encoder_bwd_tiles(const T* __restrict__ x, long long x_arm_stride,
                  const T* __restrict__ g, const uint8_t* __restrict__ mask,
                  int mode, uint32_t seed, uint32_t thr, float scale, int B,
                  int D, int F, int vec_x, int vec_g, float* __restrict__ dw,
                  float* __restrict__ db) {
  using C = BCfg<T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr int RK = C::RK, LDX = C::LDX, LDG = C::LDG;
  extern __shared__ __align__(16) unsigned char bsmem[];
  T* const stages = reinterpret_cast<T*>(bsmem);

  const int a = blockIdx.x;
  const int d0 = blockIdx.y * BD;
  const int n0 = blockIdx.z * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int mw = 16 * warp;  // the warp's genes of the tile
  const T* xa = x + (long long)a * x_arm_stride;
  const T* ga = g + (long long)a * B * F;
  const bool sums_db = blockIdx.y == 0;
  const float sc = to_f32(from_f32<T>(scale));
  const int nsteps = (B + RK - 1) / RK;

  auto issue = [&](int step) {
    T* st = stages + (step % BSTAGES) * bstage_elems<T>();
    const int r0 = step * RK;
    tc::load_tile_c<BD, BTHREADS>(st, LDX, xa + (long long)r0 * D + d0, D,
                                  RK, B - r0, D - d0, vec_x, tid);
    tc::load_tile_c<BN, BTHREADS>(st + RK * LDX, LDG,
                                  ga + (long long)r0 * F + n0, F, RK, B - r0,
                                  F - n0, vec_g, tid);
  };
  float dbs = 0.f;  // column n0 + tid of db1, threads tid < BN
  // the landed stage ready for the products: x masked; g summed into db1
  // by the blocks of gene tile 0, one column a thread, in row order
  auto prepare = [&](int step) {
    T* Xs = stages + (step % BSTAGES) * bstage_elems<T>();
    if (mode != MODE_IDENTITY)
      mask_stage<T, RK, BD, LDX, BTHREADS>(Xs, mask, mode, seed, thr, sc, a,
                                           step * RK, d0, B, D, tid);
    if (sums_db && tid < BN) {
      const T* gc = Xs + RK * LDX + tid;
#pragma unroll 4
      for (int k = 0; k < RK; ++k) dbs += to_f32(gc[k * LDG]);
    }
  };

  issue(0);
  tc::cp_commit();
  if (nsteps > 1) issue(1);
  tc::cp_commit();
  tc::cp_wait<1>();
  __syncthreads();
  prepare(0);

  float acc[BNT][4];
#pragma unroll
  for (int n = 0; n < BNT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  static_assert(BSTAGES == 3, "the ring is prepared one stage ahead");
  for (int step = 0; step < nsteps; ++step) {
    tc::cp_wait<0>();  // stage step+1 is in
    __syncthreads();   // stage step is prepared; step-1's buffers are free
    if (step + 2 < nsteps) issue(step + 2);
    tc::cp_commit();
    if (step + 1 < nsteps) prepare(step + 1);
    const T* Xs = stages + (step % BSTAGES) * bstage_elems<T>();
    const T* Gs = Xs + RK * LDX;
    if constexpr (F32) {
      tc::SplitA Ak[RK / 8];
#pragma unroll
      for (int k = 0; k < RK / 8; ++k) {
        const float* ac = Xs + (8 * k + tq) * LDX + mw + gq;
        Ak[k] = tc::split_a(ac[0], ac[8], ac[4 * LDX], ac[4 * LDX + 8]);
      }
#pragma unroll
      for (int n = 0; n < BNT; ++n) {
        float t[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < RK / 8; ++k) {
          const float* gr = Gs + (8 * k + tq) * LDG + 8 * n + gq;
          tc::mma_3xtf32(t, u, Ak[k], tc::split_b(gr[0], gr[4 * LDG]));
        }
        tc::add4(acc[n], t, u);
      }
    } else {
      const int q = lane >> 3;
      uint32_t Ak[RK / 16][4];
#pragma unroll
      for (int k = 0; k < RK / 16; ++k)
        tc::ldsm_x4_t(Ak[k], Xs + (16 * k + (q >> 1) * 8 + (lane & 7)) * LDX +
                                 mw + (q & 1) * 8);
#pragma unroll
      for (int n = 0; n + 1 < BNT; n += 2) {
        float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int k = 0; k < RK / 16; ++k) {
          uint32_t b[4];
          tc::ldsm_x4_t(b, Gs + (16 * k + (q & 1) * 8 + (lane & 7)) * LDG +
                               (n + (q >> 1)) * 8);
          const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
          tc::mma_bf16(t0, Ak[k], b0);
          tc::mma_bf16(t1, Ak[k], b1);
        }
        tc::add4(acc[n], t0);
        tc::add4(acc[n + 1], t1);
      }
      float t[4] = {0.f, 0.f, 0.f, 0.f};  // the odd last tile
#pragma unroll
      for (int k = 0; k < RK / 16; ++k) {
        uint32_t b[2];
        tc::ldsm_x2_t(b, Gs + (16 * k + (lane & 15)) * LDG + (BNT - 1) * 8);
        tc::mma_bf16(t, Ak[k], b);
      }
      tc::add4(acc[BNT - 1], t);
    }
  }
  tc::cp_wait<0>();

  float* dwa = dw + (long long)a * D * F;
#pragma unroll
  for (int n = 0; n < BNT; ++n) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + 8 * n + 2 * tq + e;
      if (col >= F) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gene = d0 + mw + gq + 8 * half;
        if (gene < D) dwa[(long long)gene * F + col] = acc[n][half * 2 + e];
      }
    }
  }
  if (sums_db && tid < BN && n0 + tid < F)
    db[(long long)a * F + n0 + tid] = dbs;
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

template <typename T>
int launch_fwd(const void* x, long long x_arm_stride, const void* w,
               const void* bias, const void* mask, int mode, unsigned seed,
               unsigned thr, float scale, int A, int B, int D, int F, void* y,
               void* stream) {
  if (A > 65535 || (B + EM - 1) / EM > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = esmem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      encoder_fwd_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int es = (int)sizeof(T);
  const int vec_x = tc::chunk_bytes(x, D, es, x_arm_stride);
  const int vec_w = tc::chunk_bytes(w, F, es, (long long)D * F);
  const dim3 grid((F + EN - 1) / EN, (B + EM - 1) / EM, A);
  encoder_fwd_tiles<T><<<grid, ETHREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), x_arm_stride, static_cast<const T*>(w),
      static_cast<const T*>(bias), static_cast<const uint8_t*>(mask), mode,
      seed, thr, scale, B, D, F, vec_x, vec_w, static_cast<T*>(y));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* x, long long x_arm_stride, const void* g,
               const void* mask, int mode, unsigned seed, unsigned thr,
               float scale, int A, int B, int D, int F, void* dw, void* db,
               void* stream) {
  if ((D + BD - 1) / BD > 65535 || (F + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidConfiguration;
  const size_t smem = bsmem_bytes<T>();
  cudaError_t e = cudaFuncSetAttribute(
      encoder_bwd_tiles<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int es = (int)sizeof(T);
  const int vec_x = tc::chunk_bytes(x, D, es, x_arm_stride);
  const int vec_g = tc::chunk_bytes(g, F, es, (long long)B * F);
  const dim3 grid(A, (D + BD - 1) / BD, (F + BN - 1) / BN);
  encoder_bwd_tiles<T><<<grid, BTHREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), x_arm_stride, static_cast<const T*>(g),
      static_cast<const uint8_t*>(mask), mode, seed, thr, scale, B, D, F,
      vec_x, vec_g, static_cast<float*>(dw), static_cast<float*>(db));
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
