// Fused three-head ZINB loss of the training step: the per-arm loss sum
// AND its gradients with respect to the decoder hidden h and the three
// output layers, without materialising the pre-activations or r/p/z.
// Hand-written for Hopper (sm_90a), bound with ctypes.  Two entry points
// share the code:
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
// order r, p, z.  F up to zinb_fwdbwd_max_f (784 f32, 1,456 bf16: the row
// pass's resident h tile).
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
// finishes both.  Two passes, the element math once:
//   pass 1, `zinb_rows` (csrc/zinb_rows.cuh, whose value-only form is the
//     forward #6 of zinb_fwd.cu), blocks (64-row tile, arm, slice of D) of
//     4 warps, each warp 16 rows, walking the slice 8 (f32) or 16 (bf16)
//     columns a step: three y tiles = h W_* (K = F), the element math (loss
//     partials, cotangents), then dh += sum_heads g_* W_*^T with the
//     cotangents taken straight from the y accumulators in registers as A
//     fragments; dh stays in registers for the walk.  It also stores the
//     three cotangents, f32 and unrounded, transposed into the workspace
//     (g[(head * A + a) * D + d][b], rows of B rounded up to 4 floats).
//     The slices of D (4 at the production shape, chosen from the shape so
//     that the grid fills whole waves of an H100; `plan`) each leave a dh
//     partial; slice 0 writes dh, the others the dW buffer, which pass 2
//     overwrites later (a spill buffer only beyond its room), and
//     `zinb_dh_reduce` adds them in slice order;
//   pass 2, the product dW_*^T = g_*^T h over K = B on `wgmma`
//     (csrc/wgmma.cuh): `zinb_cols_prep` writes h^T once into the workspace
//     as K-major tiles of NT = 104 hidden units by KB = 32 rows of B (for
//     f32 split there into its tf32 halves hi + lo, as recon_fwd.cu's prep
//     does), then `zinb_cols_wgmma`, blocks (64 columns of D, arm, range of
//     NT hidden units) of three warpgroups, one a head: a ring of stages,
//     each the three heads' g tiles (TMA boxes of 32 x 64 with the 128-byte
//     swizzle) and the h^T tile (one bulk copy), filled by one thread of the
//     block as the warpgroups release them (mbarriers).  Each warpgroup
//     reads its g tile into registers as the A fragments of m64n104 (for
//     f32 split into tf32 halves there, three products a k step: lo hi, hi
//     hi, hi lo; for bf16 rounded to bf16 there, as pass 1 rounds them for
//     dh), sums db from the same unrounded values, and runs the stage's
//     products into a run accumulator started from zero, which then joins
//     the block's sums rounded to nearest (csrc/mma.cuh add4; one run = one
//     stage = 4 k steps of 8, or 2 of 16).  The k order inside a stage is
//     permuted on both sides (the prep's `k_row`), so that a thread's A
//     values of a stage are 8 consecutive rows of B: two 16-byte reads a
//     row, on distinct banks under the swizzle.
// Products: pass 1 `mma.sync` (csrc/mma.cuh), m16n8k16 bf16 for bf16
// operands and 3xTF32 m16n8k8 for f32 ones; pass 2 `wgmma` m64n104k16 bf16
// or 3xTF32 m64n104k8; f32 accumulation.  Sums of the tensor cores round
// toward zero, so runs of a few k steps are summed from zero and then
// added to the long-lived accumulators.
// F up to FP (128) runs pass 1's resident form; a wider F its wide form,
// which walks F in chunks of KC = 128 (zinb_rows.cuh).  Pass 2 covers F in
// ranges of NT on the grid's z axis (range 0 writes db), so it takes any F.
// Workspace (the wrapper's, one allocation; `layout`): the loss partials,
// the spilled dh partials (none at the production shape), the stored
// cotangents 3*A*D*ceil4(B)*4 bytes, the prepared h^T A*ceil(B/32)*ranges
// *NT*32*(8 f32, 2 bf16) bytes; at the production shape 1,530,506,240
// bytes in f32 (g 1,509,600,000, h^T 20,899,840), 1,514,831,360 in bf16.
// Occupancy: pass 1 four blocks of 4 warps an SM (52 KB of shared memory a
// block at F=100) at the 128-register cap; pass 2 one block of 12 warps an
// SM (four stages of 51,200 bytes in f32, six of 31,744 in bf16).  No
// atomics; every sum runs in a fixed order that depends on the shape
// alone, so repeated launches are bit-identical, on any card.
// Measured on an H100 80GB HBM3 at 700 W, production shape, CUDA events:
// f32 9.41-9.44 ms a launch (device: rows 8.72-8.76, prep 0.026, products
// 0.657-0.658, reductions 0.027), where the column pass that rebuilt y and
// the element math took 15.22 (rows 8.37, columns 6.97-6.99); bf16
// 5.34-5.38 ms (rows 4.71-4.73, prep 0.016, products 0.539) against 7.75-
// 7.78.  The products run at 73% of their bound (1.51 GB of g read at
// 3.35 TB/s, 0.45 ms, beside 0.48 ms of 3xTF32 products at N = 104);
// the row pass's stores of g cost it 0.35 ms (f32).  PERF.md §6, row 7.

#include "zinb_rows.cuh"  // pass 1, the plan, the loss reduction
#include "wgmma.cuh"

namespace {

// ---- pass 2 ------------------------------------------------------------

constexpr int NT = 104;       // hidden units of a range: N of m64n104
constexpr int KB = 32;        // rows of B a stage: a 128-byte row of g
constexpr int TM = 64;        // columns of D a block: M of m64n104
constexpr int CTHREADS = 384;  // three warpgroups, one a head
constexpr int MAX_STAGES2 = 6;
constexpr int COLS_SMEM = 225 * 1024;       // dynamic shared memory a block
constexpr uint32_t G_TILE = TM * KB * 4;    // one head's g tile, bytes

template <typename T>
struct ColT;
template <>
struct ColT<float> {
  static constexpr int PLANES = 2;  // tf32 hi and lo
};
template <>
struct ColT<__nv_bfloat16> {
  static constexpr int PLANES = 1;
};

// elements of one prepared h^T tile, every plane
template <typename T>
__host__ __device__ constexpr long long ht_tile() {
  return (long long)ColT<T>::PLANES * NT * KB;
}
// a stage: the three g tiles, then the h^T tile; 1,024-byte aligned (the
// swizzle's atom)
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (int)((3 * G_TILE + ht_tile<T>() * sizeof(T) + 1023) / 1024 * 1024);
}

// The row of B, within a stage's KB, that the prep puts at K position k of
// a tile: f32 k step s = k / 8 holds rows 8 t + 2 s (slot t < 4) and
// 8 t + 2 s + 1 (slot t + 4); bf16 k step s = k / 16 holds rows 8 t + 4 s
// + {0, 1} (slots 2 t, 2 t + 1) and 8 t + 4 s + {2, 3} (slots 2 t + 8,
// 2 t + 9).  So lane t's A values of the stage are rows 8 t .. 8 t + 7.
template <typename T>
__host__ __device__ inline int k_row(int k) {
  if constexpr (std::is_same<T, float>::value) {
    const int s = k / 8, j = k % 8;
    return 8 * (j % 4) + 2 * s + j / 4;
  } else {
    const int s = k / 16, j = k % 16;
    return 8 * ((j % 8) / 2) + 4 * s + 2 * (j / 8) + (j % 2);
  }
}

// Everything of pass 2 that follows from the shape alone.
struct ColPlan {
  long long pitch;  // floats a row of stored g: B rounded up to 4
  int nkc;          // stages' worth of rows of B
  int n_ranges;     // ranges of NT hidden units
  int stages;
  size_t smem;
};

template <typename T>
ColPlan col_plan(int B, int F) {
  ColPlan c;
  c.pitch = ((long long)B + 3) / 4 * 4;
  c.nkc = (int)(((long long)B + KB - 1) / KB);
  c.n_ranges = (F + NT - 1) / NT;
  c.stages = (COLS_SMEM - 1024) / stage_bytes<T>();
  if (c.stages > MAX_STAGES2) c.stages = MAX_STAGES2;
  c.smem = 1024 + (size_t)c.stages * stage_bytes<T>();
  return c;
}

inline long long align256(long long bytes) {
  return (bytes + 255) / 256 * 256;
}

// The workspace: the loss partials, the spilled dh partials, the stored
// cotangents, the prepared h^T; byte offsets, each a multiple of 256.
struct Layout {
  long long part, spill, g, ht, bytes;
};

template <typename T>
Layout layout(int A, int B, int F, int D) {
  const RowPlan p = plan<T>(A, B, D);
  const ColPlan c = col_plan<T>(B, F);
  Layout l;
  l.part = 0;
  l.spill = align256((long long)A * p.row_tiles * p.n_split * 4);
  l.g = l.spill + align256((long long)p.n_spill * A * B * F * 4);
  l.ht = l.g + align256(3LL * A * D * c.pitch * 4);
  l.bytes = l.ht + align256((long long)A * c.nkc * c.n_ranges *
                            ht_tile<T>() * (long long)sizeof(T));
  return l;
}

// Largest F the training kernels take: the row pass's (pass 2 takes any).
template <typename T>
int max_f() {
  return max_f_rows<T>(true);
}

// The row pass's shapes, with every row (head, arm, column) of the stored
// g within a TMA coordinate.
template <typename T>
bool shape_ok_fwdbwd(int A, int B, int F, int D) {
  return shape_ok(A, B, F, D, max_f<T>()) &&
         3LL * A * D <= 0x7fffffffLL - TM;
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
// Pass 2, prep: one thread a 16-byte group of the workspace (E16 K values
// of one hidden unit, every plane).  Tile (a, chunk c, range r) holds the
// hidden units NT r.. and rows KB c.. of B; within a plane, element (n, k)
// lies at ((n / 8) (KB / E16) + k / E16) 8 + n % 8) E16 + k % E16 (core
// matrices of 8 x 16 bytes, K-major, no swizzle), and holds h[a][KB c +
// k_row(k)][NT r + n], zero outside B x F.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(256)
zinb_cols_prep(const T* __restrict__ h, int B, int F, int nkc, int n_ranges,
               long long groups, T* __restrict__ ht) {
  constexpr int P = ColT<T>::PLANES;
  constexpr int E16 = 16 / (int)sizeof(T);
  constexpr int KCM = KB / E16;  // core matrices along a tile's K
  constexpr long long plane = (long long)NT * KB;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < groups; i += (long long)gridDim.x * blockDim.x) {
    long long q = i;
    const int rr = (int)(q % 8);
    q /= 8;
    const int cm = (int)(q % KCM);
    q /= KCM;
    const int rg = (int)(q % (NT / 8));
    q /= NT / 8;
    const int r = (int)(q % n_ranges);
    q /= n_ranges;
    const int c = (int)(q % nkc);
    const long long a = q / nkc;
    const int f = r * NT + rg * 8 + rr;
    T* out = ht + ((a * nkc + c) * n_ranges + r) * (P * plane) +
             ((long long)(rg * KCM + cm) * 8 + rr) * E16;
    const T* src = h + a * B * F + f;
#pragma unroll
    for (int e = 0; e < E16; ++e) {
      const long long b = (long long)c * KB + k_row<T>(cm * E16 + e);
      const T v = (b < B && f < F) ? src[b * F] : T(0.f);
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

// ---------------------------------------------------------------------------
// Pass 2, products: grid (ceil(D/TM), A, ranges), CTHREADS threads;
// warpgroup w is head w.  Stage s of chunk c (KB rows of B) is c % stages:
// full[s] completes when its bytes are in, empty[s] when the three
// warpgroups are done with it; thread 0 fills it again.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(CTHREADS, 1)
zinb_cols_wgmma(const __grid_constant__ CUtensorMap gmap,
                const T* __restrict__ ht, int A, int F, int D, int nkc,
                int n_ranges, int stages, float* __restrict__ dw,
                float* __restrict__ db) {
  constexpr bool F32 = std::is_same<T, float>::value;
  constexpr uint32_t HB = (uint32_t)(ht_tile<T>() * sizeof(T));
  constexpr int SB = stage_bytes<T>();
  // the h^T tile's descriptor: core matrices adjacent in K 128 bytes
  // apart, 8-row groups a row of KB values (every core matrix) apart
  constexpr uint32_t SBO = KB * (uint32_t)sizeof(T) * 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[MAX_STAGES2], empty[MAX_STAGES2];
  unsigned char* const ring =
      smem_raw + ((1024 - (wg::smem_addr(smem_raw) & 1023)) & 1023);

  const int d0 = blockIdx.x * TM, a = blockIdx.y, r = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hd = warp >> 2;  // the warpgroup's head
  const int gq = lane >> 2, tq = lane & 3;
  const int rl = 16 * (warp & 3) + gq;  // the thread's rows rl, rl + 8
  const T* ht_ar = ht + ((long long)a * nkc * n_ranges + r) * ht_tile<T>();
  const CUtensorMap* gm = &gmap;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], 3);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  auto issue = [&](int c) {
    const int s = c % stages;
    unsigned char* st = ring + (size_t)s * SB;
    wg::mbar_expect_tx(&full[s], 3 * G_TILE + HB);
    for (int h = 0; h < 3; ++h)
      wg::tensor_load_2d(st + h * G_TILE, gm, c * KB, (h * A + a) * D + d0,
                         &full[s]);
    wg::bulk_load(st + 3 * G_TILE,
                  ht_ar + (long long)c * n_ranges * ht_tile<T>(), HB,
                  &full[s]);
  };
  if (tid == 0)
    for (int c = 0; c < stages && c < nkc; ++c) issue(c);
  __syncwarp();

  float acc[52], run[52];
#pragma unroll
  for (int i = 0; i < 52; ++i) acc[i] = run[i] = 0.f;
  float db0 = 0.f, db1 = 0.f;  // rows rl and rl + 8
  for (int c = 0; c < nkc; ++c) {
    const int s = c % stages;
    wg::mbar_wait(&full[s], (c / stages) & 1);
    const unsigned char* st = ring + (size_t)s * SB;
    // rows 8 tq .. 8 tq + 7 of the stage: 16-byte chunks 2 tq and 2 tq + 1
    // of the tile's rows rl and rl + 8, swizzled by the row (rl % 8 == gq)
    const float4* g0 =
        reinterpret_cast<const float4*>(st + hd * G_TILE + rl * KB * 4);
    const float4* g1 = g0 + 8 * (KB / 4);
    const float4 u0 = g0[(2 * tq) ^ gq], u1 = g0[(2 * tq + 1) ^ gq];
    const float4 w0 = g1[(2 * tq) ^ gq], w1 = g1[(2 * tq + 1) ^ gq];
    const float v0[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    const float v1[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
    db0 += ((v0[0] + v0[1]) + (v0[2] + v0[3])) +
           ((v0[4] + v0[5]) + (v0[6] + v0[7]));
    db1 += ((v1[0] + v1[1]) + (v1[2] + v1[3])) +
           ((v1[4] + v1[5]) + (v1[6] + v1[7]));
    const T* hs = reinterpret_cast<const T*>(st + 3 * G_TILE);
    const uint64_t bh = wg::desc(hs, 128, SBO);
    wg::fence_acc(run);
    if constexpr (F32) {
      const uint64_t bl = wg::desc(hs + NT * KB, 128, SBO);
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        tc::split_tf32_bits(tc::quiet_nan(v0[2 * k]), ah[k][0], al[k][0]);
        tc::split_tf32_bits(tc::quiet_nan(v1[2 * k]), ah[k][1], al[k][1]);
        tc::split_tf32_bits(tc::quiet_nan(v0[2 * k + 1]), ah[k][2], al[k][2]);
        tc::split_tf32_bits(tc::quiet_nan(v1[2 * k + 1]), ah[k][3], al[k][3]);
      }
      wg::fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t o = (uint64_t)k * (256 >> 4);  // 2 core matrices
        wg::mma_tf32_rs(run, al[k], bh + o, k);  // k 0: the run from zero
        wg::mma_tf32_rs(run, ah[k], bh + o, 1);
        wg::mma_tf32_rs(run, ah[k], bl + o, 1);
      }
    } else {
      uint32_t ab[2][4];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        ab[k][0] = tc::pack_bf16(v0[4 * k], v0[4 * k + 1]);
        ab[k][1] = tc::pack_bf16(v1[4 * k], v1[4 * k + 1]);
        ab[k][2] = tc::pack_bf16(v0[4 * k + 2], v0[4 * k + 3]);
        ab[k][3] = tc::pack_bf16(v1[4 * k + 2], v1[4 * k + 3]);
      }
      wg::fence();
#pragma unroll
      for (int k = 0; k < 2; ++k)
        wg::mma_bf16_rs(run, ab[k], bh + (uint64_t)k * (256 >> 4), k);
    }
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(run);
    if ((tid & 127) == 0) wg::mbar_arrive(&empty[s]);
#pragma unroll
    for (int i = 0; i < 52; ++i) acc[i] += run[i];
    if (tid == 0 && c + stages < nkc) {
      wg::mbar_wait(&empty[s], (c / stages) & 1);
      issue(c + stages);
    }
    __syncwarp();
  }

  // db (range 0): the four lanes of a row, in a fixed order
  db0 += __shfl_xor_sync(0xffffffffu, db0, 1);
  db0 += __shfl_xor_sync(0xffffffffu, db0, 2);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 1);
  db1 += __shfl_xor_sync(0xffffffffu, db1, 2);
  if (r == 0 && tq == 0) {
    float* dba = db + ((long long)hd * A + a) * D + d0;
    if (d0 + rl < D) dba[rl] = db0;
    if (d0 + rl + 8 < D) dba[rl + 8] = db1;
  }
  // dW[hd][a][f][d]: acc[i] is column d0 + rl + 8 ((i / 2) % 2), hidden
  // unit NT r + 8 (i / 4) + 2 tq + i % 2
  float* dwa = dw + ((long long)hd * A + a) * F * D;
#pragma unroll
  for (int i = 0; i < 52; ++i) {
    const int f = r * NT + 8 * (i / 4) + 2 * tq + (i % 2);
    const int d = d0 + rl + 8 * ((i / 2) % 2);
    if (f < F && d < D) dwa[(long long)f * D + d] = acc[i];
  }
}

// The map of the stored g as a 2-D tensor (3 A D rows of `pitch` floats)
// read in boxes of KB x TM with the 128-byte swizzle; 0 or a CUDA error.
int g_tensor_map(CUtensorMap* m, const float* g, long long rows,
                 long long pitch) {
  wg::EncodeTiled enc = wg::encode_tiled();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)pitch, (cuuint64_t)rows};
  const cuuint64_t stride[1] = {(cuuint64_t)pitch * 4};
  const cuuint32_t box[2] = {(cuuint32_t)KB, (cuuint32_t)TM};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = enc(
      m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(g), dim,
      stride, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <typename T, bool SEPARATE, int FT, bool WIDE>
int launch_rows(const Args& p, const Heads<T>& heads, const float* g,
                const RowPlan& plan, const ColPlan& cp, float* part,
                float* spill, float* gst, float* dh, float* dw, int vec_h,
                int vec_d, cudaStream_t st) {
  Partials parts;
  parts.dh = dh;
  parts.in_dw = dw;
  parts.stride = (long long)p.A * p.B * p.F;
  parts.n_in_dw = plan.n_in_dw;
  parts.spill = spill;
  parts.g = gst;
  parts.g_pitch = cp.pitch;
  parts.g_head = (long long)p.A * p.D * cp.pitch;
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
      p.eps, p.one_m_eps, vec_h, vec_d, part, parts);
  err = cudaGetLastError();
  if (err != cudaSuccess || plan.n_split == 1) return (int)err;
  const long long n = parts.stride;
  zinb_dh_reduce<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(
      parts, plan.n_split, n);
  return (int)cudaGetLastError();
}

// Pass 2: the prep of h^T, then the products.
template <typename T>
int launch_cols(const Args& p, const ColPlan& cp, const float* gst, T* htp,
                float* dw, float* db, cudaStream_t st) {
  const long long groups = (long long)p.A * cp.nkc * cp.n_ranges * NT *
                           (KB / (16 / (int)sizeof(T)));
  long long blocks = (groups + 255) / 256;
  if (blocks > 132 * 16) blocks = 132 * 16;
  zinb_cols_prep<T><<<(unsigned)blocks, 256, 0, st>>>(
      static_cast<const T*>(p.h), p.B, p.F, cp.nkc, cp.n_ranges, groups, htp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  CUtensorMap gmap = {};
  const int rc = g_tensor_map(&gmap, gst, 3LL * p.A * p.D, cp.pitch);
  if (rc) return rc;
  auto kern = zinb_cols_wgmma<T>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)cp.smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.D + TM - 1) / TM, p.A, cp.n_ranges);
  kern<<<grid, CTHREADS, cp.smem, st>>>(gmap, htp, p.A, p.F, p.D, cp.nkc,
                                        cp.n_ranges, cp.stages, dw, db);
  return (int)cudaGetLastError();
}

// SEPARATE: the backward for a given cotangent g (no loss, two digamma
// calls); else loss and unscaled gradients.
template <typename T, bool SEPARATE>
int launch(const Args& p, const void* g, void* work, void* out, void* dh,
           void* dw, void* db, void* stream) {
  if (!shape_ok_fwdbwd<T>(p.A, p.B, p.F, p.D))
    return (int)cudaErrorInvalidValue;
  const RowPlan plan_ = plan<T>(p.A, p.B, p.D);
  const ColPlan cp = col_plan<T>(p.B, p.F);
  const Layout l = layout<T>(p.A, p.B, p.F, p.D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Heads<T> heads = heads_of<T>(p);
  const float* gp = static_cast<const float*>(g);
  char* ws = static_cast<char*>(work);
  float* part = reinterpret_cast<float*>(ws + l.part);
  float* spill = reinterpret_cast<float*>(ws + l.spill);
  float* gst = reinterpret_cast<float*>(ws + l.g);
  T* htp = reinterpret_cast<T*>(ws + l.ht);
  float* dhp = static_cast<float*>(dh);
  float* dwp = static_cast<float*>(dw);
  const int vec_h = vec_h_of<T>(p);
  const int vec_d = vec_of<T>(p);
  int e = p.F <= 104
          ? launch_rows<T, SEPARATE, 13, false>(p, heads, gp, plan_, cp, part,
                                                spill, gst, dhp, dwp, vec_h,
                                                vec_d, st)
      : p.F <= FP
          ? launch_rows<T, SEPARATE, 16, false>(p, heads, gp, plan_, cp, part,
                                                spill, gst, dhp, dwp, vec_h,
                                                vec_d, st)
          : launch_rows<T, SEPARATE, 16, true>(p, heads, gp, plan_, cp, part,
                                               spill, gst, dhp, dwp, vec_h,
                                               vec_d, st);
  if (e) return e;
  e = launch_cols<T>(p, cp, gst, htp, dwp, static_cast<float*>(db), st);
  if (e || SEPARATE) return e;
  zinb_loss_reduce<<<p.A, REDUCE_THREADS, 0, st>>>(
      part, plan_.row_tiles * plan_.n_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int plan_of(int A, int B, int F, int D, long long* out) {
  if (!shape_ok_fwdbwd<T>(A, B, F, D)) return -1;
  const RowPlan p = plan<T>(A, B, D);
  const ColPlan c = col_plan<T>(B, F);
  const Layout l = layout<T>(A, B, F, D);
  const long long form = F <= 104 ? 13 : F <= FP ? 16 : -16;
  const long long v[15] = {
      form,    p.n_split, p.cols_per_split, p.row_tiles,       p.n_in_dw,
      p.n_spill, c.pitch, c.nkc,            c.n_ranges,        c.stages,
      (long long)c.smem,  l.spill,          l.g,               l.ht,
      l.bytes};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

}  // namespace

extern "C" {

// Bytes of the workspace one launch needs (its layout above); -1 if the
// shape is refused.
long long zinb_fwdbwd_workspace_bytes(int bf16, int A, int B, int F, int D) {
  if (bf16)
    return shape_ok_fwdbwd<__nv_bfloat16>(A, B, F, D)
               ? layout<__nv_bfloat16>(A, B, F, D).bytes
               : -1;
  return shape_ok_fwdbwd<float>(A, B, F, D) ? layout<float>(A, B, F, D).bytes
                                            : -1;
}

// The plan of the shape: out = {row form (13, 16, -16 wide), slices of D,
// columns a slice, row tiles, dh partials in dW, spilled, g pitch, chunks
// of B, ranges of F, stages, pass 2's shared memory, byte offsets of the
// spill, g and h^T, workspace bytes}.  0, or -1 if the shape is refused.
int zinb_fwdbwd_plan(int bf16, int A, int B, int F, int D, long long* out) {
  return bf16 ? plan_of<__nv_bfloat16>(A, B, F, D, out)
              : plan_of<float>(A, B, F, D, out);
}

// Largest hidden width F the kernels take in f32 (bf16 0) or bf16: past
// 128 the row pass's wide form's shared memory sets it (max_f_rows).
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
