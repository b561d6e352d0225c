// The whole MSE decoder in one call: trunk fc6..fc10 (Linear + ReLU), output
// layer fc11 + ReLU, the reconstruction loss sums and, in training, the
// complete backward with cotangent 1.  Neither the (A, B, D) reconstruction
// nor its cotangent is left in device memory, and nothing is left for
// autograd.  Hand-written for Hopper (sm_90a), bound with ctypes.
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
// gates are comparisons, so a NaN propagates.  The split of the f32
// products would turn the card's own NaN into -0, so the passes read
// copies of z and the weights with every NaN quiet (recon_passes.cuh
// quiet_copy), and the activations and cotangents are stored so
// (tc::quiet_nan).
//
// Operands: z (A,B,Z); W_i (A,in_i,out_i), b_i (A,out_i); W_11 (A,F,D),
// b_11 (A,D); x (B,D) shared (arm stride 0) or per-arm (A,B,D); all f32 or
// all bf16.  Outputs: (A,2) f32 sums; in training also dz (A,B,Z) in the
// operand type and, in f32, dW_i, db_i, dW_11, db_11.  Any trunk widths;
// F up to the limit of #2's passes (recon_passes.cuh max_f).
//
// Bound at the production shape (A=5, B=5000, Z=94, L=10, F=100, D=5032):
//   forward 2*A*B*(94*10 + 10*100 + 3*100^2 + 100*5032) = 26.76 GFLOP ->
//   0.054 ms at the TF32 tensor-core peak (495 TFLOP/s; f32 operands taken
//   as one TF32 product, the least work for f32-accurate products: the
//   3xTF32 split does three), 0.027 ms at the bf16 peak (989 TFLOP/s);
//   forward + backward three times that, 0.162 / 0.081 ms.  Bytes
//   (operands read once, outputs written once): about 114 MB forward, 135
//   MB in training -> 0.034 / 0.040 ms.  Bound by operations; 94% of them
//   are the three fc11 products.
//
// Design.  A short chain of launches on one stream, no host sync, every
// product on the tensor cores (`mma.sync`, csrc/mma.cuh: 3xTF32 m16n8k8
// for f32 operands, m16n8k16 for bf16, f32 accumulation); in f32 it starts
// with the quiet copies of z and the weights (quiet_copy):
//   (a) `decoder_trunk_fwd`, blocks (64-row tile, arm) of 8 warps: the z
//     tile and each layer's weights arrive by cp.async (the weights one
//     layer ahead, in two buffers); warp w computes the rows 16 (w % 4)..
//     of each layer in 16-column groups; every width is padded with zeros
//     to the mma's k (Z = 94 -> 96, L = 10 -> 16, F = 100 -> 104 in f32,
//     112 in bf16) and n.  It writes h_5 (A,B,F) in the operand type and,
//     in training, h_1..h_4 beside it (41 MB at the production shape in
//     f32): the backward reads them back instead of recomputing them from
//     z, so that no block holds all six activations (the SIMT kernel this
//     replaces kept them resident, 191 KB of shared memory a block), at a
//     cost of 32 MB written and read once;
//   (b), (c) the two passes of kernel #2 (csrc/recon_passes.cuh) on h_5:
//     the row pass for the loss partials and dh_5 (f32, the slices' partials
//     added in slice order), the column pass for dW_11 and db_11, which
//     therefore equal #2's bit for bit on the same h_5.  The value-only
//     forward runs the row pass in its value-only form (no dh), with the
//     same plan and partial order, so its sums equal the training call's
//     bit for bit;
//   (d) `decoder_trunk_bwd`, blocks (64-row tile, arm) of 8 warps, from
//     dh_5 down to dz: per layer the gate in place on the f32 cotangent
//     tile, the db partial of the tile (column sums in row order), the dW
//     partial h^T g (g rounded to the operand type) and the next g = g W^T;
//     the next layer's h and W arrive by cp.async while the gate and the db
//     sums run;
//   (e) fixed-order reductions: the loss partials per arm (#2's) and the
//     trunk partials over the row tiles in double (`decoder_grad_reduce`;
//     one vector of 32,150 floats per row tile: 50.8 MB at B = 5000).
// Trunk widths above WP (128), or a Z too wide for (a) and (d)'s shared
// memory, run the wide trunk instead (`decoder_wide`), layer by layer on
// activations in device memory, every width walked in chunks of WC = 128:
//   forward, `trunk_fwd_wide` a layer, blocks (64-row tile, arm, chunk of
//     the outputs) of 8 warps, the h and W chunks of k by cp.async in a
//     ring of two; it stores every h_l, #12's too (its workspace holds them);
//   backward, from g_5 = 1[h_5 > 0] dh_5 (`trunk_gate`), per layer
//     `trunk_bwd_cols_wide`, blocks (64 units of h_l, 128 of g, arm)
//     walking every row tile, for dW_l = h_l^T g in f32 runs (tc::add4) and
//     db_l in double in row order; and `trunk_bwd_rows_wide`, blocks
//     (64-row tile, arm, chunk of h_l's units), for the next g = 1[h_l > 0]
//     (g W_l^T), f32 in a second buffer, or dz for l = 0.  The two g
//     buffers take the place of the gradient partials.
// f32 operands are split into tf32 halves by each warp on the fragments it
// reads (mma.cuh split_tf32_bits); the trunk's sums run in runs of 32
// values of k (rows for dW) summed from zero and added rounded to nearest
// (tc::add4), since the tensor cores round a sum toward zero.  Every sum
// runs in an order fixed by the shape alone, so repeated launches are
// bit-identical on any card.  Rows past B are loaded as zeros and masked in
// the loss, so their gm and every g are exactly 0 and they add nothing to
// any gradient.

#include "recon_passes.cuh"

namespace {

constexpr int N_TRUNK = 5;      // fc6..fc10
constexpr int WP = 128;         // widest trunk layer output
constexpr int TM = 64;          // rows of a trunk block (= BM1, #2's rows)
constexpr int TTHREADS = 256;   // 8 warps: 4 groups of 16 rows x 2 halves
constexpr int RUN = 32;         // k values of a run (tc::add4)
constexpr int WC = 128;         // the wide trunk's chunk of a width
constexpr int GRAD_THREADS = 256;
// dynamic shared memory a block may take: the card's 232,448 bytes less
// 1 KB of headroom
constexpr int MAX_SMEM = 232448 - 1024;

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// The trunk's operands, its tiles' pitches and the layout of its gradient
// partials, passed by value.
template <typename T>
struct Trunk {
  const T* w[N_TRUNK];
  const T* b[N_TRUNK];
  T* act[N_TRUNK];          // h_{l+1} (A,B,width[l+1]), or nullptr
  int width[N_TRUNK + 1];   // width[0] = Z, width[l + 1] = outputs of layer l
  int vec_w[N_TRUNK];       // cp.async chunks (mma.cuh chunk_bytes)
  int vec_act[N_TRUNK];
  int vec_z;
  int lda, ldw, ldg, kpw;   // pitches of the h, W and g tiles; W tile rows
  int w_off[N_TRUNK];       // offsets into one tile's gradient partials
  int b_off[N_TRUNK];
  int n_grad;               // their length
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

// acc[j] += A B for the warp's 16 rows and the two 8-column n-tiles j of a
// 16-column group, over k < kp (a multiple of the mma's k): A(m, k) = a(m,
// k), B(k, n) = b(k, n), read as floats from shared memory.  f32 operands
// through the 3xTF32 split (big: hi*hi, small: the two cross terms), bf16
// packed in pairs (rounded to nearest even where the stored value is an
// f32 cotangent, exact where it is bf16 already).  Runs of RUN values of k
// are summed from zero and added rounded to nearest (tc::add4).
template <typename T, typename FA, typename FB>
__device__ __forceinline__ void warp_product(float (&acc)[2][4], int kp,
                                             FA a, FB b, int gq, int tq) {
  for (int r0 = 0; r0 < kp; r0 += RUN) {
    const int r1 = min(kp, r0 + RUN);
    float big[2][4], small[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      tc::zero4(big[j]);
      tc::zero4(small[j]);
    }
    if constexpr (std::is_same<T, float>::value) {
      for (int k = r0; k < r1; k += 8) {
        const tc::SplitA af = tc::split_a_bits(
            a(gq, k + tq), a(gq + 8, k + tq), a(gq, k + tq + 4),
            a(gq + 8, k + tq + 4));
#pragma unroll
        for (int j = 0; j < 2; ++j)
          tc::mma_3xtf32(big[j], small[j], af,
                         tc::split_b_bits(b(k + tq, 8 * j + gq),
                                                b(k + tq + 4, 8 * j + gq)));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) tc::add4(acc[j], big[j], small[j]);
    } else {
      for (int k = r0; k < r1; k += 16) {
        const int k2 = k + 2 * tq;
        const uint32_t af[4] = {
            tc::pack_bf16(a(gq, k2), a(gq, k2 + 1)),
            tc::pack_bf16(a(gq + 8, k2), a(gq + 8, k2 + 1)),
            tc::pack_bf16(a(gq, k2 + 8), a(gq, k2 + 9)),
            tc::pack_bf16(a(gq + 8, k2 + 8), a(gq + 8, k2 + 9))};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int n = 8 * j + gq;
          const uint32_t bf[2] = {tc::pack_bf16(b(k2, n), b(k2 + 1, n)),
                                  tc::pack_bf16(b(k2 + 8, n), b(k2 + 9, n))};
          tc::mma_bf16(big[j], af, bf);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) tc::add4(acc[j], big[j]);
    }
  }
}

template <typename T>
__host__ __device__ constexpr int mma_k() {
  return std::is_same<T, float>::value ? 8 : 16;
}

// Pass (a): grid (ceil(B/TM), A).  The trunk forward of one 64-row tile;
// each activation, rounded to T after its ReLU, goes to the other h tile
// and, where tr.act[l] is set, out to device memory.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
decoder_trunk_fwd(const T* __restrict__ z, const Trunk<T> tr, int B) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int lda = tr.lda, ldw = tr.ldw;
  T* const hs0 = sm;
  T* const hs1 = sm + TM * lda;
  T* const ws0 = sm + 2 * TM * lda;
  T* const ws1 = ws0 + tr.kpw * ldw;
  const int a = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3);       // the warp's rows
  const int c_first = 16 * (warp >> 2);  // its first 16-column group

  auto issue_w = [&](int l) {
    const int K = tr.width[l], N = tr.width[l + 1];
    tc::load_tile((l & 1) ? ws1 : ws0, ldw, tr.w[l] + (long long)a * K * N, N,
                  pad16(K), pad16(N), K, N, tr.vec_w[l], tid, TTHREADS);
  };
  const int Z = tr.width[0];
  tc::load_tile(hs0, lda, z + ((long long)a * B + m0) * Z, Z, TM, pad16(Z),
                B - m0, Z, tr.vec_z, tid, TTHREADS);
  issue_w(0);
  tc::cp_commit();
  issue_w(1);
  tc::cp_commit();

  for (int l = 0; l < N_TRUNK; ++l) {
    const int K = tr.width[l], N = tr.width[l + 1];
    const T* H = (l & 1) ? hs1 : hs0;
    T* Hn = (l & 1) ? hs0 : hs1;
    const T* W = (l & 1) ? ws1 : ws0;
    tc::cp_wait<1>();
    __syncthreads();  // this layer's input and weights are in
    const T* bl = tr.b[l] + (long long)a * N;
    const int kp = round_up(K, mma_k<T>());
    for (int c0 = c_first; c0 < pad16(N); c0 += 32) {
      float acc[2][4];
      tc::zero4(acc[0]);
      tc::zero4(acc[1]);
      warp_product<T>(
          acc, kp, [&](int m, int k) { return to_f32(H[(r0 + m) * lda + k]); },
          [&](int k, int n) { return to_f32(W[k * ldw + c0 + n]); }, gq, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = c0 + 8 * j + 2 * tq + e;
          const float bj = col < N ? to_f32(bl[col]) : 0.f;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float v =
                col < N ? tc::quiet_nan(relu_nan(acc[j][2 * half + e] + bj))
                        : 0.f;
            store_as(&Hn[(r0 + gq + 8 * half) * lda + col], v);
          }
        }
    }
    __syncthreads();  // Hn complete; H and this layer's weights are free
    if (l + 2 < N_TRUNK) issue_w(l + 2);
    tc::cp_commit();
    if (T* out = tr.act[l]) {  // the tile's rows are contiguous in (A,B,N)
      T* dst = out + ((long long)a * B + m0) * N;
      const int n_el = min(TM, B - m0) * N;
      for (int i = tid; i < n_el; i += TTHREADS)
        dst[i] = Hn[(i / N) * lda + i % N];
    }
  }
  tc::cp_wait<0>();  // nothing in flight when the block ends
}

// Pass (d): grid (ceil(B/TM), A).  The trunk backward of one 64-row tile,
// from dh_5 (f32) down to dz, on the activations pass (a) stored.  Per
// layer l = 4..0 (fc10..fc6), g the f32 cotangent of h_{l+1} in a tile:
//   gate g = 1[h_{l+1} > 0] g in place; the db partial, the tile's column
//   sums of g in row order; the dW partial h_l^T g (K x N, g rounded to
//   T); the next g = g W_l^T (f32), or for l = 0 dz in T.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
decoder_trunk_bwd(const T* __restrict__ z, const Trunk<T> tr,
                  const float* __restrict__ dh5, int vec_dh, int B,
                  float* __restrict__ part_grad, T* __restrict__ dz) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int lda = tr.lda, ldw = tr.ldw, ldg = tr.ldg;
  float* const gs0 = reinterpret_cast<float*>(smem_raw);
  float* const gs1 = gs0 + TM * ldg;
  T* const hs0 = reinterpret_cast<T*>(gs1 + TM * ldg);
  T* const hs1 = hs0 + TM * lda;
  T* const W = hs1 + TM * lda;
  const int a = blockIdx.y;
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3);
  const int c_first = 16 * (warp >> 2);
  const int F = tr.width[N_TRUNK];
  float* const gp =
      part_grad + ((long long)a * gridDim.x + blockIdx.x) * tr.n_grad;

  tc::load_tile(gs0, ldg, dh5 + ((long long)a * B + m0) * F, F, TM,
                pad16(F), B - m0, F, vec_dh, tid, TTHREADS);
  tc::load_tile(hs0, lda, tr.act[N_TRUNK - 1] + ((long long)a * B + m0) * F,
                F, TM, pad16(F), B - m0, F, tr.vec_act[N_TRUNK - 1], tid,
                TTHREADS);
  tc::cp_commit();

  for (int l = N_TRUNK - 1; l >= 0; --l) {
    const int K = tr.width[l], N = tr.width[l + 1];
    const bool odd = (N_TRUNK - 1 - l) & 1;
    float* const G = odd ? gs1 : gs0;
    float* const Gn = odd ? gs0 : gs1;
    const T* const Hout = odd ? hs1 : hs0;
    T* const Hin = odd ? hs0 : hs1;
    // h_l (z for l = 0) and W_l, while the gate and the db sums run
    const T* src = l > 0 ? tr.act[l - 1] : z;
    tc::load_tile(Hin, lda, src + ((long long)a * B + m0) * K, K, TM,
                  pad16(K), B - m0, K, l > 0 ? tr.vec_act[l - 1] : tr.vec_z,
                  tid, TTHREADS);
    tc::load_tile(W, ldw, tr.w[l] + (long long)a * K * N, N, pad16(K),
                  pad16(N), K, N, tr.vec_w[l], tid, TTHREADS);
    tc::cp_commit();
    tc::cp_wait<1>();
    __syncthreads();  // g and h_{l+1} are in
    const int np = pad16(N);
    for (int i = tid; i < TM * np; i += TTHREADS) {
      const int r = i / np, c = i % np;
      float* p = G + r * ldg + c;
      *p = (c < N && to_f32(Hout[r * lda + c]) > 0.f) ? tc::quiet_nan(*p)
                                                       : 0.f;
    }
    __syncthreads();
    if (tid < N) {  // db partial: the unrounded g, summed in row order
      float s = 0.f;
      for (int r = 0; r < TM; ++r) s += G[r * ldg + tid];
      gp[tr.b_off[l] + tid] = s;
    }
    tc::cp_wait<0>();
    __syncthreads();  // h_l and W_l are in

    // dW partial (K x N) = h_l^T g over the tile's rows: items of 16 units
    // of h_l x 16 of h_{l+1}, round robin over the warps
    const int mt = pad16(K) / 16, nt = np / 16;
    for (int it = warp; it < mt * nt; it += TTHREADS / 32) {
      const int k0 = 16 * (it / nt), n0 = 16 * (it % nt);
      float acc[2][4];
      tc::zero4(acc[0]);
      tc::zero4(acc[1]);
      warp_product<T>(
          acc, TM, [&](int m, int k) { return to_f32(Hin[k * lda + k0 + m]); },
          [&](int k, int n) { return G[k * ldg + n0 + n]; }, gq, tq);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ku = k0 + gq + 8 * half, nu = n0 + 8 * j + 2 * tq + e;
            if (ku < K && nu < N)
              gp[tr.w_off[l] + ku * N + nu] = acc[j][2 * half + e];
          }
    }

    // the next g = g W_l^T: the warp's rows, units of h_l in 16-column
    // groups; W_l read transposed
    const int kp = round_up(N, mma_k<T>());
    for (int c0 = c_first; c0 < pad16(K); c0 += 32) {
      float acc[2][4];
      tc::zero4(acc[0]);
      tc::zero4(acc[1]);
      warp_product<T>(
          acc, kp, [&](int m, int k) { return G[(r0 + m) * ldg + k]; },
          [&](int k, int n) { return to_f32(W[(c0 + n) * ldw + k]); }, gq,
          tq);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int half = 0; half < 2; ++half)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = c0 + 8 * j + 2 * tq + e;
            const int row = r0 + gq + 8 * half;
            const float v = acc[j][2 * half + e];
            if (l > 0)
              Gn[row * ldg + col] = col < K ? tc::quiet_nan(v) : 0.f;
            else if (m0 + row < B && col < K)
              store_as(&dz[((long long)a * B + m0 + row) * K + col], v);
          }
    }
    __syncthreads();  // the next g is complete; g, h_l and W_l are free
  }
}

// ---------------------------------------------------------------------------
// The wide trunk (widths above WP).  Pitches: rows of h read along k
// (LDA_F), rows of W read along n (LDW_F) in the forward; g read along its
// units (LDG_R), W read across them (LDW_R) for the next g; h read across
// its units (LDH_C), g along them (LDG_C) for dW; each keeps a warp's f32
// fragment reads on distinct banks.
// ---------------------------------------------------------------------------
template <typename T>
__host__ __device__ constexpr int wide_pad() {
  return std::is_same<T, float>::value ? 4 : 8;
}
template <typename T>
__host__ __device__ constexpr int fwd_wide_stage() {  // bytes
  return (TM * (WC + wide_pad<T>()) + WC * (WC + 8)) * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int rows_wide_stage() {
  return TM * (WC + 4) * 4 + WC * (WC + wide_pad<T>()) * (int)sizeof(T);
}
constexpr int COLS_K = 64;  // units of h_l a dW block owns
template <typename T>
__host__ __device__ constexpr int cols_wide_stage() {
  return TM * (COLS_K + 8) * (int)sizeof(T) + TM * (WC + 8) * 4;
}

// grid (ceil(B/TM), A, ceil(N/WC)): h_out = relu(h_in W + b) of one row
// tile and chunk of outputs, rounded to T and stored quiet.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
trunk_fwd_wide(const T* __restrict__ src, const T* __restrict__ w,
               const T* __restrict__ bias, T* __restrict__ dst, int B, int K,
               int N, int vec_src, int vec_w) {
  constexpr int LDA = WC + wide_pad<T>(), LDW = WC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a = blockIdx.y, m0 = blockIdx.x * TM, n0 = blockIdx.z * WC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3), cg0 = 16 * (warp >> 2);
  const int nk = (K + WC - 1) / WC;
  auto stage = [&](int kc) {
    return reinterpret_cast<T*>(smem_raw + (kc & 1) * fwd_wide_stage<T>());
  };
  auto issue = [&](int kc) {
    T* hs = stage(kc);
    const int k0 = kc * WC;
    tc::load_tile(hs, LDA, src + ((long long)a * B + m0) * K + k0, K, TM, WC,
                  B - m0, K - k0, vec_src, tid, TTHREADS);
    tc::load_tile(hs + TM * LDA, LDW, w + ((long long)a * K + k0) * N + n0, N,
                  WC, WC, K - k0, N - n0, vec_w, tid, TTHREADS);
  };
  issue(0);
  tc::cp_commit();
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tc::zero4(acc[i][0]);
    tc::zero4(acc[i][1]);
  }
  for (int kc = 0; kc < nk; ++kc) {
    tc::cp_wait<0>();
    __syncthreads();  // this chunk is in; the other buffer is free
    if (kc + 1 < nk) issue(kc + 1);
    tc::cp_commit();
    const T* H = stage(kc);
    const T* W = H + TM * LDA;
    const int kp = round_up(min(WC, K - kc * WC), mma_k<T>());
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = cg0 + 32 * i;
      if (n0 + c < N)
        warp_product<T>(
            acc[i], kp,
            [&](int m, int k) { return to_f32(H[(r0 + m) * LDA + k]); },
            [&](int k, int n) { return to_f32(W[k * LDW + c + n]); }, gq, tq);
    }
  }
  tc::cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + cg0 + 32 * i + 8 * j + 2 * tq + e;
        if (col >= N) continue;
        const float bj = to_f32(bias[(long long)a * N + col]);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + r0 + gq + 8 * half;
          if (row < B)
            store_as(&dst[((long long)a * B + row) * N + col],
                     tc::quiet_nan(relu_nan(acc[i][j][2 * half + e] + bj)));
        }
      }
}

// g_5 = 1[h_5 > 0] dh_5, quiet, into the first g buffer.
template <typename T>
__global__ void trunk_gate(const float* __restrict__ g,
                           const T* __restrict__ h, long long n,
                           float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = to_f32(h[i]) > 0.f ? tc::quiet_nan(g[i]) : 0.f;
}

// grid (ceil(B/TM), A, ceil(K/WC)): the next g = 1[h_in > 0] (g W^T) of one
// row tile and chunk of h_in's units, f32 and quiet; with dz set (layer
// fc6) dz = g W^T in T instead.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
trunk_bwd_rows_wide(const float* __restrict__ g, const T* __restrict__ w,
                    const T* __restrict__ h_in, float* __restrict__ g_out,
                    T* __restrict__ dz, int B, int K, int N, int vec_g,
                    int vec_w) {
  constexpr int LDG = WC + 4, LDW = WC + wide_pad<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int a = blockIdx.y, m0 = blockIdx.x * TM, k0 = blockIdx.z * WC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = 16 * (warp & 3), cg0 = 16 * (warp >> 2);
  const int nn = (N + WC - 1) / WC;
  auto gstage = [&](int nc) {
    return reinterpret_cast<float*>(smem_raw +
                                    (nc & 1) * rows_wide_stage<T>());
  };
  auto issue = [&](int nc) {
    float* gs = gstage(nc);
    T* ws = reinterpret_cast<T*>(gs + TM * LDG);
    const int c0 = nc * WC;
    tc::load_tile(gs, LDG, g + ((long long)a * B + m0) * N + c0, N, TM, WC,
                  B - m0, N - c0, vec_g, tid, TTHREADS);
    tc::load_tile(ws, LDW, w + ((long long)a * K + k0) * N + c0, N, WC, WC,
                  K - k0, N - c0, vec_w, tid, TTHREADS);
  };
  issue(0);
  tc::cp_commit();
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tc::zero4(acc[i][0]);
    tc::zero4(acc[i][1]);
  }
  for (int nc = 0; nc < nn; ++nc) {
    tc::cp_wait<0>();
    __syncthreads();
    if (nc + 1 < nn) issue(nc + 1);
    tc::cp_commit();
    const float* G = gstage(nc);
    const T* W = reinterpret_cast<const T*>(G + TM * LDG);
    const int kp = round_up(min(WC, N - nc * WC), mma_k<T>());
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = cg0 + 32 * i;
      if (k0 + c < K)
        warp_product<T>(
            acc[i], kp, [&](int m, int k) { return G[(r0 + m) * LDG + k]; },
            [&](int k, int n) { return to_f32(W[(c + n) * LDW + k]); }, gq,
            tq);
    }
  }
  tc::cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + cg0 + 32 * i + 8 * j + 2 * tq + e;
          const int row = m0 + r0 + gq + 8 * half;
          if (row >= B || col >= K) continue;
          const long long o = ((long long)a * B + row) * K + col;
          const float v = acc[i][j][2 * half + e];
          if (dz)
            store_as(&dz[o], v);
          else
            g_out[o] = to_f32(h_in[o]) > 0.f ? tc::quiet_nan(v) : 0.f;
        }
}

// grid (ceil(K/COLS_K), ceil(N/WC), A): dW (K x N) = h_in^T g over every
// row, f32 runs of 32 rows added rounded to nearest (tc::add4); the blocks
// of the first unit tile also db = the column sums of g, in double, in
// row order.
template <typename T>
__global__ void __launch_bounds__(TTHREADS)
trunk_bwd_cols_wide(const T* __restrict__ h_in, const float* __restrict__ g,
                    float* __restrict__ dw, float* __restrict__ db, int B,
                    int K, int N, int vec_h, int vec_g) {
  constexpr int LDH = COLS_K + 8, LDG = WC + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k0 = blockIdx.x * COLS_K, n0 = blockIdx.y * WC, a = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int ku = 16 * (warp & 3), cg0 = 16 * (warp >> 2);
  const int nsteps = (B + TM - 1) / TM;
  const bool with_db = blockIdx.x == 0;
  auto hstage = [&](int st) {
    return reinterpret_cast<T*>(smem_raw + (st & 1) * cols_wide_stage<T>());
  };
  auto issue = [&](int st) {
    T* hs = hstage(st);
    float* gs = reinterpret_cast<float*>(hs + TM * LDH);
    const int m0 = st * TM;
    tc::load_tile(hs, LDH, h_in + ((long long)a * B + m0) * K + k0, K, TM,
                  COLS_K, B - m0, K - k0, vec_h, tid, TTHREADS);
    tc::load_tile(gs, LDG, g + ((long long)a * B + m0) * N + n0, N, TM, WC,
                  B - m0, N - n0, vec_g, tid, TTHREADS);
  };
  issue(0);
  tc::cp_commit();
  float acc[4][2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    tc::zero4(acc[i][0]);
    tc::zero4(acc[i][1]);
  }
  double dbs = 0.0;
  for (int st = 0; st < nsteps; ++st) {
    tc::cp_wait<0>();
    __syncthreads();
    if (st + 1 < nsteps) issue(st + 1);
    tc::cp_commit();
    const T* H = hstage(st);
    const float* G = reinterpret_cast<const float*>(H + TM * LDH);
    if (k0 + ku < K) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cg0 + 32 * i;
        if (n0 + c < N)
          warp_product<T>(
              acc[i], TM,
              [&](int m, int k) { return to_f32(H[k * LDH + ku + m]); },
              [&](int k, int n) { return G[k * LDG + c + n]; }, gq, tq);
      }
    }
    if (with_db && tid < WC) {  // rows past B were loaded as zeros
      for (int r = 0; r < TM; ++r) dbs += (double)G[r * LDG + tid];
    }
  }
  tc::cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = k0 + ku + gq + 8 * half;
          const int nu = n0 + cg0 + 32 * i + 8 * j + 2 * tq + e;
          if (kk < K && nu < N)
            dw[((long long)a * K + kk) * N + nu] = acc[i][j][2 * half + e];
        }
  if (with_db && tid < WC && n0 + tid < N)
    db[(long long)a * N + n0 + tid] = (float)dbs;
}

// Pass (e), training: grid (ceil(n_grad / GRAD_THREADS), A).  Each thread
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

// The shared memory plan of pass (a) (bwd false) or (d) (bwd true) for the
// given widths; returns its size in bytes, or -1 where a width is out of
// range.  The pitches keep the f32 fragment reads of a warp on distinct
// banks (rows of h and W read along k in (a), h and W across k in (d)).
// Widths above WP run the wide trunk, which this plan does not size.
template <typename T>
long long trunk_plan(const int* widths, bool bwd, Trunk<T>* tr) {
  int wmax = 0, kwide = 0, nwide = 0;
  for (int l = 0; l <= N_TRUNK; ++l) {
    if (widths[l] < 1) return -1;
    if (widths[l] > wmax) wmax = widths[l];
    if (l < N_TRUNK && widths[l] > kwide) kwide = widths[l];
    if (l > 0 && widths[l] > nwide) nwide = widths[l];
  }
  if (wmax > (1 << 20)) return -1;
  const bool f32 = std::is_same<T, float>::value;
  const int lda = pad16(wmax) + (f32 ? (bwd ? 8 : 4) : 8);
  const int ldw = pad16(nwide) + (f32 ? (bwd ? 4 : 8) : 8);
  const int ldg = pad16(wmax) + 4;
  const int kpw = pad16(kwide);
  const long long bytes =
      (long long)sizeof(T) *
          (2LL * TM * lda + (bwd ? 1LL : 2LL) * kpw * ldw) +
      (bwd ? 4LL * 2 * TM * ldg : 0LL);
  if (tr) {
    for (int l = 0; l <= N_TRUNK; ++l) tr->width[l] = widths[l];
    tr->lda = lda;
    tr->ldw = ldw;
    tr->ldg = ldg;
    tr->kpw = kpw;
    int g = 0;
    for (int l = 0; l < N_TRUNK; ++l) {
      tr->w_off[l] = g;
      g += widths[l] * widths[l + 1];
      tr->b_off[l] = g;
      g += widths[l + 1];
    }
    tr->n_grad = g;
  }
  return bytes;
}

long long smem_need(const int* widths, bool train) {
  const long long f = trunk_plan<float>(widths, false, nullptr);
  const long long b = train ? trunk_plan<float>(widths, true, nullptr) : 0;
  return (f < 0 || b < 0) ? -1 : (f > b ? f : b);
}

// The widest trunk output (out_6..out_10).
int trunk_wmax(const int* widths) {
  int m = 0;
  for (int l = 1; l <= N_TRUNK; ++l) m = widths[l] > m ? widths[l] : m;
  return m;
}

// Whether the call runs the wide trunk: a trunk output above WP, or widths
// whose resident tiles (a) or (d) cannot hold in a block.
bool trunk_wide(const int* widths, bool train) {
  return trunk_wmax(widths) > WP || smem_need(widths, train) > MAX_SMEM;
}

int n_grad_of(const int* widths) {
  int g = 0;
  for (int l = 0; l < N_TRUNK; ++l) g += (widths[l] + 1) * widths[l + 1];
  return g;
}

// The f32 operands that the products split: z, W_6..W_10, W_11 (h_5 is
// the trunk's own, its NaNs stored quiet); without wb only the lengths
QuietCopy quiet_arrays(const void* z, const void* const* wb,
                       const int* widths, int A, int B, int D) {
  QuietCopy c;
  c.count = N_TRUNK + 2;
  c.p[0] = static_cast<const float*>(z);
  c.n[0] = (long long)A * B * widths[0];
  for (int l = 0; l <= N_TRUNK; ++l) {
    c.p[1 + l] = wb ? static_cast<const float*>(wb[2 * l]) : nullptr;
    c.n[1 + l] =
        (long long)A * widths[l] * (l < N_TRUNK ? widths[l + 1] : D);
  }
  return c;
}

// The wide trunk's launch sequence (see the note at the top), after the
// quiet copies: tf's weights are the ones to read and every tf.act[l] is
// set.  gbuf: two (A,B,widest trunk output) f32 buffers of g.
template <typename T, bool TRAIN>
int launch_wide(const T* z, const Trunk<T>& tf, const void* w11,
                const void* b11, const void* x, long long x_arm_stride,
                int A, int B, int D, float thr, int with_mism,
                void* part_sum, void* part_mism, void* out, float* dh5,
                float* gbuf, T* dz, float* dtrunk, void* dw11, void* db11,
                cudaStream_t st) {
  const int e = (int)sizeof(T);
  const unsigned row_tiles = (B + TM - 1) / TM;
  cudaError_t err = cudaFuncSetAttribute(
      trunk_fwd_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      2 * fwd_wide_stage<T>());
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < N_TRUNK; ++l) {
    const int K = tf.width[l], N = tf.width[l + 1];
    const T* src = l > 0 ? tf.act[l - 1] : z;
    const dim3 grid(row_tiles, A, (N + WC - 1) / WC);
    trunk_fwd_wide<T><<<grid, TTHREADS, 2 * fwd_wide_stage<T>(), st>>>(
        src, tf.w[l], tf.b[l], tf.act[l], B, K, N,
        tc::chunk_bytes(src, K, e, (long long)B * K), tf.vec_w[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int F = tf.width[N_TRUNK];
  const int rc = recon_launch<T, false, TRAIN>(
      tf.act[N_TRUNK - 1], w11, b11, x, x_arm_stride, nullptr, A, B, F, D,
      thr, with_mism, part_sum, part_mism, out, dh5, dw11, db11, nullptr, st);
  if (rc != 0 || !TRAIN) return rc;

  float* cur = gbuf;
  float* nxt = gbuf + (long long)A * B * trunk_wmax(tf.width);
  const long long n5 = (long long)A * B * F;
  trunk_gate<T><<<(unsigned)((n5 + 255) / 256), 256, 0, st>>>(
      dh5, tf.act[N_TRUNK - 1], n5, cur);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(trunk_bwd_cols_wide<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * cols_wide_stage<T>());
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(trunk_bwd_rows_wide<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             2 * rows_wide_stage<T>());
  if (err != cudaSuccess) return (int)err;
  for (int l = N_TRUNK - 1; l >= 0; --l) {
    const int K = tf.width[l], N = tf.width[l + 1];
    const T* h_in = l > 0 ? tf.act[l - 1] : z;
    const int vec_g = tc::chunk_bytes(cur, N, 4, (long long)B * N);
    const dim3 gc((K + COLS_K - 1) / COLS_K, (N + WC - 1) / WC, A);
    trunk_bwd_cols_wide<T><<<gc, TTHREADS, 2 * cols_wide_stage<T>(), st>>>(
        h_in, cur, dtrunk + (long long)tf.w_off[l] * A,
        dtrunk + (long long)tf.b_off[l] * A, B, K, N,
        tc::chunk_bytes(h_in, K, e, (long long)B * K), vec_g);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const dim3 gr(row_tiles, A, (K + WC - 1) / WC);
    trunk_bwd_rows_wide<T><<<gr, TTHREADS, 2 * rows_wide_stage<T>(), st>>>(
        cur, tf.w[l], l > 0 ? h_in : nullptr, nxt, l > 0 ? nullptr : dz, B,
        K, N, vec_g, tf.vec_w[l]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return 0;
}

// wb: host array of the 12 device pointers W_6, b_6, ..., W_10, b_10, W_11,
// b_11; widths: host array Z, out_6, ..., out_10.  acts: h_5 (A,B,F) in
// the operand type, and in training or with the wide trunk h_1..h_5, each
// (A,B,out_l), one after the other (decoder_acts_elems).  part_grad: the
// trunk-gradient partials, or with the wide trunk its two g buffers
// (decoder_grad_scratch_floats).
template <typename T, bool TRAIN>
int launch(const void* z_, const void* const* wb, const int* widths,
           const void* x, long long x_arm_stride, int A, int B, int D,
           float thr, int with_mism, void* part_sum, void* part_mism,
           void* out, void* acts, void* dh5, void* part_grad, void* dz,
           void* dtrunk, void* dw11, void* db11, void* quiet_ws,
           void* stream) {
  Trunk<T> tf;
  const long long bf = trunk_plan<T>(widths, false, &tf);
  const long long bb = TRAIN ? trunk_plan<T>(widths, true, nullptr) : 0;
  const int F = widths[N_TRUNK];
  if (bf < 0 || bb < 0 || !shape_ok<T>(A, B, F, D, TRAIN))
    return (int)cudaErrorInvalidValue;
  const bool wide = trunk_wide(widths, TRAIN);
  const T* z = static_cast<const T*>(z_);
  const int e = (int)sizeof(T);
  T* at = static_cast<T*>(acts);
  for (int l = 0; l < N_TRUNK; ++l) {
    const int K = widths[l], N = widths[l + 1];
    tf.w[l] = static_cast<const T*>(wb[2 * l]);
    tf.b[l] = static_cast<const T*>(wb[2 * l + 1]);
    tf.vec_w[l] = tc::chunk_bytes(tf.w[l], N, e, (long long)K * N);
    if (TRAIN || wide || l == N_TRUNK - 1) {
      tf.act[l] = at;
      at += (long long)A * B * N;
    } else {
      tf.act[l] = nullptr;
    }
    tf.vec_act[l] =
        tf.act[l] ? tc::chunk_bytes(tf.act[l], N, e, (long long)B * N) : 0;
  }
  tf.vec_z = tc::chunk_bytes(z, widths[0], e, (long long)B * widths[0]);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + TM - 1) / TM, A);

  // f32: the passes read copies of z and the weights with every NaN quiet
  // (the split of the products would lose the card's own NaN)
  const void* w11 = wb[2 * N_TRUNK];
  if (std::is_same<T, float>::value) {
    QuietCopy c = quiet_arrays(z, wb, widths, A, B, D);
    const int rc = quiet_copies(c, static_cast<float*>(quiet_ws), st);
    if (rc) return rc;
    z = reinterpret_cast<const T*>(c.q[0]);
    for (int l = 0; l < N_TRUNK; ++l)
      tf.w[l] = reinterpret_cast<const T*>(c.q[1 + l]);
    w11 = c.q[1 + N_TRUNK];
  }
  if (wide)
    return launch_wide<T, TRAIN>(
        z, tf, w11, wb[2 * N_TRUNK + 1], x, x_arm_stride, A, B, D, thr,
        with_mism, part_sum, part_mism, out, static_cast<float*>(dh5),
        static_cast<float*>(part_grad), static_cast<T*>(dz),
        static_cast<float*>(dtrunk), dw11, db11, st);

  cudaError_t err = cudaFuncSetAttribute(
      decoder_trunk_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bf);
  if (err != cudaSuccess) return (int)err;
  decoder_trunk_fwd<T><<<grid, TTHREADS, (size_t)bf, st>>>(z, tf, B);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // the output layer and the loss: #2's passes on h_5
  const int rc = recon_launch<T, false, TRAIN>(
      tf.act[N_TRUNK - 1], w11, wb[2 * N_TRUNK + 1], x,
      x_arm_stride, nullptr, A, B, F, D, thr, with_mism, part_sum, part_mism,
      out, dh5, dw11, db11, nullptr, stream);
  if (rc != 0 || !TRAIN) return rc;

  // the trunk backward: tf's operands with the backward's pitches
  Trunk<T> tb = tf;
  trunk_plan<T>(widths, true, &tb);
  const int vec_dh = tc::chunk_bytes(dh5, F, 4, (long long)B * F);
  err = cudaFuncSetAttribute(decoder_trunk_bwd<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bb);
  if (err != cudaSuccess) return (int)err;
  decoder_trunk_bwd<T><<<grid, TTHREADS, (size_t)bb, st>>>(
      z, tb, static_cast<const float*>(dh5), vec_dh, B,
      static_cast<float*>(part_grad), static_cast<T*>(dz));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Segments seg;
  for (int l = 0; l < N_TRUNK; ++l) {
    seg.off[2 * l] = tb.w_off[l];
    seg.size[2 * l] = widths[l] * widths[l + 1];
    seg.off[2 * l + 1] = tb.b_off[l];
    seg.size[2 * l + 1] = widths[l + 1];
  }
  const dim3 g3((tb.n_grad + GRAD_THREADS - 1) / GRAD_THREADS, A);
  decoder_grad_reduce<<<g3, GRAD_THREADS, 0, st>>>(
      static_cast<const float*>(part_grad), (int)grid.x, tb.n_grad, seg, A,
      static_cast<float*>(dtrunk));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Loss partials of one arm: the row tiles times the slices of D of #2's
// row plan; -1 if the shape is refused.
long long decoder_partials_per_arm(int A, int B, int D) {
  if (!shape_ok<float>(A, B, 1, D, false)) return -1;
  const RowPlan p = plan(A, B, D);
  return (long long)p.row_tiles * p.n_split;
}

// Floats of the workspace of the quiet copies in f32 (quiet_ws of the
// entry points).
long long decoder_quiet_ws_floats(const int* widths, int A, int B, int D) {
  QuietCopy c = quiet_arrays(nullptr, nullptr, widths, A, B, D);
  return quiet_workspace(&c, nullptr);
}

// Length of one row tile's trunk-gradient partial vector (and of one arm's
// reduced trunk gradients): sum of (in + 1) * out over fc6..fc10.
long long decoder_grad_len(const int* widths) { return n_grad_of(widths); }

// Elements (operand type) of the activations' workspace: h_5 alone for the
// value-only call of the resident passes, else h_1..h_5.
long long decoder_acts_elems(const int* widths, int A, int B, int train) {
  long long n = 0;
  const bool all = train != 0 || trunk_wide(widths, train != 0);
  for (int l = 1; l <= N_TRUNK; ++l)
    if (all || l == N_TRUNK) n += widths[l];
  return n * A * B;
}

// Floats of the training call's part_grad scratch: one trunk-gradient
// partial vector per row tile, or the wide trunk's two g buffers.
long long decoder_grad_scratch_floats(const int* widths, int A, int B) {
  if (trunk_wide(widths, true))
    return 2LL * A * B * trunk_wmax(widths);
  return (long long)A * ((B + TM - 1) / TM) * n_grad_of(widths);
}

// Largest F (out_10) the call takes in f32 (bf16 0) or bf16: the limit of
// #2's passes on h_5 (recon_passes.cuh max_f), with dh in training.
int decoder_max_f(int bf16, int train) {
  return bf16 ? max_f<__nv_bfloat16>(train != 0) : max_f<float>(train != 0);
}

// h5: decoder_acts_elems scratch in the operand type; quiet_ws: in f32 the
// scratch of decoder_quiet_ws_floats floats (the quiet copies of z and the
// weights), unused in bf16.
int decoder_fwd_f32(const void* z, const void* const* wb, const int* widths,
                    const void* x, long long x_arm_stride, int A, int B,
                    int D, float thr, int with_mism, void* part_sum,
                    void* part_mism, void* out, void* h5, void* quiet_ws,
                    void* stream) {
  return launch<float, false>(z, wb, widths, x, x_arm_stride, A, B, D, thr,
                              with_mism, part_sum, part_mism, out, h5,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, quiet_ws, stream);
}

int decoder_fwd_bf16(const void* z, const void* const* wb, const int* widths,
                     const void* x, long long x_arm_stride, int A, int B,
                     int D, float thr, int with_mism, void* part_sum,
                     void* part_mism, void* out, void* h5, void* quiet_ws,
                     void* stream) {
  return launch<__nv_bfloat16, false>(z, wb, widths, x, x_arm_stride, A, B, D,
                                      thr, with_mism, part_sum, part_mism,
                                      out, h5, nullptr, nullptr, nullptr,
                                      nullptr, nullptr, nullptr, quiet_ws,
                                      stream);
}

// Training: also acts (A * B * (out_6 + ... + out_10)) scratch in the
// operand type, dh5 (A,B,F) f32 scratch, part_grad
// (decoder_grad_scratch_floats) f32 scratch, dz (A,B,Z) in the operand
// type, dtrunk (A *
// grad_len) f32 laid out layer-major (dW_6 (A,in,out), db_6 (A,out), dW_7,
// ...), dW_11 (A,F,D) and db_11 (A,D) f32.
int decoder_fwdbwd_f32(const void* z, const void* const* wb,
                       const int* widths, const void* x,
                       long long x_arm_stride, int A, int B, int D, float thr,
                       int with_mism, void* part_sum, void* part_mism,
                       void* out, void* acts, void* dh5, void* part_grad,
                       void* dz, void* dtrunk, void* dw11, void* db11,
                       void* quiet_ws, void* stream) {
  return launch<float, true>(z, wb, widths, x, x_arm_stride, A, B, D, thr,
                             with_mism, part_sum, part_mism, out, acts, dh5,
                             part_grad, dz, dtrunk, dw11, db11, quiet_ws,
                             stream);
}

int decoder_fwdbwd_bf16(const void* z, const void* const* wb,
                        const int* widths, const void* x,
                        long long x_arm_stride, int A, int B, int D,
                        float thr, int with_mism, void* part_sum,
                        void* part_mism, void* out, void* acts, void* dh5,
                        void* part_grad, void* dz, void* dtrunk, void* dw11,
                        void* db11, void* quiet_ws, void* stream) {
  return launch<__nv_bfloat16, true>(z, wb, widths, x, x_arm_stride, A, B, D,
                                     thr, with_mism, part_sum, part_mism, out,
                                     acts, dh5, part_grad, dz, dtrunk, dw11,
                                     db11, quiet_ws, stream);
}

}  // extern "C"
