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
// operand type and, in f32, dW_i, db_i, dW_11, db_11.  Every trunk output
// width <= 128; Z is bounded by the shared memory (decoder_smem_bytes).
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
template <typename T>
long long trunk_plan(const int* widths, bool bwd, Trunk<T>* tr) {
  int wmax = 0, kwide = 0, nwide = 0;
  for (int l = 0; l <= N_TRUNK; ++l) {
    if (widths[l] < 1) return -1;
    if (l > 0 && widths[l] > WP) return -1;
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

// wb: host array of the 12 device pointers W_6, b_6, ..., W_10, b_10, W_11,
// b_11; widths: host array Z, out_6, ..., out_10.  acts: h_5 (A,B,F) in
// the operand type, and in training h_1..h_5, each (A,B,out_l), one after
// the other.
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
  if (bf < 0 || bb < 0 || bf > MAX_SMEM || bb > MAX_SMEM ||
      !shape_ok(A, B, F, D))
    return (int)cudaErrorInvalidValue;
  const T* z = static_cast<const T*>(z_);
  const int e = (int)sizeof(T);
  T* at = static_cast<T*>(acts);
  for (int l = 0; l < N_TRUNK; ++l) {
    const int K = widths[l], N = widths[l + 1];
    tf.w[l] = static_cast<const T*>(wb[2 * l]);
    tf.b[l] = static_cast<const T*>(wb[2 * l + 1]);
    tf.vec_w[l] = tc::chunk_bytes(tf.w[l], N, e, (long long)K * N);
    if (TRAIN || l == N_TRUNK - 1) {
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
  if (!shape_ok(A, B, 1, D)) return -1;
  const RowPlan p = plan(A, B, D);
  return (long long)p.row_tiles * p.n_split;
}

// Floats of the workspace of the quiet copies in f32 (quiet_ws of the
// entry points).
long long decoder_quiet_ws_floats(const int* widths, int A, int B, int D) {
  QuietCopy c = quiet_arrays(nullptr, nullptr, widths, A, B, D);
  return quiet_workspace(&c, nullptr);
}

// Row tiles of one arm: the trunk-gradient partial vectors it leaves.
long long decoder_row_tiles(int B) { return (long long)((B + TM - 1) / TM); }

// Length of one row tile's trunk-gradient partial vector (and of one arm's
// reduced trunk gradients): sum of (in + 1) * out over fc6..fc10.
long long decoder_grad_len(const int* widths) { return n_grad_of(widths); }

// Dynamic shared memory the largest block of the call needs for these
// widths, in f32 (-1: a trunk output wider than 128, or a width below 1),
// and the most a block may take.
long long decoder_smem_bytes(const int* widths, int train) {
  return smem_need(widths, train != 0);
}
long long decoder_max_smem() { return MAX_SMEM; }

// h5: (A,B,F) scratch in the operand type; quiet_ws: in f32 the scratch of
// decoder_quiet_ws_floats floats (the quiet copies of z and the weights),
// unused in bf16.
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
// operand type, dh5 (A,B,F) f32 scratch, part_grad (A * row tiles *
// grad_len) f32 scratch, dz (A,B,Z) in the operand type, dtrunk (A *
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
