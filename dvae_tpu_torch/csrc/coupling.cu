// Fused arm-coupling distance: the (A, A) Gram matrix of the
// precision-scaled, centred log posteriors and the pair sum that follows
// from it, without materialising log(c + eps) or the scaled tensor.
// Hand-written for Hopper (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel of dvae_tpu/ops/coupling_pallas.py: `_kernel`
// (:51), launched by `coupling_gram_pallas` (:102, pallas_call :109) and
// used by `coupling_distance_pallas` (:129).  For c (A, B, C) f32:
//   phase 0   S1 = sum_B c, S2 = sum_B c^2, SL = sum_B log(c + eps)  (A, C)
//             var = (S2 - S1^2 / B) / (B - 1)      (unbiased, one pass)
//             w = rsqrt(max(var, 0) + eps),  m = mean_A(w * SL) / B
//   phase 1   prec = log(c + eps) * w - m
//             G[a, d] = sum_{B, C} prec_a * prec_d
//   distance  (A * tr G - sum G) / B = sum_{a<d} mean_B |prec_a - prec_d|^2
// Both guards of the TPU kernel are kept (coupling_pallas.py:19-29):
// centring by m before the Gram (dead categories put the same huge
// constant into every arm, and the uncentred f32 Gram then cancels to
// nothing) and the clamp of the one-pass variance (slightly negative for a
// near-constant category).
//
// Bound at the production shape (A=5, B=5000, C=92), per call: c read once,
// 9.2 MB -> 0.0027 ms at 3.35 TB/s; two logs and A(A+1)/2 multiply-adds an
// element are below that.  The op is bound by bytes and, at this size, by
// the latency of its launches: c fits the 50 MB L2, so reading it twice is
// not what costs.
// What the design does about it: four small launches on one stream, no
// host round trip and no (A, B, C) intermediate.
//   (a) moments: block (row block of 64, arm) sums c, c^2 and log(c + eps)
//       per column into per-block partials;
//   (b) weights: block per column, one warp per arm, sums the partials in a
//       fixed order in double and writes w (A, C) and m (C);
//   (c) Gram: block per row block reads all arms of an element, forms prec
//       in registers and accumulates the A(A+1)/2 products a <= d (the
//       Gram is symmetric) into per-block partials;
//   (d) reduce: one block sums the Gram partials in a fixed order in double,
//       writes G both ways and the distance.
// The workspace is block partials only: A * nb * 3 * C + (A + 1) * C +
// nb * A(A+1)/2 floats with nb = ceil(B / 64) (113,160 floats, 0.45 MB, at
// the production shape).  Sums are per-block f32 partials reduced in a
// fixed order in double: repeated launches are bit-identical, no float
// atomics.  Ragged edges (the last row block, C not a multiple of 32) are
// masked, never padded.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;       // rows of one block's tile
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ARMS = 10;
constexpr int MAX_C = 1024;    // (A + 1) * C floats of shared memory in (c)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// (a) grid (nb, A).  part[((a * nb + blk) * 3 + k) * C + col], k = 0: sum c,
// 1: sum c^2, 2: sum log(c + eps) over the block's rows.
__global__ void __launch_bounds__(THREADS)
coupling_moments(const float* __restrict__ c, int B, int C, float eps,
                 float* __restrict__ part) {
  __shared__ float sh[3][WARPS][32];
  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int blk = blockIdx.x, a = blockIdx.y, nb = gridDim.x;
  const int r0 = blk * ROWS;
  const int r1 = min(r0 + ROWS, B);
  const float* ca = c + (long long)a * B * C;
  float* out = part + (long long)(a * nb + blk) * 3 * C;
  for (int col0 = 0; col0 < C; col0 += 32) {
    const int col = col0 + tx;
    float s = 0.f, q = 0.f, l = 0.f;
    if (col < C) {
      for (int r = r0 + ty; r < r1; r += WARPS) {
        const float v = ca[(long long)r * C + col];
        s += v;
        q += v * v;
        l += logf(v + eps);
      }
    }
    sh[0][ty][tx] = s;
    sh[1][ty][tx] = q;
    sh[2][ty][tx] = l;
    __syncthreads();
    if (ty < 3 && col < C) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) t += sh[ty][w][tx];
      out[ty * C + col] = t;
    }
    __syncthreads();
  }
}

// (b) grid (C), block (32, A).  w[a * C + col], m[col].
__global__ void coupling_weights(const float* __restrict__ part, int A, int B,
                                 int C, int nb, float eps,
                                 float* __restrict__ w, float* __restrict__ m) {
  __shared__ double wl[MAX_ARMS];
  const int col = blockIdx.x, a = threadIdx.y, lane = threadIdx.x;
  double s = 0.0, q = 0.0, l = 0.0;
  for (int blk = lane; blk < nb; blk += 32) {
    const float* p = part + (long long)(a * nb + blk) * 3 * C + col;
    s += (double)p[0];
    q += (double)p[C];
    l += (double)p[2 * C];
  }
  s = warp_sum(s);
  q = warp_sum(q);
  l = warp_sum(l);
  if (lane == 0) {
    const double var = (q - s * s / B) / (B - 1);
    const double wa = 1.0 / sqrt(fmax(var, 0.0) + (double)eps);
    w[a * C + col] = (float)wa;
    wl[a] = wa * l;
  }
  __syncthreads();
  if (lane == 0 && a == 0) {
    double t = 0.0;
    for (int i = 0; i < A; ++i) t += wl[i];
    m[col] = (float)(t / A / B);
  }
}

// (c) grid (nb).  gpart[blk * NP + k], k counting the pairs a <= d row by
// row, NP = A (A + 1) / 2.
template <int A>
__global__ void __launch_bounds__(THREADS)
coupling_gram_tiles(const float* __restrict__ c, int B, int C, float eps,
                    const float* __restrict__ w, const float* __restrict__ m,
                    float* __restrict__ gpart) {
  constexpr int NP = A * (A + 1) / 2;
  extern __shared__ float sm[];
  __shared__ float red[NP][WARPS];
  float* w_s = sm;          // (A, C)
  float* m_s = sm + A * C;  // (C)
  for (int i = threadIdx.x; i < A * C; i += THREADS) w_s[i] = w[i];
  for (int i = threadIdx.x; i < C; i += THREADS) m_s[i] = m[i];
  __syncthreads();

  const int tx = threadIdx.x & 31, ty = threadIdx.x >> 5;
  const int r0 = blockIdx.x * ROWS;
  const int r1 = min(r0 + ROWS, B);
  const long long arm = (long long)B * C;
  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.f;
  for (int col = tx; col < C; col += 32) {
    float wv[A];
#pragma unroll
    for (int a = 0; a < A; ++a) wv[a] = w_s[a * C + col];
    const float mv = m_s[col];
    for (int r = r0 + ty; r < r1; r += WARPS) {
      const float* p = c + (long long)r * C + col;
      float prec[A];
#pragma unroll
      for (int a = 0; a < A; ++a)
        prec[a] = logf(p[a * arm] + eps) * wv[a] - mv;
      int k = 0;
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int d = a; d < A; ++d) {
          acc[k] = fmaf(prec[a], prec[d], acc[k]);
          ++k;
        }
    }
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float v = warp_sum(acc[k]);
    if (tx == 0) red[k][ty] = v;
  }
  __syncthreads();
  if (threadIdx.x < NP) {
    float t = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) t += red[threadIdx.x][wp];
    gpart[(long long)blockIdx.x * NP + threadIdx.x] = t;
  }
}

// (d) one block.  out[a * A + d] = G[a, d]; out[A * A] = the distance.
__global__ void __launch_bounds__(THREADS)
coupling_gram_reduce(const float* __restrict__ gpart, int A, int B, int nb,
                     float* __restrict__ out) {
  __shared__ double g[MAX_ARMS * (MAX_ARMS + 1) / 2];
  const int NP = A * (A + 1) / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < NP; k += WARPS) {
    double s = 0.0;
    for (int blk = lane; blk < nb; blk += 32)
      s += (double)gpart[(long long)blk * NP + k];
    s = warp_sum(s);
    if (lane == 0) g[k] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double tr = 0.0, total = 0.0;
    int k = 0;
    for (int a = 0; a < A; ++a)
      for (int d = a; d < A; ++d) {
        const double v = g[k++];
        out[a * A + d] = (float)v;
        out[d * A + a] = (float)v;
        if (d == a) {
          tr += v;
          total += v;
        } else {
          total += 2.0 * v;
        }
      }
    out[A * A] = (float)((A * tr - total) / B);
  }
}

template <int A>
void launch_gram(int nb, size_t smem, cudaStream_t st, const float* c, int B,
                 int C, float eps, const float* w, const float* m,
                 float* gpart) {
  coupling_gram_tiles<A><<<nb, THREADS, smem, st>>>(c, B, C, eps, w, m, gpart);
}

int row_blocks(int B) { return (B + ROWS - 1) / ROWS; }

}  // namespace

extern "C" {

int coupling_max_arms() { return MAX_ARMS; }
int coupling_max_c() { return MAX_C; }

// Floats of scratch one call needs (block partials, w, m).
long long coupling_workspace_floats(int A, int B, int C) {
  const long long nb = row_blocks(B);
  return (long long)A * nb * 3 * C + (long long)(A + 1) * C +
         nb * (A * (A + 1) / 2);
}

// out: A * A + 1 floats, the Gram matrix then the distance.
int coupling_gram_f32(const void* c, float eps, int A, int B, int C,
                      void* workspace, void* out, void* stream) {
  if (A < 1 || A > MAX_ARMS || B < 2 || C < 1 || C > MAX_C)
    return (int)cudaErrorInvalidValue;
  const int nb = row_blocks(B);
  if (nb > 65535 * 32) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cc = static_cast<const float*>(c);
  float* part = static_cast<float*>(workspace);
  float* w = part + (long long)A * nb * 3 * C;
  float* m = w + (long long)A * C;
  float* gpart = m + C;

  coupling_moments<<<dim3(nb, A), THREADS, 0, st>>>(cc, B, C, eps, part);
  if (int e = (int)cudaGetLastError()) return e;
  coupling_weights<<<C, dim3(32, A), 0, st>>>(part, A, B, C, nb, eps, w, m);
  if (int e = (int)cudaGetLastError()) return e;
  const size_t smem = (size_t)(A + 1) * C * sizeof(float);
  switch (A) {
    case 1: launch_gram<1>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 2: launch_gram<2>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 3: launch_gram<3>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 4: launch_gram<4>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 5: launch_gram<5>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 6: launch_gram<6>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 7: launch_gram<7>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 8: launch_gram<8>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    case 9: launch_gram<9>(nb, smem, st, cc, B, C, eps, w, m, gpart); break;
    default: launch_gram<10>(nb, smem, st, cc, B, C, eps, w, m, gpart);
  }
  if (int e = (int)cudaGetLastError()) return e;
  coupling_gram_reduce<<<1, THREADS, 0, st>>>(gpart, A, B, nb,
                                              static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
