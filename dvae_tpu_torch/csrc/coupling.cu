// Fused arm-coupling distance: the (A, A) Gram matrix of the
// precision-scaled, centred log posteriors and the pair sum that follows
// from it, without materialising log(c + eps) or the scaled tensor, in one
// launch.  Hand-written for Hopper (sm_90a), bound with ctypes.
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
// 9.2 MB -> 0.0027 ms at 3.35 TB/s; one log, three sums and prec an
// element and A(A+1)/2 multiply-adds a (row, column), 6.2e7 operations,
// 0.0009 ms at the FP32 cores' 67 TFLOP/s.  Bound by bytes; at this size
// a launch's latency and the grid barriers are as large.
//
// Design: one cooperative launch of `coupling_fused`, a persistent grid of
// nb = min(SLOTS, ceil(B / MIN_ROWS)) blocks (132 at the production shape):
// a constant, not the card's SM count, so that the order of every sum
// depends on the shape alone.  All blocks are co-resident (the cooperative
// launch refuses a grid the card cannot hold, and the call then fails).
// Block b owns the contiguous slab of rows [b * rows, (b + 1) * rows) of
// every arm (rows = ceil(B / nb), 38 here).
//   phase 0: the slab arrives by cp.async (one copy of all A arms, 70 KB
//     here) in shared memory; each thread owns (arm, column) pairs and sums
//     c, c^2 and log(c + eps) down the slab's rows in double, writing the
//     logs back over c; per-block partials (double) go to the workspace.
//   grid barrier; then block b computes w and m of the columns b, b + nb,
//     .. from every block's partials in a fixed order in double (a warp an
//     arm, as the separate weights launch did); grid barrier.
//   phase 1: prec from the logs in shared memory, the A(A+1)/2 Gram sums
//     of the slab in registers, a per-block partial; the last block to
//     finish, found by an integer ticket (zeroed by block 0 before the
//     first barrier), sums the partials in a fixed order in double and
//     writes G both ways and the distance.
// Where a slab's logs do not fit SLAB_BYTES of shared memory (a large B, or
// many arms and categories), the slab is walked in pieces of `piece` rows,
// the column sums carried in the workspace, and phase 1 reads c again (from
// L2) and takes its logs again.
//
// Any A and C.  The templated kernel above serves A <= TILED_ARMS and
// C <= TILED_C, where its A(A+1)/2 Gram sums fit in registers and w, m and
// one row of the slab fit shared memory.  Past either, `coupling_general`
// (one cooperative launch on the same plan of blocks and slabs, 32 warps a
// block: its loads are paced by latency, not bytes) keeps nothing of c in
// shared memory: phase 0 sums each (arm, column) down the
// slab straight from device memory, w and m stay in the workspace (read
// through L2), and phase 1 walks the arm pairs in tiles of TA x TA arms
// (p <= q), each tile one pass over the slab that takes the logs of its
// arms again, its TA * TA sums in registers.  Each pass reads 2 TA arms'
// rows at most, so c is read about ceil(A / TA) + 1 times: at (16, 2000,
// 1100), 10 passes.  Its sums keep fixed orders too.
// w and m need two barriers, not one: every block needs all of them, and
// summing the nb partials of all A * C columns in each block would read
// nb times more than the one block a column does here.
// Workspace (one buffer with the output, `coupling_buffer_floats`): the
// output (A * A + 1 floats, padded to 64), the phase-0 partials (nb * 3 *
// A * C doubles), w (A * C), m (C), the Gram partials (nb * A(A+1)/2) and
// the ticket.  Sums are in fixed orders; no float atomics; repeated
// launches are bit-identical.  Ragged edges (the last slab, empty slabs of
// small B) are masked, never padded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"  // tc::cp_async

namespace {

namespace cg = cooperative_groups;

constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int TILED_ARMS = 10;  // the templated kernel's most arms
constexpr int TILED_C = 1024;   // and categories; past either, the general
constexpr int TA = 4;           // kernel, whose Gram tiles are TA x TA arms
constexpr int GWARPS = 32;      // and whose blocks hold 32 warps: latency,
constexpr int GTHREADS = GWARPS * 32;  // not bytes, paces its loads
constexpr int SLOTS = 132;      // most blocks: an H100 SXM's SMs, a constant
constexpr int MIN_ROWS = 8;     // fewest rows a slab holds
constexpr int SLAB_BYTES = 160 * 1024;  // shared memory for the slab
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

// The launch plan, from the shape alone.
struct Plan {
  int nb;     // blocks
  int rows;   // rows of a slab
  int piece;  // rows of the slab in shared memory at a time
  int keep;   // the whole slab's logs stay in shared memory for phase 1
  long long smem;  // dynamic shared memory of a block, bytes
  int general;     // coupling_general (any A, C) instead of the template
};

Plan make_plan(int A, int B, int C) {
  Plan p;
  const int by_rows = (B + MIN_ROWS - 1) / MIN_ROWS;
  p.nb = by_rows < SLOTS ? by_rows : SLOTS;
  p.rows = (B + p.nb - 1) / p.nb;
  p.general = A > TILED_ARMS || C > TILED_C;
  if (p.general) {  // no slab in shared memory; w * SL of each arm there
    p.keep = 0;
    p.piece = 0;
    p.smem = 8LL * A;
    return p;
  }
  const long long row_bytes = 4LL * A * C;
  p.keep = p.rows * row_bytes <= SLAB_BYTES;
  p.piece = p.keep ? p.rows : (int)(SLAB_BYTES / row_bytes);
  if (p.piece < 1) p.piece = 1;
  p.smem = p.piece * row_bytes + 4LL * (A + 1) * C;
  return p;
}

// Offsets (in floats) of the regions of the one buffer.
struct Layout {
  long long part0, w, m, gpart, ticket, gsum, total;
};

// gsum (the general kernel's Gram sums, NP doubles) only where `general`
__host__ __device__ Layout make_layout(int A, int C, int nb, int general) {
  Layout l;
  const long long np = (long long)A * (A + 1) / 2;
  l.part0 = ((long long)A * A + 1 + 63) / 64 * 64;  // doubles from here
  l.w = l.part0 + 2LL * nb * 3 * A * C;
  l.m = l.w + (long long)A * C;
  l.gpart = l.m + C;
  l.ticket = l.gpart + nb * np;
  l.gsum = (l.ticket + 2) / 2 * 2;                  // doubles from here
  l.total = general ? l.gsum + 2 * np : l.ticket + 1;
  return l;
}

// Copy rows [r0, r1) of every arm's slab into buf (arm, row, column).
__device__ __forceinline__ void load_piece(const float* __restrict__ c,
                                           float* buf, int A, int B, int C,
                                           int r0, int r1, int piece,
                                           int tid) {
  const int n = (r1 - r0) * C;
  for (int a = 0; a < A; ++a) {
    const float* src = c + ((long long)a * B + r0) * C;
    float* dst = buf + (long long)a * piece * C;
    int i0 = 0;
    if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
      i0 = n / 4 * 4;
      for (int i = 4 * tid; i < i0; i += 4 * THREADS)
        tc::cp_async<16>(dst + i, src + i, true);
    }
    for (int i = i0 + tid; i < n; i += THREADS)
      tc::cp_async<4>(dst + i, src + i, true);
  }
  tc::cp_commit();
  tc::cp_wait<0>();
  __syncthreads();
}

template <int A>
__global__ void __launch_bounds__(THREADS)
coupling_fused(const float* __restrict__ c, int B, int C, float eps,
               Plan pl, float* __restrict__ buf_out) {
  constexpr int NP = A * (A + 1) / 2;
  extern __shared__ __align__(16) float sm[];
  __shared__ float red[NP][WARPS];
  __shared__ double wl[TILED_ARMS];
  __shared__ double gsum[NP];
  __shared__ int last;
  const Layout lay = make_layout(A, C, pl.nb, 0);
  double* part0 = reinterpret_cast<double*>(buf_out + lay.part0);
  float* w = buf_out + lay.w;
  float* m = buf_out + lay.m;
  float* gpart = buf_out + lay.gpart;
  unsigned* ticket = reinterpret_cast<unsigned*>(buf_out + lay.ticket);
  float* slab = sm;                             // (A, piece, C)
  float* w_s = sm + (long long)A * pl.piece * C;  // (A, C)
  float* m_s = w_s + A * C;                     // (C)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, nb = pl.nb;
  const int r0 = min(B, blk * pl.rows), r1 = min(B, r0 + pl.rows);
  const int AC = A * C;
  cg::grid_group grid = cg::this_grid();
  if (blk == 0 && tid == 0) *ticket = 0u;

  // phase 0: the column sums of the slab, piece by piece, carried in this
  // block's partials; the logs written over c
  double* mine = part0 + (long long)blk * 3 * AC;
  for (int p0 = r0; p0 < r1 || p0 == r0; p0 += pl.piece) {
    const int p1 = min(r1, p0 + pl.piece);
    if (p1 > p0) load_piece(c, slab, A, B, C, p0, p1, pl.piece, tid);
    for (int pr = tid; pr < AC; pr += THREADS) {
      double s1 = 0.0, s2 = 0.0, sl = 0.0;
      if (p0 > r0) {
        s1 = mine[pr];
        s2 = mine[AC + pr];
        sl = mine[2 * AC + pr];
      }
      float* col = slab + (long long)(pr / C) * pl.piece * C + pr % C;
      for (int r = 0; r < p1 - p0; ++r) {
        const float v = col[(long long)r * C];
        const float l = logf(v + eps);
        s1 += (double)v;
        s2 += (double)v * (double)v;
        sl += (double)l;
        col[(long long)r * C] = l;
      }
      mine[pr] = s1;
      mine[AC + pr] = s2;
      mine[2 * AC + pr] = sl;
    }
    __syncthreads();  // the slab buffer is free for the next piece
    if (p1 >= r1) break;
  }
  grid.sync();

  // w and m of the columns blk, blk + nb, ..: a warp an arm, the blocks'
  // partials in block order (lane-strided, then the warp's tree), double
  for (int col = blk; col < C; col += nb) {
    for (int a = warp; a < A; a += WARPS) {
      double s = 0.0, q = 0.0, l = 0.0;
      for (int b = lane; b < nb; b += 32) {
        const double* pb = part0 + (long long)b * 3 * AC + a * C + col;
        s += __ldcg(pb);
        q += __ldcg(pb + AC);
        l += __ldcg(pb + 2 * AC);
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
    }
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int i = 0; i < A; ++i) t += wl[i];
      m[col] = (float)(t / A / B);
    }
    __syncthreads();
  }
  grid.sync();

  // phase 1: prec of the slab's elements and the Gram sums a <= d
  for (int i = tid; i < AC; i += THREADS) w_s[i] = __ldcg(w + i);
  for (int i = tid; i < C; i += THREADS) m_s[i] = __ldcg(m + i);
  __syncthreads();
  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = 0.f;
  for (int p0 = r0; p0 < r1; p0 += pl.piece) {
    const int p1 = min(r1, p0 + pl.piece);
    const int n = (p1 - p0) * C;
    if (!pl.keep) {  // c again, from L2, and its logs
      load_piece(c, slab, A, B, C, p0, p1, pl.piece, tid);
      for (int a = 0; a < A; ++a)
        for (int i = tid; i < n; i += THREADS) {
          float* v = slab + (long long)a * pl.piece * C + i;
          *v = logf(*v + eps);
        }
      __syncthreads();
    }
    for (int i = tid; i < n; i += THREADS) {
      const int col = i % C;
      const float mv = m_s[col];
      float prec[A];
#pragma unroll
      for (int a = 0; a < A; ++a)
        prec[a] =
            slab[(long long)a * pl.piece * C + i] * w_s[a * C + col] - mv;
      int k = 0;
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int d = a; d < A; ++d) {
          acc[k] = fmaf(prec[a], prec[d], acc[k]);
          ++k;
        }
    }
    if (!pl.keep) __syncthreads();  // the buffer is free for the next piece
  }
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const float v = warp_sum(acc[k]);
    if (lane == 0) red[k][warp] = v;
  }
  __syncthreads();
  if (tid < NP) {
    float t = 0.f;
#pragma unroll
    for (int wp = 0; wp < WARPS; ++wp) t += red[tid][wp];
    gpart[(long long)blk * NP + tid] = t;
  }

  // the last block to arrive sums the Gram partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int k = warp; k < NP; k += WARPS) {
    double s = 0.0;
    for (int b = lane; b < nb; b += 32)
      s += (double)__ldcg(gpart + (long long)b * NP + k);
    s = warp_sum(s);
    if (lane == 0) gsum[k] = s;
  }
  __syncthreads();
  if (tid == 0) {
    double tr = 0.0, total = 0.0;
    int k = 0;
    for (int a = 0; a < A; ++a)
      for (int d = a; d < A; ++d) {
        const double v = gsum[k++];
        buf_out[a * A + d] = (float)v;
        buf_out[d * A + a] = (float)v;
        if (d == a) {
          tr += v;
          total += v;
        } else {
          total += 2.0 * v;
        }
      }
    buf_out[A * A] = (float)((A * tr - total) / B);
  }
}

// Any A and C (see the note at the top): the plan's blocks and slabs, c
// read from device memory in every phase, w and m from the workspace, the
// Gram in tiles of TA x TA arms.
__global__ void __launch_bounds__(GTHREADS)
coupling_general(const float* __restrict__ c, int A, int B, int C, float eps,
                 Plan pl, float* __restrict__ buf_out) {
  constexpr int TP = TA * TA;
  extern __shared__ __align__(16) double wl_all[];  // (A)
  __shared__ float red[TP][GWARPS];
  __shared__ int last;
  const long long NP = (long long)A * (A + 1) / 2;
  const Layout lay = make_layout(A, C, pl.nb, 1);
  double* part0 = reinterpret_cast<double*>(buf_out + lay.part0);
  float* w = buf_out + lay.w;
  float* m = buf_out + lay.m;
  float* gpart = buf_out + lay.gpart;
  unsigned* ticket = reinterpret_cast<unsigned*>(buf_out + lay.ticket);
  double* gsum = reinterpret_cast<double*>(buf_out + lay.gsum);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, nb = pl.nb;
  const int r0 = min(B, blk * pl.rows), r1 = min(B, r0 + pl.rows);
  const long long AC = (long long)A * C;
  cg::grid_group grid = cg::this_grid();
  if (blk == 0 && tid == 0) *ticket = 0u;

  // phase 0: each thread's (arm, column) pairs summed down the slab, rows
  // in order; neighbouring threads read neighbouring columns of a row
  double* mine = part0 + (long long)blk * 3 * AC;
  for (long long pr = tid; pr < AC; pr += GTHREADS) {
    const float* col = c + (pr / C) * (long long)B * C + pr % C;
    double s1 = 0.0, s2 = 0.0, sl = 0.0;
    for (int r = r0; r < r1; ++r) {
      const float v = __ldg(col + (long long)r * C);
      s1 += (double)v;
      s2 += (double)v * (double)v;
      sl += (double)logf(v + eps);
    }
    mine[pr] = s1;
    mine[AC + pr] = s2;
    mine[2 * AC + pr] = sl;
  }
  grid.sync();

  // w and m of the columns blk, blk + nb, ..: as the templated kernel
  for (int col = blk; col < C; col += nb) {
    for (int a = warp; a < A; a += GWARPS) {
      double s = 0.0, q = 0.0, l = 0.0;
      for (int b = lane; b < nb; b += 32) {
        const double* pb = part0 + (long long)b * 3 * AC + (long long)a * C
                           + col;
        s += __ldcg(pb);
        q += __ldcg(pb + AC);
        l += __ldcg(pb + 2 * AC);
      }
      s = warp_sum(s);
      q = warp_sum(q);
      l = warp_sum(l);
      if (lane == 0) {
        const double var = (q - s * s / B) / (B - 1);
        const double wa = 1.0 / sqrt(fmax(var, 0.0) + (double)eps);
        w[(long long)a * C + col] = (float)wa;
        wl_all[a] = wa * l;
      }
    }
    __syncthreads();
    if (tid == 0) {
      double t = 0.0;
      for (int i = 0; i < A; ++i) t += wl_all[i];
      m[col] = (float)(t / A / B);
    }
    __syncthreads();
  }
  grid.sync();

  // phase 1: the tiles (p, q), p <= q, of TA x TA arm pairs, one pass over
  // the slab each; a tile's sums a <= d go to this block's partials
  const int nt = (A + TA - 1) / TA;
  const int n = (r1 - r0) * C;
  for (int p = 0; p < nt; ++p)
    for (int q = p; q < nt; ++q) {
      float acc[TA][TA];
#pragma unroll
      for (int u = 0; u < TA; ++u)
#pragma unroll
        for (int v = 0; v < TA; ++v) acc[u][v] = 0.f;
      for (int i = tid; i < n; i += GTHREADS) {
        const int row = r0 + i / C, col = i % C;
        const float mv = __ldcg(m + col);
        float pa[TA], pd[TA];
#pragma unroll
        for (int u = 0; u < TA; ++u) {
          const int a = p * TA + u, d = q * TA + u;
          pa[u] = a < A ? logf(__ldg(c + ((long long)a * B + row) * C + col)
                               + eps) * __ldcg(w + (long long)a * C + col)
                          - mv
                        : 0.f;
          if (p != q)
            pd[u] = d < A ? logf(__ldg(c + ((long long)d * B + row) * C
                                       + col) + eps)
                                * __ldcg(w + (long long)d * C + col) - mv
                          : 0.f;
        }
        if (p == q)
#pragma unroll
          for (int u = 0; u < TA; ++u) pd[u] = pa[u];
#pragma unroll
        for (int u = 0; u < TA; ++u)
#pragma unroll
          for (int v = 0; v < TA; ++v)
            acc[u][v] = fmaf(pa[u], pd[v], acc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < TA; ++u)
#pragma unroll
        for (int v = 0; v < TA; ++v) {
          const float s = warp_sum(acc[u][v]);
          if (lane == 0) red[u * TA + v][warp] = s;
        }
      __syncthreads();
      if (tid < TP) {
        const int a = p * TA + tid / TA, d = q * TA + tid % TA;
        if (a < A && d < A && a <= d) {
          float t = 0.f;
#pragma unroll
          for (int wp = 0; wp < GWARPS; ++wp) t += red[tid][wp];
          // k of (a, d) in the order a = 0.., d = a..
          const long long k = (long long)a * A - (long long)a * (a - 1) / 2
                              + (d - a);
          gpart[(long long)blk * NP + k] = t;
        }
      }
      __syncthreads();  // red is free for the next tile
    }

  // the last block to arrive sums the Gram partials in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (long long k = warp; k < NP; k += GWARPS) {
    double s = 0.0;
    for (int b = lane; b < nb; b += 32)
      s += (double)__ldcg(gpart + (long long)b * NP + k);
    s = warp_sum(s);
    if (lane == 0) gsum[k] = s;
  }
  __syncthreads();
  if (tid == 0) {
    double tr = 0.0, total = 0.0;
    long long k = 0;
    for (int a = 0; a < A; ++a)
      for (int d = a; d < A; ++d) {
        const double v = gsum[k++];
        buf_out[(long long)a * A + d] = (float)v;
        buf_out[(long long)d * A + a] = (float)v;
        if (d == a) {
          tr += v;
          total += v;
        } else {
          total += 2.0 * v;
        }
      }
    buf_out[(long long)A * A] = (float)((A * tr - total) / B);
  }
}

int launch_general(const float* c, int A, int B, int C, float eps,
                   const Plan& pl, float* buf, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&coupling_general);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  Plan p = pl;
  void* args[] = {(void*)&c, (void*)&A, (void*)&B, (void*)&C, (void*)&eps,
                  (void*)&p, (void*)&buf};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(pl.nb), dim3(GTHREADS),
                                          args, (size_t)pl.smem, st);
}

template <int A>
int launch(const float* c, int B, int C, float eps, const Plan& pl,
           float* buf, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(&coupling_fused<A>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.smem);
  if (err != cudaSuccess) return (int)err;
  Plan p = pl;
  void* args[] = {(void*)&c, (void*)&B, (void*)&C, (void*)&eps, (void*)&p,
                  (void*)&buf};
  return (int)cudaLaunchCooperativeKernel(fn, dim3(pl.nb), dim3(THREADS),
                                          args, (size_t)pl.smem, st);
}

bool shape_ok(int A, int B, int C) {
  return A >= 1 && B >= 2 && C >= 1;
}

}  // namespace

extern "C" {

// Floats of the one buffer a call needs (the output first, A * A + 1
// floats: G row by row, then the distance; then the workspace); -1 if the
// shape is refused.
long long coupling_buffer_floats(int A, int B, int C) {
  if (!shape_ok(A, B, C)) return -1;
  const Plan p = make_plan(A, B, C);
  return make_layout(A, C, p.nb, p.general).total;
}

// The launch plan for the shape: out[0] blocks, out[1] rows a slab,
// out[2] rows a piece, out[3] logs kept in shared memory (1) or taken
// again (0), out[4] dynamic shared memory a block in bytes, out[5] the
// general kernel (1) or the templated one (0).  0, or -1 if the shape is
// refused.
int coupling_plan(int A, int B, int C, long long* out) {
  if (!shape_ok(A, B, C)) return -1;
  const Plan p = make_plan(A, B, C);
  out[0] = p.nb;
  out[1] = p.rows;
  out[2] = p.piece;
  out[3] = p.keep;
  out[4] = p.smem;
  out[5] = p.general;
  return 0;
}

int coupling_gram_f32(const void* c, float eps, int A, int B, int C,
                      void* buffer, void* stream) {
  if (!shape_ok(A, B, C)) return (int)cudaErrorInvalidValue;
  const Plan pl = make_plan(A, B, C);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cc = static_cast<const float*>(c);
  float* buf = static_cast<float*>(buffer);
  if (pl.general) return launch_general(cc, A, B, C, eps, pl, buf, st);
  switch (A) {
    case 1: return launch<1>(cc, B, C, eps, pl, buf, st);
    case 2: return launch<2>(cc, B, C, eps, pl, buf, st);
    case 3: return launch<3>(cc, B, C, eps, pl, buf, st);
    case 4: return launch<4>(cc, B, C, eps, pl, buf, st);
    case 5: return launch<5>(cc, B, C, eps, pl, buf, st);
    case 6: return launch<6>(cc, B, C, eps, pl, buf, st);
    case 7: return launch<7>(cc, B, C, eps, pl, buf, st);
    case 8: return launch<8>(cc, B, C, eps, pl, buf, st);
    case 9: return launch<9>(cc, B, C, eps, pl, buf, st);
    default: return launch<10>(cc, B, C, eps, pl, buf, st);
  }
}

}  // extern "C"
