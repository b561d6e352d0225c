// Tensor-core and asynchronous-copy building blocks shared by the port's
// product kernels (zinb_rows.cuh, zinb_fwdbwd.cu, encoder_fc1.cu,
// recon_passes.cuh, decoder.cu).  Device code only.
//
// Products run as warp-level `mma.sync` on Hopper's tensor cores with f32
// accumulation: m16n8k16 for bf16 operands, m16n8k8 for tf32.  f32
// operands go through the 3xTF32 split: a = a_hi + a_lo with both halves
// rounded to tf32 (`cvt.rna`), and a*b = a_hi*b_hi + a_hi*b_lo + a_lo*b_hi;
// the dropped a_lo*b_lo is below 2^-21 of |a*b|, so a sum keeps about the
// accuracy of an f32 sum, where plain TF32 keeps about three digits.
//
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k8/k16"), lane
// = 4*g + t (g = lane / 4, t = lane % 4):
//   m16n8k8 tf32   A: a0 (g, t)  a1 (g+8, t)  a2 (g, t+4)  a3 (g+8, t+4)
//                  B: b0 (k t, n g)  b1 (k t+4, n g)
//   m16n8k16 bf16  A: a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)
//                     a3 (g+8, 2t+8..)  (pairs packed low index first)
//                  B: b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C/D, both:     c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// Any permutation of k applied to A and B alike leaves the product as it
// is; the kernels use that to take A straight from a C tile in registers.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- asynchronous copies -------------------------------------------------

// One chunk of BYTES (16, 8 or 4) from global to shared memory; with
// ok == false nothing is read and the chunk is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const uint32_t d = smem_addr(dst);
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Largest chunk (16, 8 or 4 bytes; 0: element by element) that keeps every
// row of a (rows, pitch) array of ELEM-byte elements, starting at `base`,
// on chunk boundaries.  Host side: the launchers pass it to the kernels.
inline int chunk_bytes(const void* base, long long pitch_elems, int elem,
                       long long extra_stride_elems = 0) {
  const unsigned long long p = reinterpret_cast<unsigned long long>(base);
  for (int c = 16; c >= 4; c /= 2) {
    if (p % c == 0 && (pitch_elems * elem) % c == 0 &&
        (extra_stride_elems * elem) % c == 0)
      return c;
  }
  return 0;
}

// Copy the tile src[r][c] (r < rows, c < cols; row pitch ld_src elements)
// into dst[r][c] (row pitch ld_dst), zero where r >= rows_ok or
// c >= cols_ok, cooperatively by `nthr` threads.  `chunk` is the value of
// chunk_bytes for src; cols, ld_dst and the column offset of src must be
// multiples of its element count (the callers' tiles are).  With chunk 0
// the copy is synchronous, element by element.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ld_dst, const T* src,
                                          long long ld_src, int rows, int cols,
                                          int rows_ok, int cols_ok, int chunk,
                                          int tid, int nthr) {
  if (chunk == 0) {
    for (int i = tid; i < rows * cols; i += nthr) {
      const int r = i / cols, c = i % cols;
      dst[r * ld_dst + c] = (r < rows_ok && c < cols_ok)
                                ? src[(long long)r * ld_src + c]
                                : T(0.f);
    }
    return;
  }
  const int ce = chunk / (int)sizeof(T);  // elements per chunk
  const int per_row = cols / ce;
  for (int i = tid; i < rows * per_row; i += nthr) {
    const int r = i / per_row, c = (i % per_row) * ce;
    const bool ok = r < rows_ok && c < cols_ok;
    const T* s = ok ? src + (long long)r * ld_src + c : src;
    T* d = dst + r * ld_dst + c;
    if (chunk == 16)
      cp_async<16>(d, s, ok);
    else if (chunk == 8)
      cp_async<8>(d, s, ok);
    else
      cp_async<4>(d, s, ok);
  }
}

template <int COLS, int NT, int CHUNK, typename T>
__device__ __forceinline__ void load_tile_chunks(T* dst, int ld_dst,
                                                 const T* src, long long ld_src,
                                                 int rows, int rows_ok,
                                                 int cols_ok, int tid) {
  constexpr int CE = CHUNK / (int)sizeof(T);
  constexpr int PER_ROW = COLS / CE;
  for (int i = tid; i < rows * PER_ROW; i += NT) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * CE;
    const bool ok = r < rows_ok && c < cols_ok;
    const T* s = ok ? src + (long long)r * ld_src + c : src;
    cp_async<CHUNK>(dst + r * ld_dst + c, s, ok);
  }
}

// load_tile for a tile COLS wide, copied by NT threads, both known at
// compile time: the chunk's row and column come from a division by a
// constant, where the generic form divides by a run-time count for every
// chunk of every stage (measured on the H100: #5 bf16 14% and #6 f32 6%
// faster, PERF.md §6).
template <int COLS, int NT, typename T>
__device__ __forceinline__ void load_tile_c(T* dst, int ld_dst, const T* src,
                                            long long ld_src, int rows,
                                            int rows_ok, int cols_ok,
                                            int chunk, int tid) {
  constexpr int E = (int)sizeof(T);
  if constexpr (COLS % (16 / E) == 0) {
    if (chunk == 16)
      return load_tile_chunks<COLS, NT, 16>(dst, ld_dst, src, ld_src, rows,
                                            rows_ok, cols_ok, tid);
  }
  if constexpr (COLS % (8 / E) == 0) {
    if (chunk == 8)
      return load_tile_chunks<COLS, NT, 8>(dst, ld_dst, src, ld_src, rows,
                                           rows_ok, cols_ok, tid);
  }
  if (chunk == 4)
    return load_tile_chunks<COLS, NT, 4>(dst, ld_dst, src, ld_src, rows,
                                         rows_ok, cols_ok, tid);
  load_tile(dst, ld_dst, src, ld_src, rows, COLS, rows_ok, cols_ok, chunk,
            tid, NT);
}

// ---- tensor-core products ------------------------------------------------

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// The same split as split_tf32, bit for bit, in integer arithmetic: adding
// half a tf32 unit to the magnitude bits and clearing the 13 low bits
// rounds to nearest with ties away from zero, as cvt.rna does (a carry
// into the exponent included).  Two integer operations and one f32
// subtraction a value, all at full rate, where cvt.rna.tf32.f32 issues as
// a conversion.  Unlike cvt.rna it does not keep every NaN: one whose
// mantissa's top ten bits are all ones (the card's own NaN, 0x7FFFFFFF)
// carries through the exponent into the sign and becomes -0; the quiet
// NaN 0x7FC00000 stays a NaN.  So the kernels that split this way make
// the NaNs of what they split quiet: quiet_nan on a value they store, and
// on copies of their operands (recon_passes.cuh quiet_copy).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
__device__ __forceinline__ void split_tf32_bits(float x, uint32_t& hi,
                                                uint32_t& lo) {
  hi = tf32_bits(x);
  lo = tf32_bits(x - __uint_as_float(hi));
}

// A NaN as the quiet NaN 0x7FC00000, whose bits split_tf32_bits keeps;
// every other value as it is.
__device__ __forceinline__ float quiet_nan(float v) {
  return v == v ? v : __uint_as_float(0x7FC00000u);
}

// Not volatile: the products have no side effect, so the compiler may
// interleave independent ones instead of issuing dependent ones back to
// back.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A (m16k8) and B (k8n8) fragments of f32 values, split once.
struct SplitA {
  uint32_t hi[4], lo[4];
};
struct SplitB {
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ SplitA split_a(float a0, float a1, float a2,
                                          float a3) {
  SplitA s;
  split_tf32(a0, s.hi[0], s.lo[0]);
  split_tf32(a1, s.hi[1], s.lo[1]);
  split_tf32(a2, s.hi[2], s.lo[2]);
  split_tf32(a3, s.hi[3], s.lo[3]);
  return s;
}

__device__ __forceinline__ SplitB split_b(float b0, float b1) {
  SplitB s;
  split_tf32(b0, s.hi[0], s.lo[0]);
  split_tf32(b1, s.hi[1], s.lo[1]);
  return s;
}

// split_a / split_b through split_tf32_bits
__device__ __forceinline__ SplitA split_a_bits(float a0, float a1, float a2,
                                               float a3) {
  SplitA s;
  split_tf32_bits(a0, s.hi[0], s.lo[0]);
  split_tf32_bits(a1, s.hi[1], s.lo[1]);
  split_tf32_bits(a2, s.hi[2], s.lo[2]);
  split_tf32_bits(a3, s.hi[3], s.lo[3]);
  return s;
}

__device__ __forceinline__ SplitB split_b_bits(float b0, float b1) {
  SplitB s;
  split_tf32_bits(b0, s.hi[0], s.lo[0]);
  split_tf32_bits(b1, s.hi[1], s.lo[1]);
  return s;
}

// big += a_hi*b_hi, small += a_lo*b_hi + a_hi*b_lo: a*b by 3xTF32 in two
// accumulators, so that a run of products forms two dependent chains of
// half the length; the caller adds small to big once per run.
__device__ __forceinline__ void mma_3xtf32(float (&big)[4], float (&small)[4],
                                           const SplitA& a, const SplitB& b) {
  mma_tf32(small, a.lo, b.hi);
  mma_tf32(big, a.hi, b.hi);
  mma_tf32(small, a.hi, b.lo);
}

// acc += t, rounded to nearest.  The tensor cores round a sum toward zero
// (measured on the H100: an f32 accumulator carried through the 1,887
// mma of a depth-5032 3xTF32 product drifts by 3e-5 of its largest
// entry); so the kernels sum a short run of mma (one step's worth of k)
// from zero and add that to the long-lived accumulator here.
__device__ __forceinline__ void add4(float (&acc)[4], const float (&t)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += t[i];
}

__device__ __forceinline__ void zero4(float (&acc)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = 0.f;
}

// acc += big + small, the two accumulators of a 3xTF32 run
__device__ __forceinline__ void add4(float (&acc)[4], const float (&big)[4],
                                     const float (&small)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += big[i] + small[i];
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Four 8x8 b16 matrices, transposed on the way (B, or A stored k-major):
// lane l gives the address of row (l % 8) of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Two matrices: lanes 0-15 give the row addresses (lanes 16-31 must still
// point into shared memory).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

}  // namespace tc
