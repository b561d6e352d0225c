// Fused three-head ZINB loss, value only: the decoder's three output
// layers (NB rate r, success probability p, zero inflation z) and the
// zero-inflated negative-binomial negative log-likelihood summed per arm,
// without materialising any (A, B, D) tensor.  Hand-written for Hopper
// (sm_90a), bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/zinb_pallas.py `_fwd_kernel` (:269),
// launched by `_fwd` (:315, pallas_call at :321): the value-only forward of
// `fused_zinb` that eval and validation run.  Per arm a,
//
//     y_r = h_a W_r + b_r,  y_p = h_a W_p + b_p,  y_z = h_a W_z + b_z
//     out_a = sum_{b,d} zinb_nll(y_r, y_p, y_z, x)      (zinb_math.cuh)
//
// Operands: h (A,B,F); W_r, W_p, W_z (A,F,D); b_* (A,D); x (B,D) shared by
// every arm (arm stride 0) or per-arm (A,B,D), the log1p data: the counts
// k = min(expm1(x), 1e12) are taken per element here, from x in its own
// type, so no count tensor exists (the TPU op builds one outside its
// kernel, zinb_pallas.py:588).  All f32 or all bf16; products accumulate
// in f32, biases are added in f32.  Output (A,) f32.  F up to
// zinb_fwd_max_f (784 f32, 1,456 bf16): past 128 the wide form of the row
// pass (zinb_rows.cuh) walks F in chunks of 128.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   three products of 2*A*B*F*D = 25.2 GFLOP -> 75.5 GFLOP, 0.153 ms at
//   the TF32 tensor-core peak (495 TFLOP/s) for f32 operands taken as one
//   TF32 product, 0.076 ms at the bf16 peak (989 TFLOP/s); 141 MB read in
//   f32 -> 0.042 ms.  Bound by operations.  The bound leaves out the
//   epilogue, A*B*D = 1.26e8 elements with about nine log/exp calls and
//   five divisions each, which paces the kernel; and the 3xTF32 split
//   triples the tf32 work of f32 operands.
//
// Design: the value-only form (FT = 0) of the training kernel's row pass,
// `zinb_rows` in csrc/zinb_rows.cuh: blocks (64-row tile, arm, slice of D)
// of 4 warps, the three y tiles on the tensor cores (3xTF32 m16n8k8 for f32
// operands, m16n8k16 for bf16), the element math on the accumulators, one
// loss partial per block.  No dh accumulators, cotangents or dh product,
// and a single-buffered stage: the next tiles arrive while the element
// math, which paces the kernel, runs.  The slices of D come from the
// training kernel's `plan` (the shape alone) and the partials are reduced
// per arm in the same fixed order in double, so the value equals
// zinb_fwdbwd's loss bit for bit and repeated launches agree on any card.
// Ragged edges are masked: a masked element is never read and adds exactly
// 0 (an unmasked padded element would add -log(z + (1-z)(1-p)^r), not 0).

#include "zinb_rows.cuh"

namespace {

// Floats of the loss partials one launch writes; -1 if the shape is
// refused.
template <typename T>
long long partials(int A, int B, int F, int D) {
  if (!shape_ok(A, B, F, D, max_f_rows<T>(false))) return -1;
  const RowPlan p = plan<T>(A, B, D);
  return (long long)A * p.row_tiles * p.n_split;
}

template <typename T, bool WIDE>
int launch(const Args& p, void* part_sum, void* out, void* stream) {
  if (!shape_ok(p.A, p.B, p.F, p.D, max_f_rows<T>(false)))
    return (int)cudaErrorInvalidValue;
  const RowPlan plan_ = plan<T>(p.A, p.B, p.D);
  auto kern = zinb_rows<T, true, false, 0, WIDE>;
  const size_t smem = smem_rows<T>(p.F, false, WIDE);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(part_sum);
  const dim3 grid(plan_.row_tiles, p.A, plan_.n_split);
  kern<<<grid, THREADS1, smem, st>>>(
      static_cast<const T*>(p.h), heads_of<T>(p), static_cast<const T*>(p.x),
      p.x_arm_stride, nullptr, p.B, p.F, p.D, plan_.cols_per_split,
      plan_.n_split, p.eps, p.one_m_eps, vec_h_of<T>(p), vec_of<T>(p), part,
      Partials{});
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  zinb_loss_reduce<<<p.A, REDUCE_THREADS, 0, st>>>(
      part, plan_.row_tiles * plan_.n_split, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_any(const Args& p, void* part_sum, void* out, void* stream) {
  return p.F <= FP ? launch<T, false>(p, part_sum, out, stream)
                   : launch<T, true>(p, part_sum, out, stream);
}

}  // namespace

extern "C" {

// Floats of scratch (the loss partials) one launch needs; -1 if the shape
// is refused.
long long zinb_fwd_workspace(int bf16, int A, int B, int F, int D) {
  return bf16 ? partials<__nv_bfloat16>(A, B, F, D)
              : partials<float>(A, B, F, D);
}

// Largest row count one launch takes (row tiles on the grid's x axis).
long long zinb_fwd_max_rows() { return 0x7fffffffLL - BM1; }

// Largest hidden width F the kernel takes in f32 (bf16 0) or bf16.
int zinb_fwd_max_f(int bf16) {
  return bf16 ? max_f_rows<__nv_bfloat16>(false) : max_f_rows<float>(false);
}

int zinb_fwd_f32(ZINB_ARGS, void* part_sum, void* out, void* stream) {
  return launch_any<float>(ZINB_PACK, part_sum, out, stream);
}

int zinb_fwd_bf16(ZINB_ARGS, void* part_sum, void* out, void* stream) {
  return launch_any<__nv_bfloat16>(ZINB_PACK, part_sum, out, stream);
}

}  // extern "C"
