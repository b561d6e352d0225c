// Fused reconstruction-loss forward AND backward of the training step:
// decoder output layer + ReLU + MSE + binarized-mismatch count, with the
// unscaled gradients of the loss sum, without materialising the (A, B, D)
// reconstruction or its cotangent.  Hand-written for Hopper (sm_90a),
// bound with ctypes.
//
// Replaces the TPU kernel dvae_tpu/ops/recon_pallas.py `_fwdbwd_kernel`
// (:239), launched by `_fwdbwd_call` (:299, pallas_call at :310).  Per arm
// a, with r = relu(h_a W_a + bias_a) and the row/column mask of the edge
// tiles (:288-296),
//
//     sumsq_a = sum (r - x)^2,   mism_a = #{ (r > thr) != (x > thr) }
//     gm      = 2 * 1[r > 0] * (r - x)                       (never stored)
//     dh_a    = gm W_a^T,  dW_a = h_a^T gm,  db_a = sum_rows gm
//
// gm is rounded to h's dtype for the two products and kept in f32 for db
// and the sums, as the TPU kernel does (:270, :281).  The gradients are
// those of the loss sum with cotangent 1; the autograd backward scales
// them by the per-arm cotangent (recon_pallas.py:366-383).
//
// The same two passes also serve as the separate backward for a given
// per-arm cotangent g (A,), replacing `_bwd_kernel` (:143), launched by
// `_bwd_call` (:190, pallas_call at :202): gm = 2 g_a 1[r > 0] (r - x), no
// sums (entry points recon_bwd_*; template flag SEPARATE, so that g = 1
// gives the fused call's gradients bit for bit).
//
// Operands: h (A,B,F), W (A,F,D), bias (A,D), x (B,D) shared (arm stride 0)
// or per-arm (A,B,D); all f32 or all bf16.  Outputs, all f32: (A,2) sums,
// dh (A,B,F), dW (A,F,D), db (A,D).  F up to recon_fwdbwd_max_f (512 f32,
// 1,296 bf16): the wide forms of the passes past 128.
//
// Bound at the production shape (A=5, B=5000, F=100, D=5032), one launch:
//   three products of 2*A*B*F*D = 25.2 GFLOP each (the recompute of y in
//   pass 2 left out), 75.5 GFLOP -> 0.153 ms at the TF32 tensor-core peak
//   (495 TFLOP/s; f32 operands taken as one TF32 product, the least work
//   for f32-accurate products: the 3xTF32 split does three), 0.076 ms at
//   the bf16 peak (989 TFLOP/s); bytes (operands read once, outputs written
//   once, 142 MB f32) 0.042 ms.  Bound by operations.
//
// Design: csrc/recon_passes.cuh, which holds the two passes, their plan and
// their launch sequence; the whole-decoder kernels (decoder.cu) run the
// same passes on the trunk's last activation.

#include "recon_passes.cuh"

extern "C" {

// Number of block partials the scratch buffers hold for each arm (the
// row tiles times the slices of D of the plan); -1 if the shape is
// refused.
long long recon_fwdbwd_partials_per_arm(int A, int B, int D) {
  if (!shape_ok<float>(A, B, 1, D, false)) return -1;
  const RowPlan p = plan(A, B, D);
  return (long long)p.row_tiles * p.n_split;
}

// The row plan of pass 1 for the shape: out[0] slices of D, out[1]
// columns a slice, out[2] row tiles.  0, or -1 if the shape is refused.
int recon_fwdbwd_plan(int A, int B, int D, int* out) {
  if (!shape_ok<float>(A, B, 1, D, false)) return -1;
  const RowPlan p = plan(A, B, D);
  out[0] = p.n_split;
  out[1] = p.cols_per_split;
  out[2] = p.row_tiles;
  return 0;
}

// Floats of the workspace of the quiet copies in f32 (quiet_ws of the
// entry points).
long long recon_fwdbwd_quiet_ws_floats(int A, int B, int F, int D) {
  QuietCopy c = recon_quiet_arrays(nullptr, nullptr, A, B, F, D);
  return quiet_workspace(&c, nullptr);
}

// Largest hidden width F the kernels take in f32 (bf16 0) or bf16: past 128
// the wide forms' shared memory sets it (recon_passes.cuh max_f).
int recon_fwdbwd_max_f(int bf16) {
  return bf16 ? max_f<__nv_bfloat16>(true) : max_f<float>(true);
}

// quiet_ws: in f32 the scratch of recon_fwdbwd_quiet_ws_floats floats
// (the copies of h and W with every NaN quiet), unused in bf16.
int recon_fwdbwd_f32(const void* h, const void* w, const void* bias,
                     const void* x, long long x_arm_stride, int A, int B,
                     int F, int D, float thr, int with_mism, void* part_sum,
                     void* part_mism, void* out, void* dh, void* dw, void* db,
                     void* quiet_ws, void* stream) {
  return recon_launch<float, false>(h, w, bias, x, x_arm_stride, nullptr, A,
                                    B, F, D, thr, with_mism, part_sum,
                                    part_mism, out, dh, dw, db, quiet_ws,
                                    stream);
}

int recon_fwdbwd_bf16(const void* h, const void* w, const void* bias,
                      const void* x, long long x_arm_stride, int A, int B,
                      int F, int D, float thr, int with_mism, void* part_sum,
                      void* part_mism, void* out, void* dh, void* dw,
                      void* db, void* quiet_ws, void* stream) {
  return recon_launch<__nv_bfloat16, false>(
      h, w, bias, x, x_arm_stride, nullptr, A, B, F, D, thr, with_mism,
      part_sum, part_mism, out, dh, dw, db, quiet_ws, stream);
}

// The separate backward: dh, dW, db for the per-arm cotangent g (A,) f32.
int recon_bwd_f32(const void* g, const void* h, const void* w,
                  const void* bias, const void* x, long long x_arm_stride,
                  int A, int B, int F, int D, void* dh, void* dw, void* db,
                  void* quiet_ws, void* stream) {
  if (!g) return (int)cudaErrorInvalidValue;
  return recon_launch<float, true>(h, w, bias, x, x_arm_stride, g, A, B, F,
                                   D, 0.f, 0, nullptr, nullptr, nullptr, dh,
                                   dw, db, quiet_ws, stream);
}

int recon_bwd_bf16(const void* g, const void* h, const void* w,
                   const void* bias, const void* x, long long x_arm_stride,
                   int A, int B, int F, int D, void* dh, void* dw, void* db,
                   void* quiet_ws, void* stream) {
  if (!g) return (int)cudaErrorInvalidValue;
  return recon_launch<__nv_bfloat16, true>(h, w, bias, x, x_arm_stride, g,
                                           A, B, F, D, 0.f, 0, nullptr,
                                           nullptr, nullptr, dh, dw, db,
                                           quiet_ws, stream);
}

// The value-only row pass on h, as the whole-decoder forward (#12) runs
// it on its h5: the (A,2) sums alone, partials and quiet_ws as above.
// Nothing in the port calls it; chip_smoke.py and
// scripts/torch_kernel_variants.py time kernel #1 (recon_fwd.cu) beside it.
int recon_rows_value_f32(const void* h, const void* w, const void* bias,
                         const void* x, long long x_arm_stride, int A, int B,
                         int F, int D, float thr, int with_mism,
                         void* part_sum, void* part_mism, void* out,
                         void* quiet_ws, void* stream) {
  return recon_launch<float, false, false>(
      h, w, bias, x, x_arm_stride, nullptr, A, B, F, D, thr, with_mism,
      part_sum, part_mism, out, nullptr, nullptr, nullptr, quiet_ws, stream);
}

int recon_rows_value_bf16(const void* h, const void* w, const void* bias,
                          const void* x, long long x_arm_stride, int A,
                          int B, int F, int D, float thr, int with_mism,
                          void* part_sum, void* part_mism, void* out,
                          void* quiet_ws, void* stream) {
  return recon_launch<__nv_bfloat16, false, false>(
      h, w, bias, x, x_arm_stride, nullptr, A, B, F, D, thr, with_mism,
      part_sum, part_mism, out, nullptr, nullptr, nullptr, quiet_ws, stream);
}

}  // extern "C"
