// Per-element math of the fused three-head ZINB loss, shared by the
// value-only forward (zinb_fwd.cu) and the training kernels
// (zinb_fwdbwd.cu).  Device code only; f32 throughout.
//
// The forms are those of dvae_tpu/ops/zinb_pallas.py: the branch-free
// shifted-Stirling difference `_lgdg_diff` (:184-232) and `digamma`
// (:169-181) with the P4 clamp (:93, :164, :214-215) and the clip of the
// shift ratio q to [1, P4_CLAMP] (:223); counts k = min(expm1(x), 1e12)
// (:97-99); sigma with y clamped at -30 (:143-147); the loss of
// `_tile_zinb_sum` (:244-262) and the analytic cotangents of
// `_fwdbwd_kernel` (:472-515) and `_bwd_kernel` (:359-387).
//
// Division is IEEE division and log/exp/expm1 are the accurate libdevice
// functions: these sources must not be compiled with --use_fast_math.
// Relative noise of 1e-5 on sigma -> p near 1 is an unbounded relative
// error on 1 - p, and rows with a tiny rate (psi(r) ~ -1/r) dominate the
// dW sums (zinb_pallas.py:128-138).
//
// Clamps are written as comparisons, not fminf/fmaxf, so that a NaN
// operand stays a NaN as jnp.minimum/maximum keep it.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace zinb {

constexpr float P4_CLAMP = 3.0e38f;
constexpr float COUNT_CLAMP = 1.0e12f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
// v rounded to the operand type and back: the TPU kernel's gm16
__device__ __forceinline__ float round_as(float v, const float*) { return v; }
__device__ __forceinline__ float round_as(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float clamp_max(float v, float hi) {
  return (v > hi) ? hi : v;
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return (v < lo) ? lo : v;
}

// Shift product x(x+1)(x+2)(x+3) = x^4 + 6x^3 + 11x^2 + 6x, saturated just
// under the f32 maximum, and its derivative.
__device__ __forceinline__ float p4(float x) {
  return clamp_max((((x + 6.f) * x + 11.f) * x + 6.f) * x, P4_CLAMP);
}
__device__ __forceinline__ float p4d(float x) {
  return ((4.f * x + 18.f) * x + 22.f) * x + 6.f;
}

__device__ __forceinline__ float counts(float x) {
  return clamp_max(expm1f(x), COUNT_CLAMP);
}

__device__ __forceinline__ float sigmoid_clamped(float y) {
  return 1.f / (1.f + expf(-clamp_min(y, -30.f)));
}

// psi(x), x > 0: the shifted series differentiated term by term.
__device__ __forceinline__ float digamma(float x) {
  const float u = x + 4.f;
  const float inv = 1.f / u;
  const float inv2 = inv * inv;
  const float series =
      inv2 * (1.f / 12.f - inv2 * (1.f / 120.f - inv2 / 252.f));
  return logf(u) - 0.5f * inv - series - p4d(x) / p4(x);
}

// (lnG(r) - lnG(k+r), psi(r) - psi(k+r)) from one evaluation.
template <bool WANT_LG, bool WANT_DG>
__device__ __forceinline__ void lgdg_diff(float k, float r, float& dlg,
                                          float& ddg) {
  const float kr = k + r;
  const float u1 = kr + 4.f;
  const float u2 = r + 4.f;
  const float inv1 = 1.f / u1;
  const float inv2 = 1.f / u2;
  const float i1sq = inv1 * inv1;
  const float i2sq = inv2 * inv2;
  const float logu1 = logf(u1);
  const float logu2 = logf(u2);
  const float p41 = p4(kr);
  const float p42 = p4(r);
  if (WANT_LG) {
    const float s1 =
        inv1 * (1.f / 12.f - i1sq * (1.f / 360.f - i1sq / 1260.f));
    const float s2 =
        inv2 * (1.f / 12.f - i2sq * (1.f / 360.f - i2sq / 1260.f));
    const float q = clamp_max(clamp_min(p41 / p42, 1.f), P4_CLAMP);
    dlg = (u2 - 0.5f) * logu2 - (u1 - 0.5f) * logu1 + k + (s2 - s1) + logf(q);
  }
  if (WANT_DG) {
    const float d1 =
        i1sq * (1.f / 12.f - i1sq * (1.f / 120.f - i1sq / 252.f));
    const float d2 =
        i2sq * (1.f / 12.f - i2sq * (1.f / 120.f - i2sq / 252.f));
    ddg = logu2 - logu1 - 0.5f * (inv2 - inv1) - (d2 - d1) - p4d(r) / p42 +
          p4d(kr) / p41;
  }
}

// One element of the loss and of its cotangents with respect to the three
// pre-activations y_r, y_p, y_z (bias included), scaled by ga:
//   r = relu(y_r) + eps,  p = (1-eps)(sigma(y_p) + eps),
//   z = (1-eps)(sigma(y_z) + eps),  k = counts(x)
//   loss = k > 0 ? lnG(r) - lnG(k+r) - k log p - r log(1-p) - log(1-z)
//                : -log(z + (1-z)(1-p)^r)
// TWO_DIGAMMA (gradients only) takes psi(r) - psi(k+r) from two digamma
// calls, the separate backward kernel's form, instead of the shared
// difference.
template <bool LOSS, bool GRAD, bool TWO_DIGAMMA>
__device__ __forceinline__ void element(float y_r, float y_p, float y_z,
                                        float xv, float eps, float one_m_eps,
                                        float ga, float& loss, float& g_r,
                                        float& g_p, float& g_z) {
  static_assert(!TWO_DIGAMMA || (GRAD && !LOSS),
                "the two-digamma form serves the separate backward only");
  const float k = counts(xv);
  const float r = ((y_r < 0.f) ? 0.f : y_r) + eps;  // NaN stays, like relu
  const float sigp = sigmoid_clamped(y_p);
  const float sigz = sigmoid_clamped(y_z);
  const float p = one_m_eps * (sigp + eps);
  const float z = one_m_eps * (sigz + eps);
  const float omp = 1.f - p;
  const float omz = 1.f - z;
  const float log1mp = logf(omp);
  const float E = expf(r * log1mp);  // (1-p)^r
  const float D0 = z + omz * E;
  const bool nz = k > 0.f;
  float dlg = 0.f, ddg = 0.f;
  if (nz) {
    if (TWO_DIGAMMA) {
      ddg = -digamma(k + r) + digamma(r);
    } else {
      lgdg_diff<LOSS, GRAD>(k, r, dlg, ddg);
    }
  }
  if (LOSS) {
    const float log_sel = logf(nz ? omz : D0);
    loss = (nz ? dlg - k * logf(p) - r * log1mp : 0.f) - log_sel;
  }
  if (GRAD) {
    const float invD0 = 1.f / D0;
    const float inv_p1mp = 1.f / (p * omp);
    float dr, dp, dz;
    if (nz) {
      dr = ddg - log1mp;
      dp = (r * p - k * omp) * inv_p1mp;
      dz = 1.f / omz;
    } else {
      const float common = invD0 * omz * E;
      dr = -common * log1mp;
      dp = common * r * (p * inv_p1mp);
      dz = -invD0 * (1.f - E);
    }
    g_r = (y_r > 0.f) ? ga * dr : 0.f;
    g_p = ga * dp * (one_m_eps * sigp * (1.f - sigp));
    g_z = ga * dz * (one_m_eps * sigz * (1.f - sigz));
  }
}

}  // namespace zinb
