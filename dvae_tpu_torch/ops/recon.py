"""Fused reconstruction-loss forward: decoder output layer + ReLU + MSE +
binarized-mismatch count, without materialising the (A, B, D)
reconstruction.

Counterpart of dvae_tpu/ops/recon_pallas.py.  This slice ports the
value-only forward that eval runs (``_fwd_kernel``, recon_pallas.py:72)
as the hand-written CUDA kernel ``csrc/recon_fwd.cu``; its source note
states the bound and the design.  The fused forward+backward of training
is a later slice.

    sumsq_a = Σ_{b,d} (relu(h_a @ W_a + bias_a) − x)²
    mism_a  = #{binarize(relu(...)) ≠ binarize(x)}

``100·mism/(B·D)`` is the reference's binarized-BCE metric term
(mmidas/nn_model.py:544-545; see dvae_tpu/ops/recon_pallas.py:14-19).

On CPU tensors ``fused_recon_mse`` runs the plain version
``recon_mse_reference``; on CUDA tensors it launches the kernel or raises.
``fused_recon_mse.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import check_kernel_operands, on_cpu

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 4


def _lib() -> ctypes.CDLL:
    lib = _build.load("recon_fwd")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.recon_fwd_f32, lib.recon_fwd_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.recon_fwd_partials_per_arm.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.recon_fwd_partials_per_arm.restype = ctypes.c_longlong
        lib.recon_fwd_max_rows.argtypes = []
        lib.recon_fwd_max_rows.restype = ctypes.c_longlong
        lib._dvae_bound = True
    return lib


def _check_shapes(h, w, b, x):
    if h.dim() != 3 or w.dim() != 3 or b.dim() != 2:
        raise ValueError("expected h (A,B,F), w (A,F,D), b (A,D)")
    A, B, F = h.shape
    if tuple(w.shape[:2]) != (A, F):
        raise ValueError(f"w {tuple(w.shape)} does not match h {tuple(h.shape)}")
    D = w.shape[2]
    if tuple(b.shape) != (A, D):
        raise ValueError(f"b {tuple(b.shape)} is not ({A}, {D})")
    if tuple(x.shape) not in ((B, D), (A, B, D)):
        raise ValueError(f"x {tuple(x.shape)} is neither ({B}, {D}) nor "
                         f"({A}, {B}, {D})")
    return A, B, F, D


def recon_mse_reference(h, w, b, x, thr: float = 0.1):
    """Plain version: materialises the reconstruction in f32."""
    r = torch.relu(torch.baddbmm(b.float()[:, None, :], h.float(), w.float()))
    x = x.float()
    sumsq = ((r - x) ** 2).sum(dim=(1, 2))
    mism = ((r > thr) != (x > thr)).sum(dim=(1, 2)).float()
    return sumsq, mism


def fused_recon_mse(h, w, b, x, thr: float = 0.1, with_mism: bool = True):
    """Per-arm (sumsq, mismatch_count) of relu(h @ W + bias) against x.

    Args:
      h: (A, B, F) decoder pre-output hidden activations.
      w: (A, F, D) fc11 weights.  b: (A, D) fc11 bias.
      x: (B, D) shared target or (A, B, D) per-arm targets.
      thr: binarization threshold (reference nn_model.py:542).
      with_mism: count mismatches; without, ``mism`` is 0.

    Returns (sumsq (A,) f32, mism (A,) f32); 0.5·sumsq/B is the MSE term.
    """
    A, B, F, D = _check_shapes(h, w, b, x)
    if on_cpu(h, w, b, x):
        sumsq, mism = recon_mse_reference(h, w, b, x, thr)
        return sumsq, mism if with_mism else torch.zeros_like(mism)
    dtype = check_kernel_operands(("h", "w", "b", "x"), (h, w, b, x))
    if A == 0 or B == 0 or D == 0:
        raise ValueError(f"empty operand: A={A}, B={B}, D={D}")
    lib = _lib()
    if B > lib.recon_fwd_max_rows():
        raise ValueError(f"B={B} rows exceed one launch's grid")
    n_part = int(lib.recon_fwd_partials_per_arm(B, D))
    part_sum = torch.empty(A * n_part, device=h.device, dtype=torch.float32)
    part_mism = torch.empty(A * n_part, device=h.device, dtype=torch.int32)
    out = torch.empty((A, 2), device=h.device, dtype=torch.float32)
    fn = lib.recon_fwd_f32 if dtype == torch.float32 else lib.recon_fwd_bf16
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(),
                 0 if x.dim() == 2 else B * D, A, B, F, D, float(thr),
                 int(bool(with_mism)), part_sum.data_ptr(),
                 part_mism.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"recon_fwd kernel launch failed: CUDA error {err}")
    fused_recon_mse.launches += 1
    return out[:, 0], out[:, 1]


fused_recon_mse.launches = 0
