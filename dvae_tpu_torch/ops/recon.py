"""Fused reconstruction loss: decoder output layer + ReLU + MSE +
binarized-mismatch count, forward and backward, without materialising the
(A, B, D) reconstruction or its cotangent.

Counterpart of dvae_tpu/ops/recon_pallas.py.  Three hand-written CUDA
kernels carry it; each source note states its bound and its design:

  * ``csrc/recon_fwd.cu`` — the value-only forward that eval runs
    (``_fwd_kernel``, recon_pallas.py:72), on ``wgmma`` (``csrc/wgmma.cuh``)
    after a prep launch that lays h and W^T out for it; launched by
    ``fused_recon_mse`` when no gradient is asked for, counted by
    ``fused_recon_mse.launches``;
  * ``csrc/recon_fwdbwd.cu`` — the training forward with the unscaled
    gradients in the same call (``_fwdbwd_kernel``, recon_pallas.py:239);
    launched by ``recon_fwdbwd``, counted by ``recon_fwdbwd.launches``;
  * the same source's separate backward for a given per-arm cotangent,
    with the forward recomputed (``_bwd_kernel``, recon_pallas.py:143);
    launched by ``recon_bwd``, counted by ``recon_bwd.launches``.

    sumsq_a = Σ_{b,d} (relu(h_a @ W_a + bias_a) − x)²
    mism_a  = #{binarize(relu(...)) ≠ binarize(x)}

``100·mism/(B·D)`` is the reference's binarized-BCE metric term
(mmidas/nn_model.py:544-545; see dvae_tpu/ops/recon_pallas.py:14-19); it
carries no gradient.

Under autograd ``fused_recon_mse`` runs the fused forward+backward and
stashes dh/dW/db; its backward scales them by the per-arm cotangent of
``sumsq`` (recon_pallas.py:366-383).  On CPU tensors every wrapper runs
its plain version; on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import check_kernel_operands, on_cpu

_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong] + [ctypes.c_int] * 4 \
    + [ctypes.c_float, ctypes.c_int] + [ctypes.c_void_p] * 3
_FWDBWD_ARGTYPES = _ARGTYPES + [ctypes.c_void_p] * 5


def _lib() -> ctypes.CDLL:
    lib = _build.load("recon_fwd")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.recon_fwd_f32, lib.recon_fwd_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.recon_fwd_workspace_bytes.argtypes = [ctypes.c_int] * 5
        lib.recon_fwd_workspace_bytes.restype = ctypes.c_longlong
        lib.recon_fwd_plan.argtypes = [ctypes.c_int] * 5 \
            + [ctypes.POINTER(ctypes.c_longlong)]
        lib.recon_fwd_plan.restype = ctypes.c_int
        lib.recon_fwd_max_rows.argtypes = []
        lib.recon_fwd_max_rows.restype = ctypes.c_longlong
        lib._dvae_bound = True
    return lib


def _lib_fwdbwd() -> ctypes.CDLL:
    lib = _build.load("recon_fwdbwd")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.recon_fwdbwd_f32, lib.recon_fwdbwd_bf16):
            fn.argtypes = _FWDBWD_ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.recon_bwd_f32, lib.recon_bwd_bf16):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] \
                + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 5
            fn.restype = ctypes.c_int
        lib.recon_fwdbwd_partials_per_arm.argtypes = [ctypes.c_int] * 3
        lib.recon_fwdbwd_partials_per_arm.restype = ctypes.c_longlong
        lib.recon_fwdbwd_plan.argtypes = [ctypes.c_int] * 3 \
            + [ctypes.POINTER(ctypes.c_int)]
        lib.recon_fwdbwd_plan.restype = ctypes.c_int
        lib.recon_fwdbwd_quiet_ws_floats.argtypes = [ctypes.c_int] * 4
        lib.recon_fwdbwd_quiet_ws_floats.restype = ctypes.c_longlong
        lib.recon_fwdbwd_max_f.argtypes = [ctypes.c_int]
        lib.recon_fwdbwd_max_f.restype = ctypes.c_int
        lib._dvae_bound = True
    return lib


def _check_width(lib, F: int, dtype) -> None:
    """Raise unless kernels #2 and #3 take the hidden width F: any F up to
    128, wider ones in chunks of 128 while the column pass's resident
    (F, 64) tile of W fits a block's shared memory."""
    limit = int(lib.recon_fwdbwd_max_f(int(dtype == torch.bfloat16)))
    if F > limit:
        raise ValueError(f"F={F} exceeds {limit}, the widest hidden layer "
                         "for which the column pass's resident (F, 64) tile "
                         f"of W fits a block's 232,448 bytes of shared "
                         f"memory in {dtype}")


def _quiet_workspace(lib, A, B, F, D, dtype, dev):
    """f32 scratch for the copies of h and W with every NaN quiet, which
    the kernel's 3xTF32 split keeps and its passes read
    (csrc/recon_passes.cuh ``quiet_copy``); empty in bf16."""
    n = int(lib.recon_fwdbwd_quiet_ws_floats(A, B, F, D)) \
        if dtype == torch.float32 else 0
    return torch.empty(n, device=dev, dtype=torch.float32)


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

    With grad enabled and any of h, w, b requiring it, the training form
    (``recon_fwdbwd`` inside an autograd function); otherwise the
    value-only forward.

    Args:
      h: (A, B, F) decoder pre-output hidden activations.
      w: (A, F, D) fc11 weights.  b: (A, D) fc11 bias.
      x: (B, D) shared target or (A, B, D) per-arm targets.
      thr: binarization threshold (reference nn_model.py:542).
      with_mism: count mismatches; without, ``mism`` is 0.

    Returns (sumsq (A,) f32, mism (A,) f32); 0.5·sumsq/B is the MSE term.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (h, w, b)):
        return _FusedReconMSE.apply(h, w, b, x, thr, with_mism)
    return _recon_value(h, w, b, x, thr, with_mism)


def _recon_value(h, w, b, x, thr, with_mism):
    """Value-only forward: kernel #1 on CUDA, the plain version on CPU."""
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
    bf16 = dtype == torch.bfloat16
    n_ws = int(lib.recon_fwd_workspace_bytes(A, B, F, D, int(bf16)))
    if n_ws < 0:
        raise ValueError(f"shape A={A}, B={B}, F={F}, D={D} is refused")
    # the operands laid out for the products, and the block partials
    ws = torch.empty(n_ws, device=h.device, dtype=torch.uint8)
    out = torch.empty((A, 2), device=h.device, dtype=torch.float32)
    fn = lib.recon_fwd_bf16 if bf16 else lib.recon_fwd_f32
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(),
                 0 if x.dim() == 2 else B * D, A, B, F, D, float(thr),
                 int(bool(with_mism)), ws.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"recon_fwd kernel launch failed: CUDA error {err}")
    fused_recon_mse.launches += 1
    return out[:, 0], out[:, 1]


fused_recon_mse.launches = 0


def recon_fwdbwd_reference(h, w, b, x, thr: float = 0.1):
    """Plain version of the training kernel: (sumsq, mism, dh, dw, db), the
    gradients of Σ sumsq unscaled, in f32.  gm is rounded to h's dtype for
    the two products, as the kernel does; db sums the f32 gm."""
    r = torch.relu(torch.baddbmm(b.float()[:, None, :], h.float(), w.float()))
    xf = x.float()
    e = r - xf
    sumsq = (e * e).sum(dim=(1, 2))
    mism = ((r > thr) != (xf > thr)).sum(dim=(1, 2)).float()
    gm = torch.where(r > 0, 2.0 * e, torch.zeros_like(e))
    gm16 = gm.to(h.dtype).float()
    dh = torch.bmm(gm16, w.float().transpose(1, 2))
    dw = torch.bmm(h.float().transpose(1, 2), gm16)
    db = gm.sum(dim=1)
    return sumsq, mism, dh, dw, db


def recon_fwdbwd(h, w, b, x, thr: float = 0.1, with_mism: bool = True):
    """Per-arm (sumsq, mism) and the unscaled gradients (dh (A,B,F),
    dw (A,F,D), db (A,D), f32) of Σ_a sumsq_a in one call: kernel #2 on
    CUDA tensors, ``recon_fwdbwd_reference`` on CPU tensors."""
    A, B, F, D = _check_shapes(h, w, b, x)
    if on_cpu(h, w, b, x):
        sumsq, mism, dh, dw, db = recon_fwdbwd_reference(h, w, b, x, thr)
        return sumsq, mism if with_mism else torch.zeros_like(mism), dh, dw, db
    dtype = check_kernel_operands(("h", "w", "b", "x"), (h, w, b, x))
    if A == 0 or B == 0 or D == 0:
        raise ValueError(f"empty operand: A={A}, B={B}, D={D}")
    lib = _lib_fwdbwd()
    _check_width(lib, F, dtype)
    n_part = int(lib.recon_fwdbwd_partials_per_arm(A, B, D))
    if n_part < 0:
        raise ValueError(f"shape A={A}, B={B}, D={D} exceeds one launch's grid")
    dev = h.device
    part_sum = torch.empty(A * n_part, device=dev, dtype=torch.float32)
    part_mism = torch.empty(A * n_part, device=dev, dtype=torch.int32)
    out = torch.empty((A, 2), device=dev, dtype=torch.float32)
    dh = torch.empty((A, B, F), device=dev, dtype=torch.float32)
    dw = torch.empty((A, F, D), device=dev, dtype=torch.float32)
    db = torch.empty((A, D), device=dev, dtype=torch.float32)
    quiet_ws = _quiet_workspace(lib, A, B, F, D, dtype, dev)
    fn = (lib.recon_fwdbwd_f32 if dtype == torch.float32
          else lib.recon_fwdbwd_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(h.data_ptr(), w.data_ptr(), b.data_ptr(), x.data_ptr(),
                 0 if x.dim() == 2 else B * D, A, B, F, D, float(thr),
                 int(bool(with_mism)), part_sum.data_ptr(),
                 part_mism.data_ptr(), out.data_ptr(), dh.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), quiet_ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"recon_fwdbwd kernel launch failed: CUDA error {err}")
    recon_fwdbwd.launches += 1
    return out[:, 0], out[:, 1], dh, dw, db


recon_fwdbwd.launches = 0


def recon_bwd_reference(g, h, w, b, x):
    """Plain version of the separate backward kernel: (dh, dw, db) of
    Σ_a g_a·sumsq_a, in f32; gm = 2·g_a·(r − x) through the ReLU gate,
    rounded to h's dtype for the two products (recon_pallas.py:157-178)."""
    r = torch.relu(torch.baddbmm(b.float()[:, None, :], h.float(), w.float()))
    two_g = (2.0 * g.float())[:, None, None]
    gm = torch.where(r > 0, two_g * (r - x.float()), torch.zeros_like(r))
    gm16 = gm.to(h.dtype).float()
    dh = torch.bmm(gm16, w.float().transpose(1, 2))
    dw = torch.bmm(h.float().transpose(1, 2), gm16)
    return dh, dw, gm.sum(dim=1)


def recon_bwd(g, h, w, b, x):
    """(dh (A,B,F), dw (A,F,D), db (A,D), f32) for the per-arm cotangent
    ``g`` (A,) of sumsq, with the forward recomputed: the separate backward
    kernel on CUDA tensors, ``recon_bwd_reference`` on CPU tensors."""
    A, B, F, D = _check_shapes(h, w, b, x)
    if tuple(g.shape) != (A,):
        raise ValueError(f"g {tuple(g.shape)} is not ({A},)")
    if on_cpu(g, h, w, b, x):
        return recon_bwd_reference(g, h, w, b, x)
    dtype = check_kernel_operands(("h", "w", "b", "x"), (h, w, b, x))
    if A == 0 or B == 0 or D == 0:
        raise ValueError(f"empty operand: A={A}, B={B}, D={D}")
    lib = _lib_fwdbwd()
    _check_width(lib, F, dtype)
    dev = h.device
    g32 = g.float().contiguous()
    dh = torch.empty((A, B, F), device=dev, dtype=torch.float32)
    dw = torch.empty((A, F, D), device=dev, dtype=torch.float32)
    db = torch.empty((A, D), device=dev, dtype=torch.float32)
    quiet_ws = _quiet_workspace(lib, A, B, F, D, dtype, dev)
    fn = lib.recon_bwd_f32 if dtype == torch.float32 else lib.recon_bwd_bf16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g32.data_ptr(), h.data_ptr(), w.data_ptr(), b.data_ptr(),
                 x.data_ptr(), 0 if x.dim() == 2 else B * D, A, B, F, D,
                 dh.data_ptr(), dw.data_ptr(), db.data_ptr(),
                 quiet_ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"recon_bwd kernel launch failed: CUDA error {err}")
    recon_bwd.launches += 1
    return dh, dw, db


recon_bwd.launches = 0


class _FusedReconMSE(torch.autograd.Function):
    """The fused training op: forward = ``recon_fwdbwd``; backward scales
    the stashed gradients by the per-arm cotangent of sumsq.  ``mism`` is
    a metric without gradient (recon_pallas.py:378)."""

    @staticmethod
    def forward(ctx, h, w, b, x, thr, with_mism):
        sumsq, mism, dh, dw, db = recon_fwdbwd(h, w, b, x, thr, with_mism)
        ctx.save_for_backward(dh, dw, db)
        ctx.dtypes = (h.dtype, w.dtype, b.dtype)
        ctx.mark_non_differentiable(mism)
        return sumsq, mism

    @staticmethod
    def backward(ctx, g_sumsq, g_mism):
        dh, dw, db = ctx.saved_tensors
        h_dt, w_dt, b_dt = ctx.dtypes
        if g_sumsq is None:
            return None, None, None, None, None, None
        ga = g_sumsq.float()
        # scaled in place: the stash is used once
        return (dh.mul_(ga[:, None, None]).to(h_dt),
                dw.mul_(ga[:, None, None]).to(w_dt),
                db.mul_(ga[:, None]).to(b_dt), None, None, None)
