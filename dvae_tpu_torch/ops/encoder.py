"""Fused input dropout + encoder input layer fc1, forward and weight
gradient, without materialising the dropped (A, B, D) input.

Counterpart of dvae_tpu/ops/encoder_pallas.py.  Per arm

    y1_a  = (x ⊙ mask_a / keep) @ W1_a + b1_a                (pre-ReLU)
    dW1_a = (x ⊙ mask_a / keep)ᵀ @ g_a,   db1_a = Σ_rows g_a

x is (B, D), shared by every arm, or (A, B, D) per arm.  There is no dx:
x is input data (encoder_pallas.py:254).  The hand-written CUDA kernels
of ``csrc/encoder_fc1.cu`` (its source note states their bound and
design) carry both directions:

  * ``encoder_fwd`` — kernel #4 (``_fwd_kernel``, encoder_pallas.py:81),
    on the tensor cores (bf16, or 3xTF32 for f32 operands), counted by
    ``encoder_fwd.launches``;
  * ``encoder_bwd`` — kernel #5 (``_bwd_kernel``, encoder_pallas.py:137),
    on the tensor cores too (the dropped x enters transposed: the
    contraction runs over the rows), counted by ``encoder_bwd.launches``.

Without an explicit ``mask`` the keep-mask is drawn inside the kernels by a
counter-based Philox4x32-10 keyed by ``seed`` and counted by
(column/4, row, arm), so the backward redraws the forward's mask whatever
its tiling.  ``philox_keep_mask`` is the same generator in numpy — the
plain version of the in-kernel draw — and ``kernel_keep_mask`` asks the
card for the mask its device function draws (a check, not a training
path).  ``dropout_mask_host`` draws a mask from a ``torch.Generator`` for
the plain path, as the JAX package draws one on the host off the TPU.

On CPU tensors the wrappers run their plain versions; on CUDA tensors they
launch their kernel or raise.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import (check_kernel_operands, on_cpu,
                                         philox4x32_10)

_MODE_IDENTITY, _MODE_MASK, _MODE_PHILOX = 0, 1, 2
_PHILOX_KEY1 = 0x5EED0001

_FWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
_BWD_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 2
                 + [ctypes.c_int, ctypes.c_uint, ctypes.c_uint, ctypes.c_float]
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3)


def _lib() -> ctypes.CDLL:
    lib = _build.load("encoder_fc1")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.encoder_fwd_f32, lib.encoder_fwd_bf16):
            fn.argtypes = _FWD_ARGTYPES
            fn.restype = ctypes.c_int
        for fn in (lib.encoder_bwd_f32, lib.encoder_bwd_bf16):
            fn.argtypes = _BWD_ARGTYPES
            fn.restype = ctypes.c_int
        lib.encoder_mask_u8.argtypes = ([ctypes.c_uint] * 2
                                        + [ctypes.c_int] * 3
                                        + [ctypes.c_void_p] * 2)
        lib.encoder_mask_u8.restype = ctypes.c_int
        lib._dvae_bound = True
    return lib


def keep_threshold(rate: float) -> int:
    """The kernels' keep test: 31 raw bits < this (encoder_pallas.py:72-73)."""
    return min(int((1.0 - rate) * (1 << 31)), (1 << 31) - 1)


# ---------------------------------------------------------------------------
# Masks
# ---------------------------------------------------------------------------

def philox_keep_mask(seed: int, shape, rate: float) -> np.ndarray:
    """The keep-mask the kernels draw in-kernel for ``seed``, as a bool
    (A, B, D) numpy array: the plain version of the device function."""
    A, B, D = shape
    n4 = -(-D // 4)
    arm, row, col4 = np.meshgrid(np.arange(A, dtype=np.uint64),
                                 np.arange(B, dtype=np.uint64),
                                 np.arange(n4, dtype=np.uint64), indexing="ij")
    words = philox4x32_10(col4, row, arm, np.zeros_like(col4),
                          int(seed) & 0xFFFFFFFF, _PHILOX_KEY1)
    thr = np.uint64(keep_threshold(rate))
    keep = np.stack([(w & np.uint64(0x7FFFFFFF)) < thr for w in words], -1)
    return keep.reshape(A, B, 4 * n4)[:, :, :D]


def kernel_keep_mask(seed: int, shape, rate: float, device) -> torch.Tensor:
    """Check entry: the (A, B, D) uint8 keep-mask the kernels draw on
    ``device`` (CUDA) for ``seed``, materialised by the same device
    function.  For small shapes; training never calls it."""
    A, B, D = shape
    out = torch.empty((A, B, D), device=device, dtype=torch.uint8)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().encoder_mask_u8(int(seed) & 0xFFFFFFFF,
                                     keep_threshold(rate), A, B, D,
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encoder_mask kernel launch failed: CUDA error {err}")
    return out


def dropout_mask_host(generator: Optional[torch.Generator], shape,
                      rate: float) -> torch.Tensor:
    """A bool keep-mask with P(keep) = 1 − rate drawn from ``generator``
    on its own device (the CPU without one): the plain path's mask."""
    dev = generator.device if generator is not None else "cpu"
    u = torch.rand(shape, generator=generator, device=dev)
    return u < (1.0 - rate)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _dropped(x, rate: float, mask, A: int) -> torch.Tensor:
    """(A, B, D) x ⊙ mask / keep in x's dtype (the scale rounded to it)."""
    if x.dim() == 2:
        x = x.expand(A, *x.shape)
    keep = 1.0 - rate
    if mask is None:
        if keep >= 1.0:
            return x
        raise ValueError("the plain version needs an explicit mask when "
                         "rate > 0")
    scale = torch.tensor(1.0 / keep, dtype=x.dtype)
    return torch.where(mask.bool(), x * scale, torch.zeros((), dtype=x.dtype))


def dropout_fc1_reference(x, w, b, rate: float, mask):
    """Plain version of kernel #4: materialises the dropped views."""
    xd = _dropped(x, rate, mask, w.shape[0])
    y = torch.baddbmm(b.float()[:, None, :], xd.float(), w.float())
    return y.to(x.dtype)


def dropout_fc1_grad_reference(x, g, rate: float, mask):
    """Plain version of kernel #5: (dW1 (A,D,F), db1 (A,F)) in f32; g is
    rounded to x's dtype for the product, db sums g in f32."""
    xd = _dropped(x, rate, mask, g.shape[0])
    dw = torch.bmm(xd.float().transpose(1, 2), g.to(x.dtype).float())
    return dw, g.float().sum(dim=1)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_mask(mask, A: int, B: int, D: int) -> None:
    if mask is not None and tuple(mask.shape) != (A, B, D):
        raise ValueError(f"mask {tuple(mask.shape)} is not ({A}, {B}, {D})")


def _mask_args(mask, rate: float):
    """(mode, mask tensor) for a launch; an explicit mask wins at rate 0."""
    if mask is not None:
        return _MODE_MASK, mask.to(torch.uint8).contiguous()
    if rate <= 0.0:
        return _MODE_IDENTITY, None
    return _MODE_PHILOX, None


def _check_x(x, A: int, D: int) -> int:
    if x.dim() == 2 and x.shape[1] == D:
        return x.shape[0]
    if x.dim() == 3 and x.shape[0] == A and x.shape[2] == D:
        return x.shape[1]
    raise ValueError(f"x {tuple(x.shape)} is neither (B, {D}) nor ({A}, B, {D})")


def encoder_fwd(seed: int, x, w, b, rate: float,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(A, B, F) pre-ReLU fc1 output in x's dtype.  Kernel #4 on CUDA
    tensors; on CPU tensors the plain version, which draws the kernel's
    own Philox mask when none is given."""
    if w.dim() != 3 or b.dim() != 2:
        raise ValueError("expected w (A,D,F), b (A,F)")
    A, D, F = w.shape
    B = _check_x(x, A, D)
    if tuple(b.shape) != (A, F):
        raise ValueError(f"b {tuple(b.shape)} is not ({A}, {F})")
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1)")
    _check_mask(mask, A, B, D)
    if on_cpu(x, w, b):
        if mask is None and rate > 0.0:
            mask = torch.from_numpy(philox_keep_mask(seed, (A, B, D), rate))
        return dropout_fc1_reference(x, w, b, rate, mask)
    dtype = check_kernel_operands(("x", "w", "b"), (x, w, b))
    mode, m = _mask_args(mask, rate)
    y = torch.empty((A, B, F), device=x.device, dtype=dtype)
    lib = _lib()
    fn = lib.encoder_fwd_f32 if dtype == torch.float32 else lib.encoder_fwd_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), 0 if x.dim() == 2 else B * D, w.data_ptr(),
                 b.data_ptr(), 0 if m is None else m.data_ptr(), mode,
                 int(seed) & 0xFFFFFFFF, keep_threshold(rate),
                 1.0 / (1.0 - rate), A, B, D, F, y.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"encoder_fwd kernel launch failed: CUDA error {err}")
    encoder_fwd.launches += 1
    return y


encoder_fwd.launches = 0


def encoder_bwd(seed: int, x, g, rate: float,
                mask: Optional[torch.Tensor] = None):
    """(dW1 (A,D,F), db1 (A,F)) in f32 for the cotangent g (A,B,F) of
    ``encoder_fwd``'s output, with the same mask redrawn.  Kernel #5 on
    CUDA tensors, the plain version on CPU tensors."""
    if g.dim() != 3:
        raise ValueError("expected g (A,B,F)")
    A, _, F = g.shape
    D = x.shape[-1]
    B = _check_x(x, A, D)
    if g.shape[1] != B:
        raise ValueError(f"g {tuple(g.shape)} does not match x {tuple(x.shape)}")
    _check_mask(mask, A, B, D)
    if on_cpu(x, g):
        if mask is None and rate > 0.0:
            mask = torch.from_numpy(philox_keep_mask(seed, (A, B, D), rate))
        return dropout_fc1_grad_reference(x, g, rate, mask)
    g = g.to(x.dtype).contiguous()
    check_kernel_operands(("x", "g"), (x, g))
    mode, m = _mask_args(mask, rate)
    dw = torch.empty((A, D, F), device=x.device, dtype=torch.float32)
    db = torch.empty((A, F), device=x.device, dtype=torch.float32)
    lib = _lib()
    fn = (lib.encoder_bwd_f32 if x.dtype == torch.float32
          else lib.encoder_bwd_bf16)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), 0 if x.dim() == 2 else B * D, g.data_ptr(),
                 0 if m is None else m.data_ptr(), mode,
                 int(seed) & 0xFFFFFFFF, keep_threshold(rate),
                 1.0 / (1.0 - rate), A, B, D, F, dw.data_ptr(), db.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"encoder_bwd kernel launch failed: CUDA error {err}")
    encoder_bwd.launches += 1
    return dw, db


encoder_bwd.launches = 0


class _FusedDropoutFC1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seed, x, w, b, rate, mask):
        ctx.seed, ctx.rate = seed, rate
        ctx.dtypes = (w.dtype, b.dtype)
        ctx.save_for_backward(x, mask)
        return encoder_fwd(seed, x, w, b, rate, mask)

    @staticmethod
    def backward(ctx, g):
        x, mask = ctx.saved_tensors
        dw, db = encoder_bwd(ctx.seed, x, g, ctx.rate, mask)
        w_dt, b_dt = ctx.dtypes
        return None, None, dw.to(w_dt), db.to(b_dt), None, None


def fused_dropout_fc1(seed: int, x, w, b, rate: float,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Pre-activation fc1 output of all arms with fused input dropout.

    Args:
      seed: the in-kernel mask's Philox key (ignored with ``mask``).
      x: (B, D) shared batch or (A, B, D) per-arm views.
      w: (A, D, F) fc1 weights.  b: (A, F) fc1 bias.
      rate: dropout probability (reference x_drop).
      mask: optional explicit {0,1} keep-mask (A, B, D), bool or uint8.

    Returns (A, B, F) pre-ReLU activations in x.dtype; differentiable in
    w and b (no gradient for x).
    """
    return _FusedDropoutFC1.apply(int(seed), x, w, b, float(rate), mask)
