"""Fused Gumbel-softmax sample of a categorical posterior: optional
tau-sharpen → Gumbel noise → softmax → optional straight-through one-hot,
forward and backward, in one pass over the (…, C) tensor.

Counterpart of dvae_tpu/ops/gumbel_pallas.py.  The hand-written CUDA
kernels of ``csrc/gumbel.cu`` (its source note states their bound and
design) carry both directions:

  * ``gumbel_fwd`` — kernel #9 (``_gumbel_kernel`` :52 and
    ``_gumbel_kernel_with_u`` :67 of gumbel_pallas.py), counted by
    ``gumbel_fwd.launches``; its tau variant through
    ``sharpen_gumbel_fused``, counted by ``sharpen_gumbel_fused.launches``;
  * ``gumbel_bwd`` — kernel #10 (``_soft_bwd_kernel`` :128), counted by
    ``gumbel_bwd.launches``.

Both take any number of categories C, as the TPU kernels do;
``gumbel_plan`` is the twin of the forward kernel's row plan.

    g = −log(−log(u + eps) + eps)
    y = softmax((log(phi + eps) + g) / T)
    dphi = (dy − Σ_C dy·y)·y / T / (phi + eps)
    dT   = −Σ (dy − Σ_C dy·y)·y·log y / T       (y = 0 contributes 0)

The noise is a constant with respect to phi.  With ``hard`` the output is
the one-hot of argmax y and the gradient goes to the soft y unchanged
(straight-through, gumbel_pallas.py:162-197).  ``T`` may be a Python
number or a one-element tensor; a tensor on the card is read by the kernel
where it lies, so no launch waits for the host.

Without an explicit ``u`` the uniforms are drawn inside the kernel by a
counter-based Philox4x32-10 keyed by ``seed`` and counted by (column/4,
row): 23 random bits times 2⁻²³, U[0, 1) as the TPU kernel builds them —
the same distribution, not its bitstream.  ``philox_uniform`` is the same
generator in numpy, so the plain version sees the kernel's numbers, and
``kernel_uniform`` asks the card for the uniforms its device function
draws (a check, not a training path).

On CPU tensors the wrappers run their plain versions; on CUDA tensors they
launch their kernel or raise.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import on_cpu, philox4x32_10

_PHILOX_KEY1 = 0x5EED0002
# csrc/gumbel.cu's forward plan: warps a block, quads (4 columns) a lane
# held in registers, quads a lane a chunk past that, blocks an SM
GUMBEL_WARPS, GUMBEL_MAX_QUADS, GUMBEL_WIDE_QUADS = 8, 8, 4
GUMBEL_BLOCKS_PER_SM = 8


def _lib() -> ctypes.CDLL:
    lib = _build.load("gumbel")
    if not getattr(lib, "_dvae_bound", False):
        vp, ll, f, i, u = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float,
                           ctypes.c_int, ctypes.c_uint)
        lib.gumbel_fwd_f32.argtypes = [vp, vp, u, f, vp, f, i, f, i, ll, i,
                                       vp, vp, vp]
        lib.gumbel_bwd_f32.argtypes = [vp, vp, vp, f, vp, f, ll, i, vp, vp,
                                       vp, vp]
        lib.gumbel_uniform_f32.argtypes = [u, ll, i, vp, vp]
        lib.gumbel_fwd_plan.argtypes = [ll, i, i,
                                        ctypes.POINTER(ctypes.c_longlong)]
        for fn in (lib.gumbel_fwd_f32, lib.gumbel_bwd_f32,
                   lib.gumbel_uniform_f32, lib.gumbel_fwd_plan):
            fn.restype = i
        lib.gumbel_bwd_partials.argtypes = [ll]
        lib.gumbel_bwd_partials.restype = ll
        lib._dvae_bound = True
    return lib


def gumbel_plan(N: int, C: int, sms: int = 132) -> dict:
    """The row plan kernel #9 makes for an (N, C) input on a card of
    ``sms`` SMs (``gumbel_fwd_plan`` of the library is the same rule):
    ``lanes`` lanes share a row, lane ``sub`` holding quads sub, sub +
    lanes, ... (``quads`` of them; a quad is 4 neighbouring columns): the
    fewest padded quads a row, of equals the most lanes.  A row wider than
    32 × GUMBEL_MAX_QUADS quads is walked by one warp in ``chunks`` of 32 ×
    GUMBEL_WIDE_QUADS quads.  ``rows`` rows a group, ``groups`` groups, a
    grid of ``grid`` blocks striding over them, each the same number of
    steps."""
    q = -(-C // 4)
    lanes = quads = 0
    for cand in (1, 2, 4, 8, 16, 32):
        n = -(-q // cand)
        if n <= GUMBEL_MAX_QUADS and (not lanes or cand * n <= lanes * quads):
            lanes, quads = cand, n
    chunks = 1
    if not lanes:
        lanes, quads = 32, GUMBEL_WIDE_QUADS
        chunks = -(-q // (32 * GUMBEL_WIDE_QUADS))
    rows = GUMBEL_WARPS * 32 // lanes
    groups = -(-N // rows)
    steps = -(-groups // (max(sms, 1) * GUMBEL_BLOCKS_PER_SM))
    return {"lanes": lanes, "quads": quads, "chunks": chunks, "rows": rows,
            "groups": groups, "grid": -(-groups // steps)}


# ---------------------------------------------------------------------------
# Uniforms
# ---------------------------------------------------------------------------

def philox_uniform(seed: int, shape) -> np.ndarray:
    """The U[0, 1) numbers the forward kernel draws for ``seed`` on a
    (…, C) tensor, as an f32 numpy array: the plain version of the device
    function.  Each is a multiple of 2⁻²³."""
    C = int(shape[-1])
    n = int(np.prod(shape[:-1], dtype=np.int64))
    n4 = -(-C // 4)
    row, col4 = np.meshgrid(np.arange(n, dtype=np.uint64),
                            np.arange(n4, dtype=np.uint64), indexing="ij")
    zero = np.zeros_like(row)
    words = philox4x32_10(col4, row, zero, zero, int(seed) & 0xFFFFFFFF,
                          _PHILOX_KEY1)
    u = np.stack([(w >> np.uint64(9)).astype(np.float32) for w in words], -1)
    u *= np.float32(2.0 ** -23)
    return u.reshape(n, 4 * n4)[:, :C].reshape(tuple(shape))


def kernel_uniform(seed: int, shape, device) -> torch.Tensor:
    """Check entry: the uniforms the forward kernel draws on ``device``
    (CUDA) for ``seed``, materialised by the same device function.
    Training never calls it."""
    out = torch.empty(tuple(shape), device=device, dtype=torch.float32)
    C = out.shape[-1]
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gumbel_uniform_f32(int(seed) & 0xFFFFFFFF,
                                        out.numel() // C, C, out.data_ptr(),
                                        stream)
    if err != 0:
        raise RuntimeError(f"gumbel_uniform kernel launch failed: CUDA error "
                           f"{err}")
    return out


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _plain_fwd(phi, u, temp, eps: float, tau, hard: bool):
    """(soft y, one-hot of its argmax or None), step by step."""
    if tau is not None:
        phi = torch.softmax(phi / tau, dim=-1)
    g = -torch.log(-torch.log(u + eps) + eps)
    y = torch.softmax((torch.log(phi + eps) + g) / temp, dim=-1)
    if not hard:
        return y, None
    idx = torch.argmax(y, dim=-1)
    return y, torch.nn.functional.one_hot(idx, y.shape[-1]).to(y.dtype)


def gumbel_softmax_plain(phi, u, temp=1.0, eps: float = 1e-8, tau=None,
                         hard: bool = False) -> torch.Tensor:
    """Plain version of kernel #9 on explicit uniforms ``u``: the sample,
    the one-hot of its argmax under ``hard``; ``tau`` sharpens first."""
    y, y_hard = _plain_fwd(phi, u, temp, eps, tau, hard)
    return y_hard if hard else y


def gumbel_softmax_bwd_plain(y, phi, dy, temp, eps: float = 1e-8):
    """Plain version of kernel #10: (dphi like phi, dtemp scalar) for the
    cotangent ``dy`` of the soft sample ``y``."""
    s = (dy * y).sum(dim=-1, keepdim=True)
    dz = (dy - s) * y
    dphi = dz / temp / (phi + eps)
    logy = torch.where(y > 0, torch.log(torch.clamp(y, min=1e-38)),
                       torch.zeros_like(y))
    return dphi, -(dz * logy).sum() / temp


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_rows(names, tensors) -> tuple:
    """(N, C) of same-shaped contiguous f32 CUDA operands the kernels take."""
    shape = tensors[0].shape
    for name, t in zip(names, tensors):
        if t.dtype != torch.float32:
            raise ValueError(f"operand {name} is {t.dtype}; the Gumbel "
                             "kernels take float32")
        if t.shape != shape:
            raise ValueError(f"operand {name} {tuple(t.shape)} does not "
                             f"match {names[0]} {tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"operand {name} is not contiguous")
    if len(shape) < 1 or tensors[0].numel() == 0:
        raise ValueError(f"expected a non-empty (…, C) tensor, got "
                         f"{tuple(shape)}")
    return tensors[0].numel() // shape[-1], shape[-1]


def _temp_args(temp, device):
    """(launch value, device scalar or None): a one-element tensor on the
    card is read there; anything else becomes the launch argument."""
    if isinstance(temp, torch.Tensor):
        if temp.numel() != 1:
            raise ValueError("temp must hold one element")
        if temp.device.type == "cuda":
            if temp.device != device:
                raise ValueError(f"temp on {temp.device}, operands on "
                                 f"{device}")
            return 0.0, temp.detach().to(torch.float32).reshape(1)
    return float(temp), None


def _launch_fwd(seed, phi, u, temp, eps, tau, hard, keep_soft):
    """(soft y or None, one-hot or None) from one launch of kernel #9."""
    ops = (phi,) if u is None else (phi, u)
    n, C = _check_rows(("phi", "u")[:len(ops)], ops)
    t_val, t_dev = _temp_args(temp, phi.device)
    y_soft = torch.empty_like(phi) if keep_soft or not hard else None
    y_hard = torch.empty_like(phi) if hard else None
    with torch.cuda.device(phi.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib().gumbel_fwd_f32(
            phi.data_ptr(), 0 if u is None else u.data_ptr(),
            int(seed) & 0xFFFFFFFF, t_val,
            0 if t_dev is None else t_dev.data_ptr(), float(eps),
            int(tau is not None), 0.0 if tau is None else float(tau),
            int(hard), n, C, 0 if y_soft is None else y_soft.data_ptr(),
            0 if y_hard is None else y_hard.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gumbel_fwd kernel launch failed: CUDA error {err}")
    return y_soft, y_hard


def gumbel_fwd(seed: int, phi, u=None, temp=1.0, eps: float = 1e-8,
               hard: bool = False, keep_soft: bool = True):
    """(soft sample or None, one-hot or None) of ``phi`` (…, C).  Kernel #9
    on CUDA tensors; on CPU tensors the plain version, on the kernel's own
    Philox uniforms when ``u`` is None.  Under ``hard`` the soft sample is
    returned as well when ``keep_soft`` (the backward's residual)."""
    if on_cpu(*((phi,) if u is None else (phi, u))):
        if u is None:
            u = torch.from_numpy(philox_uniform(seed, phi.shape))
        y, y_hard = _plain_fwd(phi, u, temp, eps, None, hard)
        return (y if keep_soft or not hard else None), y_hard
    out = _launch_fwd(seed, phi, u, temp, eps, None, hard, keep_soft)
    gumbel_fwd.launches += 1
    return out


gumbel_fwd.launches = 0


def gumbel_bwd(y, phi, dy, temp, eps: float = 1e-8, want_dtemp: bool = True):
    """(dphi, dtemp or None) for the cotangent ``dy`` of the soft sample.
    Kernel #10 on CUDA tensors, the plain version on CPU tensors.  The
    temperature gradient costs a second small launch; it is computed
    whenever it is asked for."""
    if on_cpu(y, phi, dy):
        dphi, dtemp = gumbel_softmax_bwd_plain(y, phi, dy, temp, eps)
        return dphi, (dtemp.reshape(()) if want_dtemp else None)
    n, C = _check_rows(("y", "phi", "dy"), (y, phi, dy))
    t_val, t_dev = _temp_args(temp, y.device)
    dphi = torch.empty_like(phi)
    lib = _lib()
    part = dtemp = None
    if want_dtemp:
        part = torch.empty(lib.gumbel_bwd_partials(n), device=y.device,
                           dtype=torch.float32)
        dtemp = torch.empty(1, device=y.device, dtype=torch.float32)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.gumbel_bwd_f32(
            y.data_ptr(), phi.data_ptr(), dy.data_ptr(), t_val,
            0 if t_dev is None else t_dev.data_ptr(), float(eps), n, C,
            dphi.data_ptr(), 0 if part is None else part.data_ptr(),
            0 if dtemp is None else dtemp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"gumbel_bwd kernel launch failed: CUDA error {err}")
    gumbel_bwd.launches += 1
    return dphi, (None if dtemp is None else dtemp.reshape(()))


gumbel_bwd.launches = 0


class _GumbelSoftmax(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seed, phi, u, temp, eps, hard):
        y, y_hard = gumbel_fwd(seed, phi, u, temp, eps, hard)
        ctx.eps = eps
        ctx.temp = None if isinstance(temp, torch.Tensor) else temp
        saved = (y, phi) + ((temp,) if ctx.temp is None else ())
        ctx.save_for_backward(*saved)
        return y_hard if hard else y

    @staticmethod
    def backward(ctx, dy):
        y, phi, *rest = ctx.saved_tensors
        temp = rest[0] if rest else ctx.temp
        want_dtemp = bool(rest) and ctx.needs_input_grad[3]
        dphi, dtemp = gumbel_bwd(y, phi, dy.contiguous(), temp, ctx.eps,
                                 want_dtemp)
        if dtemp is not None:
            dtemp = dtemp.to(temp.dtype).reshape(temp.shape)
        return None, dphi, None, dtemp, None, None


def gumbel_softmax_fused(seed: int, phi, u: Optional[torch.Tensor] = None,
                         temp=1.0, eps: float = 1e-8,
                         hard: bool = False) -> torch.Tensor:
    """Fused Gumbel-softmax sample of ``phi`` (probabilities, last axis C).

    Args:
      seed: the in-kernel uniforms' Philox key (ignored with ``u``).
      phi: (…, C) f32 probabilities.
      u: optional explicit U[0, 1) noise of phi's shape.
      temp: temperature, a Python number or a one-element tensor.
      hard: return the one-hot of the argmax; the gradient is the soft
        sample's (straight-through).

    Differentiable in ``phi`` and, where it is a tensor, ``temp``.
    """
    needs_grad = torch.is_grad_enabled() and (
        phi.requires_grad
        or (isinstance(temp, torch.Tensor) and temp.requires_grad))
    if needs_grad:
        return _GumbelSoftmax.apply(int(seed), phi, u, temp, float(eps),
                                    bool(hard))
    y, y_hard = gumbel_fwd(seed, phi, u, temp, eps, hard, keep_soft=False)
    return y_hard if hard else y


def sharpen_gumbel_fused(seed: int, logits, tau: float, temp=1.0,
                         eps: float = 1e-8, hard: bool = False,
                         u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """softmax(logits / tau) → Gumbel sample in one pass: the tau variant of
    kernel #9 (``sharpen_gumbel_pallas``, gumbel_pallas.py:203).  Forward
    only: training samples the sharpened posterior through
    ``gumbel_softmax_fused``."""
    if not (math.isfinite(tau) and tau > 0):
        raise ValueError(f"tau must be a positive number, got {tau}")
    if on_cpu(*((logits,) if u is None else (logits, u))):
        if u is None:
            u = torch.from_numpy(philox_uniform(seed, logits.shape))
        return gumbel_softmax_plain(logits, u, temp, eps, tau, hard)
    y, y_hard = _launch_fwd(seed, logits, u, temp, eps, tau, hard, False)
    sharpen_gumbel_fused.launches += 1
    return y_hard if hard else y


sharpen_gumbel_fused.launches = 0
