"""The whole MSE decoder as one fused op: trunk fc6..fc10 (Linear + ReLU),
output layer fc11 + ReLU, MSE and binarized-mismatch sums, forward and
backward, without materialising the (A, B, D) reconstruction, its
cotangent, or any trunk activation for autograd.

Counterpart of dvae_tpu/ops/decoder_pallas.py (opt-in there and here:
``cfg.fused_decoder``).  Two hand-written CUDA kernels of one source,
``csrc/decoder.cu`` (its note states the bound and the design: the trunk
forward and backward as tensor-core tile passes, the output layer and
the loss through kernel #2's row and column passes of
``csrc/recon_passes.cuh``), carry it:

  * the value-only forward that eval runs (``_fwd_kernel``,
    decoder_pallas.py:115); launched by ``fused_decoder_mse`` when no
    gradient is asked for, counted by ``fused_decoder_mse.launches``;
  * the training forward with the whole backward at cotangent 1 in the same
    call (``_fwdbwd_kernel``, decoder_pallas.py:211); launched by
    ``decoder_fwdbwd``, counted by ``decoder_fwdbwd.launches``.

    h_1 = relu(z W_6 + b_6) ... h_5 = relu(h_4 W_10 + b_10)
    r   = relu(h_5 W_11 + b_11)
    sumsq_a = sum (r - x)^2,   mism_a = #{binarize(r) != binarize(x)}

``z = [c_smp, dropout(s_smp)]`` (A, B, C+S) is the decoder's input
(reference mmidas/nn_model.py:278).  The widths are read off the weights:
fc6 (C+S) -> L, fc7 L -> F, fc8..fc10 F -> F, fc11 F -> D.  Activations are
rounded to the operand dtype after each ReLU and every gated cotangent
before its products, products accumulate in f32, the bias gradients sum
the unrounded values, ``dz`` leaves in the operand dtype
(decoder_pallas.py:104-107, :250-266).

Under autograd ``fused_decoder_mse`` runs the fused forward+backward once
and stashes the unscaled gradients; its backward scales them by the
per-arm cotangent of ``sumsq`` (decoder_pallas.py:340-362).  On CPU tensors
every wrapper runs its plain version; on CUDA tensors it launches its
kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import check_kernel_operands, on_cpu

N_TRUNK = 5  # fc6..fc10

_NAMES = ("z", "w6", "b6", "w7", "b7", "w8", "b8", "w9", "b9", "w10", "b10",
          "w11", "b11", "x")
_VOID, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FWD_ARGTYPES = [_VOID, ctypes.POINTER(_VOID), ctypes.POINTER(_INT), _VOID,
                 _LL, _INT, _INT, _INT, ctypes.c_float, _INT] + [_VOID] * 6
_FWDBWD_ARGTYPES = _FWD_ARGTYPES[:-3] + [_VOID] * 9


def _lib() -> ctypes.CDLL:
    lib = _build.load("decoder")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.decoder_fwd_f32, lib.decoder_fwd_bf16):
            fn.argtypes = _FWD_ARGTYPES
            fn.restype = _INT
        for fn in (lib.decoder_fwdbwd_f32, lib.decoder_fwdbwd_bf16):
            fn.argtypes = _FWDBWD_ARGTYPES
            fn.restype = _INT
        lib.decoder_partials_per_arm.argtypes = [_INT] * 3
        lib.decoder_partials_per_arm.restype = _LL
        lib.decoder_grad_len.argtypes = [ctypes.POINTER(_INT)]
        lib.decoder_grad_len.restype = _LL
        lib.decoder_quiet_ws_floats.argtypes = [ctypes.POINTER(_INT)] \
            + [_INT] * 3
        lib.decoder_quiet_ws_floats.restype = _LL
        lib.decoder_acts_elems.argtypes = [ctypes.POINTER(_INT)] + [_INT] * 3
        lib.decoder_acts_elems.restype = _LL
        lib.decoder_grad_scratch_floats.argtypes = [ctypes.POINTER(_INT)] \
            + [_INT] * 2
        lib.decoder_grad_scratch_floats.restype = _LL
        lib.decoder_max_f.argtypes = [_INT, _INT]
        lib.decoder_max_f.restype = _INT
        lib._dvae_bound = True
    return lib


def _check_shapes(z, trunk, w11, b11, x):
    """(A, B, widths [Z, out_6..out_10], D) of consistent operands."""
    if z.dim() != 3 or len(trunk) != N_TRUNK:
        raise ValueError("expected z (A,B,Z) and five trunk (w, b) pairs")
    A, B, width = z.shape[0], z.shape[1], z.shape[2]
    widths = [width]
    for i, (w, b) in enumerate(trunk):
        if w.dim() != 3 or tuple(w.shape[:2]) != (A, width):
            raise ValueError(f"fc{6 + i} weight {tuple(w.shape)} does not "
                             f"take ({A}, ., {width}) activations")
        width = w.shape[2]
        if tuple(b.shape) != (A, width):
            raise ValueError(f"fc{6 + i} bias {tuple(b.shape)} is not "
                             f"({A}, {width})")
        widths.append(width)
    if w11.dim() != 3 or tuple(w11.shape[:2]) != (A, width):
        raise ValueError(f"fc11 weight {tuple(w11.shape)} does not take "
                         f"({A}, ., {width}) activations")
    D = w11.shape[2]
    if tuple(b11.shape) != (A, D):
        raise ValueError(f"fc11 bias {tuple(b11.shape)} is not ({A}, {D})")
    if tuple(x.shape) not in ((B, D), (A, B, D)):
        raise ValueError(f"x {tuple(x.shape)} is neither ({B}, {D}) nor "
                         f"({A}, {B}, {D})")
    return A, B, widths, D


def _trunk_forward(z, trunk):
    """[z, h_1, ..., h_5]: f32 products, each activation rounded to z's
    dtype, as the kernels hold them."""
    hs = [z]
    for w, b in trunk:
        y = torch.baddbmm(b.float()[:, None, :], hs[-1].float(), w.float())
        hs.append(torch.relu(y).to(z.dtype))
    return hs


def decoder_mse_reference(z, w6, b6, w7, b7, w8, b8, w9, b9, w10, b10,
                          w11, b11, x, thr: float = 0.1):
    """Plain version of the forward: materialises every activation and the
    reconstruction (decoder_pallas.py:368).  Differentiable by autograd."""
    from dvae_tpu_torch.ops.recon import recon_mse_reference
    trunk = [(w6, b6), (w7, b7), (w8, b8), (w9, b9), (w10, b10)]
    return recon_mse_reference(_trunk_forward(z, trunk)[-1], w11, b11, x, thr)


def _trunk_backward(hs, trunk, g):
    """Plain trunk backward from g = dh_5 (f32): (dz in the dtype of hs[0],
    [(dW_i, db_i)] * 5 in f32) on the activations hs = [z, h_1, ..., h_5].
    Each gated cotangent is rounded to z's dtype for its two products, db
    sums it unrounded (decoder_pallas.py:255-266)."""
    dtrunk = []
    for i in range(N_TRUNK - 1, -1, -1):
        g_f = torch.where(hs[i + 1].float() > 0, g, torch.zeros_like(g))
        g16 = g_f.to(hs[0].dtype).float()
        dtrunk.append((torch.bmm(hs[i].float().transpose(1, 2), g16),
                       g_f.sum(dim=1)))
        g = torch.bmm(g16, trunk[i][0].float().transpose(1, 2))
    return g.to(hs[0].dtype), dtrunk[::-1]


def decoder_fwdbwd_reference(z, trunk, w11, b11, x, thr: float = 0.1):
    """Plain version of the training kernel, what ``_fwdbwd_call``
    (decoder_pallas.py:269) returns: (sumsq, mism, dz, [(dW_i, db_i)] * 5,
    dW_11, db_11), the gradients of the sum of sumsq unscaled; dW and db in
    f32, dz in z's dtype.  Rounds where the kernel rounds, in the kernel's
    decomposition: trunk forward, the plain version of kernel #2 on h_5,
    trunk backward."""
    from dvae_tpu_torch.ops.recon import recon_fwdbwd_reference
    hs = _trunk_forward(z, trunk)
    sumsq, mism, g, dw11, db11 = recon_fwdbwd_reference(hs[-1], w11, b11, x,
                                                        thr)
    dz, dtrunk = _trunk_backward(hs, trunk, g)
    return sumsq, mism, dz, dtrunk, dw11, db11


def _kernel_plan(lib, z, trunk, w11, b11, x, train: bool):
    """Argument checks every launch makes; returns (dtype, A, B, widths, D,
    the C arrays of weight pointers and widths, the loss partials an arm)."""
    A, B, widths, D = _check_shapes(z, trunk, w11, b11, x)
    flat = [z] + [t for pair in trunk for t in pair] + [w11, b11, x]
    dtype = check_kernel_operands(_NAMES, flat)
    if A == 0 or B == 0 or D == 0 or 0 in widths:
        raise ValueError(f"empty operand: A={A}, B={B}, D={D}, "
                         f"widths={widths}")
    c_widths = (_INT * (N_TRUNK + 1))(*widths)
    limit = int(lib.decoder_max_f(int(dtype == torch.bfloat16), int(train)))
    if widths[-1] > limit:
        what = ("the column pass's resident (F, 64) tile of W11" if train
                else "the row pass's resident (64, F) tile of h_5")
        raise ValueError(f"F={widths[-1]} exceeds {limit}, the widest last "
                         f"trunk layer for which {what} fits a block's "
                         f"232,448 bytes of shared memory in {dtype}")
    n_part = int(lib.decoder_partials_per_arm(A, B, D))
    if n_part < 0:
        raise ValueError(f"shape A={A}, B={B}, D={D} exceeds one launch's "
                         "grid")
    ptrs = (_VOID * (2 * N_TRUNK + 2))(*(t.data_ptr() for t in flat[1:-1]))
    return dtype, A, B, widths, D, ptrs, c_widths, n_part


def _quiet_workspace(lib, c_widths, A, B, D, dtype, dev):
    """f32 scratch for the copies of z and the weights with every NaN
    quiet, which the kernel's 3xTF32 split keeps and its passes read
    (csrc/recon_passes.cuh ``quiet_copy``); empty in bf16."""
    n = int(lib.decoder_quiet_ws_floats(c_widths, A, B, D)) \
        if dtype == torch.float32 else 0
    return torch.empty(n, device=dev, dtype=torch.float32)


def _decoder_value(z, trunk, w11, b11, x, thr, with_mism):
    """Value-only forward: kernel #12 on CUDA, the plain version on CPU."""
    if on_cpu(z, *(t for pair in trunk for t in pair), w11, b11, x):
        _check_shapes(z, trunk, w11, b11, x)
        flat = [t for pair in trunk for t in pair]
        sumsq, mism = decoder_mse_reference(z, *flat, w11, b11, x, thr)
        return sumsq, mism if with_mism else torch.zeros_like(mism)
    lib = _lib()
    dtype, A, B, widths, D, ptrs, c_widths, n_part = _kernel_plan(
        lib, z, trunk, w11, b11, x, train=False)
    dev = z.device
    part_sum = torch.empty(A * n_part, device=dev, dtype=torch.float32)
    part_mism = torch.empty(A * n_part, device=dev, dtype=torch.int32)
    out = torch.empty((A, 2), device=dev, dtype=torch.float32)
    # scratch: h_5, or with the wide trunk every activation
    acts = torch.empty(int(lib.decoder_acts_elems(c_widths, A, B, 0)),
                       device=dev, dtype=dtype)
    quiet_ws = _quiet_workspace(lib, c_widths, A, B, D, dtype, dev)
    fn = lib.decoder_fwd_f32 if dtype == torch.float32 else lib.decoder_fwd_bf16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), ptrs, c_widths, x.data_ptr(),
                 0 if x.dim() == 2 else B * D, A, B, D, float(thr),
                 int(bool(with_mism)), part_sum.data_ptr(),
                 part_mism.data_ptr(), out.data_ptr(), acts.data_ptr(),
                 quiet_ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decoder_fwd kernel launch failed: CUDA error {err}")
    fused_decoder_mse.launches += 1
    return out[:, 0], out[:, 1]


def decoder_fwdbwd(z, trunk, w11, b11, x, thr: float = 0.1,
                   with_mism: bool = True):
    """Per-arm (sumsq, mism) and the unscaled gradients of the sum of sumsq
    in one call: (sumsq, mism, dz (A,B,Z) in z's dtype, [(dW_i, db_i)] * 5,
    dW_11 (A,F,D), db_11 (A,D), f32).  Kernel #13 on CUDA tensors,
    ``decoder_fwdbwd_reference`` on CPU tensors.  ``trunk`` is the list of
    the five (w, b) pairs fc6..fc10."""
    if on_cpu(z, *(t for pair in trunk for t in pair), w11, b11, x):
        _check_shapes(z, trunk, w11, b11, x)
        sumsq, mism, *grads = decoder_fwdbwd_reference(z, trunk, w11, b11, x,
                                                       thr)
        return (sumsq, mism if with_mism else torch.zeros_like(mism), *grads)
    return _fwdbwd_launch(z, trunk, w11, b11, x, thr, with_mism)[:6]


def _fwdbwd_launch(z, trunk, w11, b11, x, thr, with_mism):
    """Kernel #13 on CUDA tensors: ``decoder_fwdbwd``'s six results and
    two of the call's workspaces, [h_1, ..., h_5] in z's dtype and dh_5 in
    f32, through which a check can follow the kernel pass by pass."""
    lib = _lib()
    dtype, A, B, widths, D, ptrs, c_widths, n_part = _kernel_plan(
        lib, z, trunk, w11, b11, x, train=True)
    dev = z.device
    F = widths[-1]
    n_grad = int(lib.decoder_grad_len(c_widths))
    f32 = torch.float32
    part_sum = torch.empty(A * n_part, device=dev, dtype=f32)
    part_mism = torch.empty(A * n_part, device=dev, dtype=torch.int32)
    out = torch.empty((A, 2), device=dev, dtype=f32)
    # workspaces: the trunk's activations h_1..h_5 for the output layer's
    # passes and the trunk backward, dh_5, and one trunk-gradient partial
    # vector per row tile (reduced in a fixed order by the last pass) or,
    # with the wide trunk, its two buffers of the cotangent g
    acts = torch.empty(A * B * sum(widths[1:]), device=dev, dtype=dtype)
    dh5 = torch.empty((A, B, F), device=dev, dtype=f32)
    part_grad = torch.empty(int(lib.decoder_grad_scratch_floats(c_widths, A,
                                                                B)),
                            device=dev, dtype=f32)
    dz = torch.empty_like(z)
    flat_grads = torch.empty(A * n_grad, device=dev, dtype=f32)
    dw11 = torch.empty((A, F, D), device=dev, dtype=f32)
    db11 = torch.empty((A, D), device=dev, dtype=f32)
    quiet_ws = _quiet_workspace(lib, c_widths, A, B, D, dtype, dev)
    fn = (lib.decoder_fwdbwd_f32 if dtype == f32
          else lib.decoder_fwdbwd_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(z.data_ptr(), ptrs, c_widths, x.data_ptr(),
                 0 if x.dim() == 2 else B * D, A, B, D, float(thr),
                 int(bool(with_mism)), part_sum.data_ptr(),
                 part_mism.data_ptr(), out.data_ptr(), acts.data_ptr(),
                 dh5.data_ptr(), part_grad.data_ptr(), dz.data_ptr(),
                 flat_grads.data_ptr(), dw11.data_ptr(), db11.data_ptr(),
                 quiet_ws.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"decoder_fwdbwd kernel launch failed: CUDA error "
                           f"{err}")
    decoder_fwdbwd.launches += 1
    # the kernel lays the trunk gradients out layer by layer, each a
    # contiguous (A, ...) block
    dtrunk, at = [], 0
    for k, n in zip(widths[:-1], widths[1:]):
        dw = flat_grads[at:at + A * k * n].view(A, k, n)
        at += A * k * n
        dtrunk.append((dw, flat_grads[at:at + A * n].view(A, n)))
        at += A * n
    hs, at = [], 0
    for n in widths[1:]:
        hs.append(acts[at:at + A * B * n].view(A, B, n))
        at += A * B * n
    return out[:, 0], out[:, 1], dz, dtrunk, dw11, db11, hs, dh5


decoder_fwdbwd.launches = 0


def fused_decoder_mse(z, w6, b6, w7, b7, w8, b8, w9, b9, w10, b10, w11, b11,
                      x, thr: float = 0.1, with_mism: bool = True):
    """Per-arm (sumsq, mismatch_count) of the full decoder against x.

    With grad enabled and any of z and the twelve parameters requiring it,
    the training form (``decoder_fwdbwd`` inside an autograd function);
    otherwise the value-only forward.

    Args:
      z: (A, B, C+S) decoder input [c_smp, dropout(s_smp)].
      w6: (A, C+S, L), w7: (A, L, F), w8..w10: (A, F, F), w11: (A, F, D);
        b*: (A, out).
      x: (B, D) shared target or (A, B, D) per-arm targets; no gradient.
      thr: binarization threshold.  with_mism: count mismatches; without,
        ``mism`` is 0.

    Returns (sumsq (A,) f32, mism (A,) f32) as ``ops/recon.fused_recon_mse``.
    """
    diff = (z, w6, b6, w7, b7, w8, b8, w9, b9, w10, b10, w11, b11)
    if torch.is_grad_enabled() and any(t.requires_grad for t in diff):
        return _FusedDecoderMSE.apply(*diff, x, thr, with_mism)
    trunk = [(w6, b6), (w7, b7), (w8, b8), (w9, b9), (w10, b10)]
    return _decoder_value(z, trunk, w11, b11, x, thr, with_mism)


fused_decoder_mse.launches = 0


class _FusedDecoderMSE(torch.autograd.Function):
    """The fused training op: forward = ``decoder_fwdbwd``; backward scales
    the stashed gradients by the per-arm cotangent of sumsq.  ``mism`` is a
    metric without gradient and ``x`` gets none (decoder_pallas.py:351-362)."""

    @staticmethod
    def forward(ctx, *args):
        diff, (x, thr, with_mism) = args[:13], args[13:]
        trunk = [(diff[1 + 2 * i], diff[2 + 2 * i]) for i in range(N_TRUNK)]
        sumsq, mism, dz, dtrunk, dw11, db11 = decoder_fwdbwd(
            diff[0], trunk, diff[11], diff[12], x, thr, with_mism)
        ctx.save_for_backward(dz, *(t for pair in dtrunk for t in pair),
                              dw11, db11)
        ctx.dtypes = tuple(t.dtype for t in diff)
        ctx.mark_non_differentiable(mism)
        return sumsq, mism

    @staticmethod
    def backward(ctx, g_sumsq, g_mism):
        if g_sumsq is None:
            return (None,) * 16
        ga = g_sumsq.float()
        # scaled in place where the stash is f32 already: it is used once
        grads = []
        for t, dt in zip(ctx.saved_tensors, ctx.dtypes):
            s = ga[:, None, None] if t.dim() == 3 else ga[:, None]
            t = t.mul_(s) if t.dtype == torch.float32 else t.float() * s
            grads.append(t.to(dt))
        return (*grads, None, None, None)
