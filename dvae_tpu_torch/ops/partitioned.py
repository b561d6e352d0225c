"""The fused kernels on a rank's shards of a mesh.

Counterpart of dvae_tpu/ops/partitioned.py.  The JAX package attaches
``custom_partitioning`` rules to its Pallas kernels so that the
partitioner runs them on local shards with the fewest collectives; here a
rank holds its shards already, so each op is an autograd function that
calls the port's kernel wrapper on them and reduces what is partial over
the batch group (the ranks that share this rank's arms):

  * ``make_partitioned_recon`` (recon_pallas ``fused_recon_mse``): kernel
    #1 without a gradient, #2 with one; the per-arm sums and dW, db are
    all-reduced, dh stays local;
  * ``make_partitioned_dropout_fc1`` (encoder_pallas ``fused_dropout_fc1``):
    kernels #4 and #5 with the seed offset by this rank's shard index,
    flattened over (arm, data, fsdp) as dvae_tpu/ops/partitioned.py:215-217
    does, the same offset forward and backward, so the backward redraws
    the forward's mask; dW, db are all-reduced;
  * ``make_partitioned_zinb`` (zinb_pallas ``fused_zinb``): kernels #6 and
    #7; the loss and the six head gradients are all-reduced.

The axis names are arguments, as in the JAX package, and the mesh
(``parallel.sharding.Mesh``) gives their groups; axes that the step
dropped (``()``) reduce nothing.  On CPU tensors the wrappers run their
plain versions; on CUDA tensors they launch their kernels or raise, and
the error ends this rank.  The sums are all-reduced in the forward, where
the kernels compute the gradients too, as the JAX rules psum them there;
the backward only scales by the per-arm cotangent, which every rank of
the group holds the same.
"""

from __future__ import annotations

from typing import Optional

import torch

from dvae_tpu_torch.ops.encoder import encoder_bwd, encoder_fwd
from dvae_tpu_torch.ops.recon import _recon_value, recon_fwdbwd
from dvae_tpu_torch.ops.zinb import _zinb_value, zinb_fwdbwd
from dvae_tpu_torch.parallel.runtime import Group, flat_all_reduce

_SEED_STRIDE = 0x9E3779B1 - (1 << 32)  # golden-ratio stride (as signed i32)


def local_seed(seed: int, offset: int) -> int:
    """``seed + offset·_SEED_STRIDE`` in int32 arithmetic with wrap-around
    (dvae_tpu/ops/partitioned.py:215-217), as a signed int32."""
    v = (int(seed) + int(offset) * _SEED_STRIDE) & 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _group(mesh, batch_axes) -> Optional[Group]:
    return mesh.group(batch_axes) if (mesh is not None and batch_axes) \
        else None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _scale(t, g):
    return t.mul_(g.float().reshape((-1,) + (1,) * (t.dim() - 1)))


# ---------------------------------------------------------------------------
# fused_recon_mse, partitioned
# ---------------------------------------------------------------------------

class _PartitionedRecon(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w, b, x, thr, with_mism, group):
        sumsq, mism, dh, dw, db = recon_fwdbwd(h, w, b, x, thr, with_mism)
        sumsq, mism, dw, db = flat_all_reduce([sumsq, mism, dw, db], group)
        ctx.save_for_backward(dh, dw, db)
        ctx.dtypes = (h.dtype, w.dtype, b.dtype)
        ctx.mark_non_differentiable(mism)
        # own storage: the backward scales dw, db where they lie, in the
        # one buffer the all-reduce filled
        return sumsq.clone(), mism.clone()

    @staticmethod
    def backward(ctx, g_sumsq, g_mism):
        if g_sumsq is None:
            return (None,) * 7
        dh, dw, db = ctx.saved_tensors
        h_dt, w_dt, b_dt = ctx.dtypes
        return (_scale(dh, g_sumsq).to(h_dt), _scale(dw, g_sumsq).to(w_dt),
                _scale(db, g_sumsq).to(b_dt), None, None, None, None)


def make_partitioned_recon(arm_axes, batch_axes, mesh, thr: float = 0.1,
                           with_mism: bool = True):
    """op(h, w, b, x) → (sumsq, mism) of this rank's arms over the whole
    batch: h (A_l, B_l, F), w (A_l, F, D), b (A_l, D), x (B_l, D) or
    (A_l, B_l, D), this rank's blocks.  Semantics of
    ``ops/recon.fused_recon_mse``."""
    del arm_axes  # a rank's arms are its own: nothing to reduce over them

    def op(h, w, b, x):
        group = _group(mesh, batch_axes)
        if _wants_grad(h, w, b):
            return _PartitionedRecon.apply(h, w, b, x, thr, with_mism, group)
        sumsq, mism = _recon_value(h, w, b, x, thr, with_mism)
        return tuple(flat_all_reduce([sumsq, mism], group))

    return op


# ---------------------------------------------------------------------------
# fused_dropout_fc1, partitioned
# ---------------------------------------------------------------------------

class _PartitionedDropoutFC1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, seed, x, w, b, rate, mask, group):
        ctx.seed, ctx.rate, ctx.group = seed, rate, group
        ctx.dtypes = (w.dtype, b.dtype)
        ctx.save_for_backward(x, mask)
        return encoder_fwd(seed, x, w, b, rate, mask)

    @staticmethod
    def backward(ctx, g):
        x, mask = ctx.saved_tensors
        dw, db = encoder_bwd(ctx.seed, x, g, ctx.rate, mask)
        dw, db = flat_all_reduce([dw, db], ctx.group)
        w_dt, b_dt = ctx.dtypes
        return None, None, dw.to(w_dt), db.to(b_dt), None, None, None


def make_partitioned_dropout_fc1(arm_axes, batch_axes, mesh, rate: float):
    """op(seed, x, w, b, mask=None) → (A_l, B_l, F) pre-ReLU fc1 output of
    this rank's blocks; the in-kernel mask is keyed by ``local_seed(seed,
    off)`` with ``off`` this rank's index over (arm_axes + batch_axes).
    An explicit mask is this rank's (A_l, B_l, D) block.  Semantics of
    ``ops/encoder.fused_dropout_fc1``."""
    arm_axes, batch_axes = tuple(arm_axes), tuple(batch_axes)
    offset = mesh.axis_index(arm_axes + batch_axes) if mesh is not None \
        else 0

    def op(seed, x, w, b, mask: Optional[torch.Tensor] = None):
        return _PartitionedDropoutFC1.apply(
            local_seed(seed, offset), x, w, b, float(rate), mask,
            _group(mesh, batch_axes))

    op.offset = offset
    return op


# ---------------------------------------------------------------------------
# fused_zinb, partitioned
# ---------------------------------------------------------------------------

class _PartitionedZINB(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps, group):
        loss, dh, gr, gp, gz = zinb_fwdbwd(h, w_r, b_r, w_p, b_p, w_z, b_z,
                                           x, eps)
        loss, *grads = flat_all_reduce([loss, *gr, *gp, *gz], group)
        ctx.save_for_backward(dh, *grads)
        ctx.dtypes = tuple(t.dtype for t in (h, w_r, b_r, w_p, b_p, w_z, b_z))
        return loss.clone()  # own storage, as in _PartitionedRecon

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 10
        grads = tuple(_scale(t, g).to(dt)
                      for t, dt in zip(ctx.saved_tensors, ctx.dtypes))
        return (*grads, None, None, None)


def make_partitioned_zinb(arm_axes, batch_axes, mesh, eps: float = 1e-6):
    """op(h, w_r, b_r, w_p, b_p, w_z, b_z, x) → (A_l,) ZINB loss sums of
    this rank's arms over the whole batch, from this rank's blocks.
    Semantics of ``ops/zinb.fused_zinb``."""
    del arm_axes

    def op(h, w_r, b_r, w_p, b_p, w_z, b_z, x):
        group = _group(mesh, batch_axes)
        tensors = (h, w_r, b_r, w_p, b_p, w_z, b_z)
        if _wants_grad(*tensors):
            return _PartitionedZINB.apply(*tensors, x, eps, group)
        loss = _zinb_value(*tensors, x, eps)
        return flat_all_reduce([loss], group)[0]

    return op
