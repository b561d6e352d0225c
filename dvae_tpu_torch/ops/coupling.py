"""Fused arm-coupling distance: the (A, A) Gram matrix of the
precision-scaled, centred log posteriors, and the pair sum
Σ_{a<d} mean_B ‖prec_a − prec_d‖² = (A·tr G − Σ G) / B that follows from it.

Counterpart of dvae_tpu/ops/coupling_pallas.py.  The eager form
(``models/losses.coupling_distance``) materialises log(c + eps) and the
scaled tensor, two (A, B, C) tensors, before the Gram contraction; the
hand-written CUDA kernel of ``csrc/coupling.cu`` (its source note states
the bound, the design and the workspace) reads ``c`` once, in one
cooperative launch, for any A and C (past 10 arms or 1024 categories its
general form, which tiles the arm pairs and keeps c out of shared memory),
and emits only the Gram matrix and the distance —
kernel #11 (``_kernel``, coupling_pallas.py:51), counted once per launch by
``coupling_gram_fused.launches``:

    phase 0   S1 = Σ_B c, S2 = Σ_B c², SL = Σ_B log(c + eps)      per (A, C)
              w = rsqrt(max((S2 − S1²/B)/(B − 1), 0) + eps)
              m = mean_A(w·SL) / B
    phase 1   prec = log(c + eps)·w − m,   G = Σ_{B,C} prec_a·prec_d

Centring by ``m`` and the clamp of the one-pass variance are the two
guards of coupling_pallas.py:19-29; ``coupling_gram_plain`` walks the same
two phases.  The gradient is autograd of the eager form on the saved
``c``, exactly as the JAX package's ``_bwd`` (:140-143) takes it: there is
no backward kernel.

On CPU tensors the wrappers run the plain version; on CUDA tensors they
launch the kernels or raise.
"""

from __future__ import annotations

import ctypes

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import on_cpu


def _lib() -> ctypes.CDLL:
    lib = _build.load("coupling")
    if not getattr(lib, "_dvae_bound", False):
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.coupling_gram_f32.argtypes = [vp, ctypes.c_float, i, i, i, vp,
                                          vp]
        lib.coupling_gram_f32.restype = i
        lib.coupling_buffer_floats.argtypes = [i, i, i]
        lib.coupling_buffer_floats.restype = ctypes.c_longlong
        lib.coupling_plan.argtypes = [i, i, i,
                                      ctypes.POINTER(ctypes.c_longlong)]
        lib.coupling_plan.restype = i
        lib._dvae_bound = True
    return lib


def _check_c(c) -> tuple:
    if c.dim() != 3:
        raise ValueError(f"expected c (A, B, C), got {tuple(c.shape)}")
    if c.shape[1] < 2:
        raise ValueError("the unbiased batch variance needs B >= 2 rows")
    return tuple(c.shape)


def coupling_gram_plain(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of kernel #11: the two phases with the one-pass
    variance and its clamp, the column sums in double as the kernel's
    second reduction takes them.  Returns the (A, A) f32 Gram matrix
    (not divided by B)."""
    _, B, _ = _check_c(c)
    c = c.float()
    logc = torch.log(c + eps)
    c64 = c.double()
    s1, s2 = c64.sum(dim=1), (c64 * c64).sum(dim=1)
    sl = logc.double().sum(dim=1)                                # (A, C)
    var = (s2 - s1 * s1 / B) / (B - 1)
    eps32 = float(torch.tensor(eps, dtype=torch.float32))
    w = 1.0 / torch.sqrt(torch.clamp(var, min=0.0) + eps32)
    m = (w * sl).mean(dim=0) / B                                 # (C,)
    prec = logc * w.float()[:, None, :] - m.float()
    return torch.einsum("abc,dbc->ad", prec, prec)


def coupling_distance_plain(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain version of the distance: (A·tr G − Σ G) / B of the plain Gram
    matrix."""
    g = coupling_gram_plain(c, eps)
    return (c.shape[0] * g.diagonal().sum() - g.sum()) / c.shape[1]


# Kernel #11's launch plan (csrc/coupling.cu ``make_plan``): the grid's
# block count is a constant bound, not the card's SM count, so that every
# sum runs in an order fixed by the shape alone.
COUPLING_SLOTS = 132      # most blocks
COUPLING_MIN_ROWS = 8     # fewest rows a block's slab holds
COUPLING_SLAB_BYTES = 160 * 1024  # shared memory for a slab's logs
COUPLING_TILED_ARMS = 10  # the templated kernel's most arms
COUPLING_TILED_C = 1024   # and categories; past either, the general kernel


def coupling_plan(A: int, B: int, C: int) -> dict:
    """The plan the kernel makes for c (A, B, C): ``nb`` blocks, each
    owning ``rows`` consecutive rows of every arm.  Up to
    ``COUPLING_TILED_ARMS`` arms and ``COUPLING_TILED_C`` categories the
    templated kernel runs: ``keep`` when the slab's logs fit its shared
    memory (else it walks ``piece`` rows at a time and phase 1 reads c
    again); ``smem``, a block's dynamic shared memory in bytes (the slab's
    piece and the weights w, m).  Past either, ``general``: no slab in
    shared memory (``piece`` 0), only each arm's w·SL in double."""
    nb = min(COUPLING_SLOTS, -(-B // COUPLING_MIN_ROWS))
    rows = -(-B // nb)
    if A > COUPLING_TILED_ARMS or C > COUPLING_TILED_C:
        return {"nb": nb, "rows": rows, "piece": 0, "keep": False,
                "smem": 8 * A, "general": True}
    row_bytes = 4 * A * C
    keep = rows * row_bytes <= COUPLING_SLAB_BYTES
    piece = rows if keep else max(1, COUPLING_SLAB_BYTES // row_bytes)
    return {"nb": nb, "rows": rows, "piece": piece, "keep": keep,
            "smem": piece * row_bytes + 4 * (A + 1) * C, "general": False}


def _launch(c: torch.Tensor, eps: float) -> torch.Tensor:
    """A·A + 1 floats from one run of kernel #11: G row by row, then the
    distance; a view of the one buffer that also holds the launch's
    workspace."""
    A, B, C = _check_c(c)
    if c.dtype != torch.float32:
        raise ValueError(f"c is {c.dtype}; the coupling kernel takes float32")
    if not c.is_contiguous():
        raise ValueError("c is not contiguous")
    lib = _lib()
    buf = torch.empty(lib.coupling_buffer_floats(A, B, C), device=c.device,
                      dtype=torch.float32)
    with torch.cuda.device(c.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.coupling_gram_f32(c.data_ptr(), float(eps), A, B, C,
                                    buf.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"coupling kernel launch failed: CUDA error {err} "
                           "(a cooperative launch the card cannot hold "
                           "raises here)")
    coupling_gram_fused.launches += 1
    return buf[:A * A + 1]


def coupling_gram_fused(c: torch.Tensor, eps: float) -> torch.Tensor:
    """(A, A) Gram matrix of the precision-scaled, centred log posteriors
    of c (A, B, C), not divided by B.  Kernel #11 on a CUDA tensor, the
    plain version on a CPU tensor.  No gradient."""
    if on_cpu(c):
        return coupling_gram_plain(c.detach(), eps)
    A = c.shape[0]
    return _launch(c.detach(), eps)[:A * A].reshape(A, A)


coupling_gram_fused.launches = 0


def _distance_value(c: torch.Tensor, eps: float) -> torch.Tensor:
    if on_cpu(c):
        return coupling_distance_plain(c, eps)
    return _launch(c, eps)[-1]


class _CouplingDistance(torch.autograd.Function):
    @staticmethod
    def forward(ctx, c, eps):
        ctx.eps = eps
        ctx.save_for_backward(c)
        return _distance_value(c, eps)

    @staticmethod
    def backward(ctx, g):
        from dvae_tpu_torch.models.losses import coupling_distance
        (c,) = ctx.saved_tensors
        with torch.enable_grad():
            x = c.detach().requires_grad_()
            (dc,) = torch.autograd.grad(coupling_distance(x, ctx.eps), x, g)
        return dc, None


def coupling_distance_fused(c: torch.Tensor, eps: float) -> torch.Tensor:
    """Σ over arm pairs of the mean precision-scaled simplex distance of
    c (A, B, C): the fused forward, the eager form's exact gradient."""
    if torch.is_grad_enabled() and c.requires_grad:
        return _CouplingDistance.apply(c, float(eps))
    return _distance_value(c.detach(), float(eps))
