"""Fused three-head ZINB loss: the decoder's three output layers (NB rate,
success probability, zero inflation) and the zero-inflated negative-
binomial reconstruction loss, forward and backward, without materialising
the pre-activations or r, p, z (the training kernel keeps the three
cotangents, in a workspace, for its column pass).

Counterpart of dvae_tpu/ops/zinb_pallas.py.  Per arm a,

    y_r = h_a W_r + b_r        r = relu(y_r) + eps
    y_p = h_a W_p + b_p        p = (1-eps)(σ(y_p) + eps)
    y_z = h_a W_z + b_z        z = (1-eps)(σ(y_z) + eps)
    k   = min(expm1(x), 1e12)
    L_a = Σ_{k>0} (lnΓ(r) − lnΓ(k+r) − k·log p − r·log(1−p) − log(1−z))
        + Σ_{k=0} −log(z + (1−z)(1−p)^r)

Three hand-written CUDA kernels carry it; each source note states its
bound and its design:

  * ``csrc/zinb_fwd.cu`` — the value-only forward that eval and validation
    run (``_fwd_kernel``, zinb_pallas.py:269): the value-only form of the
    training kernel's row pass (``csrc/zinb_rows.cuh``), its products on
    the tensor cores, its value equal to the training kernel's loss bit for
    bit; launched by ``fused_zinb`` when no gradient is asked for, counted
    by ``fused_zinb.launches``;
  * ``csrc/zinb_fwdbwd.cu`` — the training forward with the unscaled
    gradients in the same call (``_fwdbwd_kernel``, zinb_pallas.py:450),
    its products on the tensor cores (bf16, or 3xTF32 for f32 operands):
    the row pass stores the three cotangents in a workspace, and the column
    pass forms dW and db from them as a ``wgmma`` product over B; launched
    by ``zinb_fwdbwd``, counted by ``zinb_fwdbwd.launches`` (the column
    pass by ``zinb_fwdbwd.wgmma_launches``); ``fwdbwd_plan`` is the
    launch's plan and workspace, as the library computes them;
  * the same source's separate backward for a given per-arm cotangent
    (``_bwd_kernel``, zinb_pallas.py:338), through the same two passes;
    launched by ``zinb_bwd``, counted by ``zinb_bwd.launches`` and
    ``zinb_bwd.wgmma_launches``.

CUDA has no ``digamma`` and the kernels need lnΓ and ψ only as
differences, so ``lgamma``, ``digamma`` and ``_lgdg_diff`` below are the
branch-free shifted-Stirling forms of zinb_pallas.py:150-232, built from
+, ·, / and log only; the plain versions compute what the kernels compute
(not ``torch.lgamma``), step by step on materialised tensors.
``zinb_heads_reference`` is the oracle with ``torch.lgamma``, for tests.

Under autograd ``fused_zinb`` runs the fused forward+backward and stashes
the gradients; its backward scales them by the per-arm cotangent
(zinb_pallas.py:591-619).  On CPU tensors every wrapper runs its plain
version; on CUDA tensors it launches its kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import check_kernel_operands, on_cpu

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# Recurrence shift lnΓ(x) = lnΓ(x+4) − ln[x(x+1)(x+2)(x+3)]: the shift
# product and its derivative as dense polynomials (Horner chains).
_P4 = (1.0, 6.0, 11.0, 6.0, 0.0)     # x⁴ + 6x³ + 11x² + 6x
_P4D = (4.0, 18.0, 22.0, 6.0)        # d/dx
# P4 overflows f32 at x ≈ 4.3e9; saturating it just under the f32 maximum
# and clamping the counts keep loss and gradients finite for any f32 input
# (zinb_pallas.py:83-94).
_P4_CLAMP = 3.0e38
_COUNT_CLAMP = 1.0e12

_OPERANDS = ("h", "w_r", "b_r", "w_p", "b_p", "w_z", "b_z", "x")


# ---------------------------------------------------------------------------
# lnΓ and ψ from elementary operations
# ---------------------------------------------------------------------------

def _counts(x: torch.Tensor) -> torch.Tensor:
    """expm1 of log1p data → NB counts, clamped to the kernels' domain."""
    return torch.clamp(torch.expm1(x.float()), max=_COUNT_CLAMP)


def _horner(coeffs, x: torch.Tensor) -> torch.Tensor:
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def _p4(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(_horner(_P4, x), max=_P4_CLAMP)


def _sigmoid(y: torch.Tensor) -> torch.Tensor:
    """σ(y) with y clamped at −30, so exp(−y) stays finite."""
    return 1.0 / (1.0 + torch.exp(-torch.clamp(y, min=-30.0)))


def lgamma(x: torch.Tensor) -> torch.Tensor:
    """log Γ(x) for x > 0: the asymptotic series at u = x + 4 (corrections
    through 1/(1260u⁵)) minus the log of the shift polynomial."""
    u = x + 4.0
    inv = 1.0 / u
    inv2 = inv * inv
    series = inv * (1.0 / 12.0 - inv2 * (1.0 / 360.0 - inv2 / 1260.0))
    return ((u - 0.5) * torch.log(u) - u + _HALF_LOG_2PI + series
            - torch.log(_p4(x)))


def digamma(x: torch.Tensor) -> torch.Tensor:
    """ψ(x) for x > 0: the series of ``lgamma`` differentiated term by
    term."""
    u = x + 4.0
    inv = 1.0 / u
    inv2 = inv * inv
    series = inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    return torch.log(u) - 0.5 * inv - series - _horner(_P4D, x) / _p4(x)


def _lgdg_diff(k: torch.Tensor, r: torch.Tensor, want_dg: bool = True):
    """(lnΓ(r) − lnΓ(k+r), ψ(r) − ψ(k+r)): the only forms the loss and its
    gradient consume.  The two shift-polynomial logs merge into one log of
    the ratio q = P4(k+r)/P4(r), clipped to [1, _P4_CLAMP]."""
    kr = k + r
    u1 = kr + 4.0
    u2 = r + 4.0
    inv1 = 1.0 / u1
    inv2 = 1.0 / u2
    i1sq = inv1 * inv1
    i2sq = inv2 * inv2
    logu1 = torch.log(u1)
    logu2 = torch.log(u2)
    s1 = inv1 * (1.0 / 12.0 - i1sq * (1.0 / 360.0 - i1sq / 1260.0))
    s2 = inv2 * (1.0 / 12.0 - i2sq * (1.0 / 360.0 - i2sq / 1260.0))
    p41 = _p4(kr)
    p42 = _p4(r)
    q = torch.clamp(p41 / p42, min=1.0, max=_P4_CLAMP)
    dlg = ((u2 - 0.5) * logu2 - (u1 - 0.5) * logu1 + k + (s2 - s1)
           + torch.log(q))
    if not want_dg:
        return dlg, None
    d1 = i1sq * (1.0 / 12.0 - i1sq * (1.0 / 120.0 - i1sq / 252.0))
    d2 = i2sq * (1.0 / 12.0 - i2sq * (1.0 / 120.0 - i2sq / 252.0))
    ddg = (logu2 - logu1 - 0.5 * (inv2 - inv1) - (d2 - d1)
           - _horner(_P4D, r) / p42 + _horner(_P4D, kr) / p41)
    return dlg, ddg


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _check_shapes(h, w_r, b_r, w_p, b_p, w_z, b_z, x):
    if h.dim() != 3:
        raise ValueError("expected h (A,B,F)")
    A, B, F = h.shape
    D = w_r.shape[-1]
    for name, w, b in (("r", w_r, b_r), ("p", w_p, b_p), ("z", w_z, b_z)):
        if tuple(w.shape) != (A, F, D) or tuple(b.shape) != (A, D):
            raise ValueError(
                f"head {name}: w {tuple(w.shape)}, b {tuple(b.shape)} do not "
                f"match h {tuple(h.shape)} and D={D}")
    if tuple(x.shape) not in ((B, D), (A, B, D)):
        raise ValueError(f"x {tuple(x.shape)} is neither ({B}, {D}) nor "
                         f"({A}, {B}, {D})")
    return A, B, F, D


def _head(h, w, b):
    """(A, B, D) f32 pre-activation: f32 accumulation, bias added in f32."""
    return torch.baddbmm(b.float()[:, None, :], h.float(), w.float())


def _zinb_terms(y_r, y_p, y_z, k, eps):
    """The shared intermediates of the loss and its cotangents."""
    r = torch.relu(y_r) + eps
    sigp = _sigmoid(y_p)
    sigz = _sigmoid(y_z)
    p = (1.0 - eps) * (sigp + eps)
    z = (1.0 - eps) * (sigz + eps)
    log1mp = torch.log(1.0 - p)
    E = torch.exp(r * log1mp)                       # (1-p)^r
    D0 = z + (1.0 - z) * E
    return r, sigp, sigz, p, z, log1mp, E, D0, k > 0


def _zinb_loss_elems(k, r, p, z, log1mp, D0, nz, dlg):
    # −log(1−z) (nonzero) and −log(D0) (zero) share one log of a selected
    # argument (zinb_pallas.py:257-261)
    log_sel = torch.log(torch.where(nz, 1.0 - z, D0))
    return torch.where(nz, dlg - k * torch.log(p) - r * log1mp,
                       torch.zeros_like(r)) - log_sel


def zinb_heads_plain(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps: float = 1e-6):
    """Plain version of the value-only kernel: the kernel's arithmetic on
    materialised (A, B, D) tensors.  Returns the per-arm sum (A,) f32;
    differentiable by autograd."""
    _check_shapes(h, w_r, b_r, w_p, b_p, w_z, b_z, x)
    k = _counts(x)
    r, _, _, p, z, log1mp, _, D0, nz = _zinb_terms(
        _head(h, w_r, b_r), _head(h, w_p, b_p), _head(h, w_z, b_z), k, eps)
    dlg, _ = _lgdg_diff(k, r, want_dg=False)
    return _zinb_loss_elems(k, r, p, z, log1mp, D0, nz, dlg).sum(dim=(1, 2))


def _zinb_grads(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps, g=None):
    """Analytic gradients (zinb_pallas.py:505-529).  ``g`` None: the loss
    and the unscaled gradients, ψ(r) − ψ(k+r) from ``_lgdg_diff``; ``g``
    (A,): the gradients for that cotangent, from two ``digamma`` calls as
    the separate backward kernel has it (:374-375), loss None."""
    _check_shapes(h, w_r, b_r, w_p, b_p, w_z, b_z, x)
    k = _counts(x)
    y_r = _head(h, w_r, b_r)
    r, sigp, sigz, p, z, log1mp, E, D0, nz = _zinb_terms(
        y_r, _head(h, w_p, b_p), _head(h, w_z, b_z), k, eps)
    if g is None:
        dlg, ddg = _lgdg_diff(k, r)
        loss = _zinb_loss_elems(k, r, p, z, log1mp, D0, nz, dlg).sum(
            dim=(1, 2))
        ga = 1.0
    else:
        ddg = -digamma(k + r) + digamma(r)
        loss = None
        ga = g.float()[:, None, None]
    invD0 = 1.0 / D0
    inv_p1mp = 1.0 / (p * (1.0 - p))    # 1/p and 1/(1-p) from one reciprocal
    common = invD0 * (1.0 - z) * E      # zero-branch weight
    dr = torch.where(nz, ddg - log1mp, -common * log1mp)
    dp = torch.where(nz, (r * p - k * (1.0 - p)) * inv_p1mp,
                     common * r * (p * inv_p1mp))
    dz = torch.where(nz, 1.0 / (1.0 - z), -invD0 * (1.0 - E))
    g_r = torch.where(y_r > 0, ga * dr, torch.zeros_like(dr))
    g_p = ga * dp * ((1.0 - eps) * sigp * (1.0 - sigp))
    g_z = ga * dz * ((1.0 - eps) * sigz * (1.0 - sigz))
    hf = h.float().transpose(1, 2)
    dh = None
    grads = []
    for gm, w in ((g_r, w_r), (g_p, w_p), (g_z, w_z)):
        # rounded to h's dtype for the products, f32 for db (:522-528)
        gm16 = gm.to(h.dtype).float()
        part = torch.bmm(gm16, w.float().transpose(1, 2))
        dh = part if dh is None else dh + part
        grads.append((torch.bmm(hf, gm16), gm.sum(dim=1)))
    return (loss, dh, *grads)


def zinb_grads_plain(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps: float = 1e-6):
    """Plain version of the training kernel: (loss (A,), dh (A,B,F),
    (dW_r, db_r), (dW_p, db_p), (dW_z, db_z)), the gradients of Σ_a loss_a
    unscaled, all f32."""
    return _zinb_grads(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps)


def zinb_bwd_plain(g, h, heads, x, eps: float = 1e-6):
    """Plain version of the separate backward kernel: (dh, (dW_r, db_r),
    (dW_p, db_p), (dW_z, db_z)) for the per-arm cotangent ``g`` (A,)."""
    (w_r, b_r), (w_p, b_p), (w_z, b_z) = heads
    return _zinb_grads(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps, g=g)[1:]


def zinb_heads_reference(h, w_r, b_r, w_p, b_p, w_z, b_z, x,
                         eps: float = 1e-6):
    """Materialising oracle with ``torch.lgamma`` and unclamped counts
    (zinb_pallas.py:625-641) — testing only."""
    from dvae_tpu_torch.models.losses import zinb_loss
    B, D = h.shape[1], w_r.shape[-1]
    y = lambda w, b: torch.baddbmm(b[:, None, :], h, w).float()  # noqa: E731
    return zinb_loss(torch.relu(y(w_r, b_r)), torch.sigmoid(y(w_p, b_p)),
                     torch.sigmoid(y(w_z, b_z)), x.float(), eps,
                     dim=(1, 2)) * (B * D)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_HEAD_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong]
                  + [ctypes.c_int] * 4 + [ctypes.c_float] * 2)


def _lib_fwd() -> ctypes.CDLL:
    lib = _build.load("zinb_fwd")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.zinb_fwd_f32, lib.zinb_fwd_bf16):
            fn.argtypes = _HEAD_ARGTYPES + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
        lib.zinb_fwd_workspace.argtypes = [ctypes.c_int] * 5
        lib.zinb_fwd_workspace.restype = ctypes.c_longlong
        lib.zinb_fwd_max_rows.argtypes = []
        lib.zinb_fwd_max_rows.restype = ctypes.c_longlong
        lib.zinb_fwd_max_f.argtypes = [ctypes.c_int]
        lib.zinb_fwd_max_f.restype = ctypes.c_int
        lib._dvae_bound = True
    return lib


def _lib_fwdbwd() -> ctypes.CDLL:
    lib = _build.load("zinb_fwdbwd")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.zinb_fwdbwd_f32, lib.zinb_fwdbwd_bf16):
            fn.argtypes = _HEAD_ARGTYPES + [ctypes.c_void_p] * 6
            fn.restype = ctypes.c_int
        for fn in (lib.zinb_bwd_f32, lib.zinb_bwd_bf16):
            fn.argtypes = ([ctypes.c_void_p] + _HEAD_ARGTYPES
                           + [ctypes.c_void_p] * 5)
            fn.restype = ctypes.c_int
        lib.zinb_fwdbwd_workspace_bytes.argtypes = [ctypes.c_int] * 5
        lib.zinb_fwdbwd_workspace_bytes.restype = ctypes.c_longlong
        lib.zinb_fwdbwd_plan.argtypes = [ctypes.c_int] * 5 + [
            ctypes.POINTER(ctypes.c_longlong)]
        lib.zinb_fwdbwd_plan.restype = ctypes.c_int
        lib.zinb_fwdbwd_max_f.argtypes = [ctypes.c_int]
        lib.zinb_fwdbwd_max_f.restype = ctypes.c_int
        lib._dvae_bound = True
    return lib


# ---------------------------------------------------------------------------
# The training kernel's plan (csrc/zinb_rows.cuh `plan`, csrc/zinb_fwdbwd.cu
# `col_plan`, `layout`), from the shape alone
# ---------------------------------------------------------------------------

_KS = {torch.float32: 8, torch.bfloat16: 16}        # k of one mma
_HPAD = {torch.float32: 4, torch.bfloat16: 8}       # h tile pitch - F
_LD1 = {torch.float32: 8, torch.bfloat16: 24}       # pass-1 W and x pitches
_FP = _KC = 128           # widest resident F; the wide row pass's chunk
_SMEM_MAX = 232_448       # dynamic shared memory a block may take
_PLAN_SLOTS = 132 * 4     # an H100's SMs at four row blocks an SM
_NT, _KB, _TM = 104, 32, 64  # pass 2: hidden units, rows of B, columns
_COLS_SMEM = 225 * 1024
# the library's plan vector, in its order
PLAN_KEYS = ("form", "n_split", "cols_per_split", "row_tiles", "n_in_dw",
             "n_spill", "pitch", "k_chunks", "n_ranges", "stages", "smem",
             "spill_offset", "g_offset", "ht_offset", "bytes")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _smem_rows(F: int, dtype) -> int:
    """Shared memory of the training row pass at hidden width F."""
    item, ks = (4 if dtype == torch.float32 else 2), _KS[dtype]
    fk = _cdiv(F, ks) * ks
    stage_rows = _KC if F > _FP else fk
    return item * (64 * (fk + _HPAD[dtype])
                   + 2 * (3 * stage_rows * _LD1[dtype] + 64 * _LD1[dtype]))


def fwdbwd_max_f(dtype) -> int:
    """The widest F the training kernels take (``zinb_fwdbwd_max_f``):
    the row pass's wide form while its resident h tile fits a block; the
    column pass takes any F."""
    f, ks = _FP, _KS[dtype]
    while _smem_rows(f + ks, dtype) + 64 <= _SMEM_MAX:
        f += ks
    return f


def fwdbwd_plan(A: int, B: int, F: int, D: int, dtype) -> dict:
    """The training kernels' plan of the shape, as ``zinb_fwdbwd_plan``
    gives it (``PLAN_KEYS``): the row pass's form (13 or 16 tiles of 8
    hidden units, "wide" past 128) and its slices of D with the dh
    partials they leave; the column pass's stored cotangents (rows of B
    rounded up to 4 floats), its chunks of 32 rows of B, ranges of 104
    hidden units, ring stages and shared memory; the workspace's byte
    offsets and size.  Raises ValueError for a shape the kernels refuse."""
    if dtype not in _KS:
        raise ValueError(f"no ZINB training kernel for {dtype}")
    limit = fwdbwd_max_f(dtype)
    _check_width(F, limit, dtype, "the row pass's resident (64, F) tile of h")
    if (F < 1 or not 1 <= A <= 65535 or not 1 <= B <= 0x7FFFFFFF - 64
            or D < 1 or 3 * A * D > 0x7FFFFFFF - _TM):
        raise ValueError(f"zinb_fwdbwd refuses the shape A={A}, B={B}, "
                         f"F={F}, D={D}")
    item = 4 if dtype == torch.float32 else 2
    bn1 = _KS[dtype]
    row_tiles = _cdiv(B, 64)
    chunks = _cdiv(D, bn1)
    cap = (3 * D) // B           # dh partials the dW buffer has room for
    best, n_split = -1.0, 1
    for n in range(1, min(8, chunks) + 1):
        if n - 1 - cap > 2:
            break
        blocks = row_tiles * A * n
        eff = blocks / (_cdiv(blocks, _PLAN_SLOTS) * _PLAN_SLOTS)
        if eff > best + 1e-9:
            best, n_split = eff, n
    n_in_dw = min(cap, n_split - 1)
    planes = 2 if dtype == torch.float32 else 1
    stage = _cdiv(3 * _TM * _KB * 4 + planes * _NT * _KB * item, 1024) * 1024
    stages = min(6, (_COLS_SMEM - 1024) // stage)
    pitch = _cdiv(B, 4) * 4
    k_chunks, n_ranges = _cdiv(B, _KB), _cdiv(F, _NT)
    a256 = lambda n: _cdiv(n, 256) * 256  # noqa: E731
    spill = a256(A * row_tiles * n_split * 4)
    g = spill + a256((n_split - 1 - n_in_dw) * A * B * F * 4)
    ht = g + a256(3 * A * D * pitch * 4)
    return {"form": 13 if F <= 104 else 16 if F <= _FP else "wide",
            "n_split": n_split,
            "cols_per_split": _cdiv(chunks, n_split) * bn1,
            "row_tiles": row_tiles, "n_in_dw": n_in_dw,
            "n_spill": n_split - 1 - n_in_dw, "pitch": pitch,
            "k_chunks": k_chunks, "n_ranges": n_ranges, "stages": stages,
            "smem": 1024 + stages * stage, "spill_offset": spill,
            "g_offset": g, "ht_offset": ht,
            "bytes": ht + a256(A * k_chunks * n_ranges * planes * _NT * _KB
                               * item)}


def _check_width(F: int, limit: int, dtype, what: str) -> None:
    """Raise unless the kernel takes the hidden width F: any F up to 128,
    wider ones in chunks of 128 while ``what`` fits a block's shared
    memory."""
    if F > limit:
        raise ValueError(f"F={F} exceeds {limit}, the widest hidden layer "
                         f"for which {what} fits a block's 232,448 bytes of "
                         f"shared memory in {dtype}")


def _kernel_args(tensors, A, B, F, D, eps):
    """The head arguments every entry point takes, after the checks."""
    dtype = check_kernel_operands(_OPERANDS, tensors)
    if A == 0 or B == 0 or D == 0:
        raise ValueError(f"empty operand: A={A}, B={B}, D={D}")
    x = tensors[-1]
    args = [t.data_ptr() for t in tensors] + [
        0 if x.dim() == 2 else B * D, A, B, F, D, float(eps),
        float(1.0 - eps)]
    return dtype, args


def _grad_buffers(lib, dtype, A, B, F, D, dev):
    """dh, dW, db and the launch's workspace (``fwdbwd_plan``): the loss
    partials, any dh partials of the row pass beyond the room the dW buffer
    lends it (none at the production shape), the stored cotangents and the
    column pass's prepared hᵀ."""
    n_work = fwdbwd_plan(A, B, F, D, dtype)["bytes"]
    lib_bytes = int(lib.zinb_fwdbwd_workspace_bytes(
        int(dtype == torch.bfloat16), A, B, F, D))
    if lib_bytes != n_work:
        raise RuntimeError(f"zinb_fwdbwd's library plans {lib_bytes} bytes "
                           f"of workspace for A={A}, B={B}, F={F}, D={D}, "
                           f"the wrapper {n_work}")
    work = torch.empty(n_work, device=dev, dtype=torch.uint8)
    dh = torch.empty((A, B, F), device=dev, dtype=torch.float32)
    dw = torch.empty((3, A, F, D), device=dev, dtype=torch.float32)
    db = torch.empty((3, A, D), device=dev, dtype=torch.float32)
    return work, dh, dw, db


def _zinb_value(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps):
    """Value-only forward: the kernel on CUDA, the plain version on CPU."""
    tensors = (h, w_r, b_r, w_p, b_p, w_z, b_z, x)
    A, B, F, D = _check_shapes(*tensors)
    if on_cpu(*tensors):
        return zinb_heads_plain(*tensors, eps)
    dtype, args = _kernel_args(tensors, A, B, F, D, eps)
    lib = _lib_fwd()
    if B > lib.zinb_fwd_max_rows():
        raise ValueError(f"B={B} rows exceed one launch's grid")
    _check_width(F, int(lib.zinb_fwd_max_f(int(dtype == torch.bfloat16))),
                 dtype, "the row pass's resident (64, F) tile of h")
    n_part = int(lib.zinb_fwd_workspace(int(dtype == torch.bfloat16),
                                        A, B, F, D))
    if n_part < 0:
        raise ValueError(f"zinb_fwd refuses the shape A={A}, B={B}, F={F}, "
                         f"D={D}")
    part = torch.empty(n_part, device=h.device, dtype=torch.float32)
    out = torch.empty((A,), device=h.device, dtype=torch.float32)
    fn = lib.zinb_fwd_f32 if dtype == torch.float32 else lib.zinb_fwd_bf16
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, part.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zinb_fwd kernel launch failed: CUDA error {err}")
    fused_zinb.launches += 1
    return out


def fused_zinb(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps: float = 1e-6):
    """Per-arm ZINB loss sum of the three decoder heads against x.

    With grad enabled and any of h and the heads requiring it, the
    training form (``zinb_fwdbwd`` inside an autograd function); otherwise
    the value-only forward.

    Args:
      h: (A, B, F) decoder pre-output hidden.  w_*: (A, F, D), b_*: (A, D):
        the rate, success-probability and zero-inflation heads.
      x: (B, D) shared or (A, B, D) per-arm log1p targets; it gets no
        gradient.  eps as in ``models/losses.zinb_loss``.

    Returns (A,) f32; divide by B·D for the elementwise mean.
    """
    tensors = (h, w_r, b_r, w_p, b_p, w_z, b_z)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedZINB.apply(*tensors, x, eps)
    return _zinb_value(*tensors, x, eps)


fused_zinb.launches = 0


def zinb_fwdbwd(h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps: float = 1e-6):
    """(loss (A,), dh (A,B,F), (dW_r, db_r), (dW_p, db_p), (dW_z, db_z)),
    all f32, the gradients of Σ_a loss_a unscaled, in one call: the training
    kernel on CUDA tensors, ``zinb_grads_plain`` on CPU tensors."""
    tensors = (h, w_r, b_r, w_p, b_p, w_z, b_z, x)
    A, B, F, D = _check_shapes(*tensors)
    if on_cpu(*tensors):
        return zinb_grads_plain(*tensors, eps)
    dtype, args = _kernel_args(tensors, A, B, F, D, eps)
    lib = _lib_fwdbwd()
    dev = h.device
    loss = torch.empty((A,), device=dev, dtype=torch.float32)
    work, dh, dw, db = _grad_buffers(lib, dtype, A, B, F, D, dev)
    fn = (lib.zinb_fwdbwd_f32 if dtype == torch.float32
          else lib.zinb_fwdbwd_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, work.data_ptr(), loss.data_ptr(), dh.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"zinb_fwdbwd kernel launch failed: CUDA error {err}")
    zinb_fwdbwd.launches += 1
    zinb_fwdbwd.wgmma_launches += 1
    return loss, dh, (dw[0], db[0]), (dw[1], db[1]), (dw[2], db[2])


zinb_fwdbwd.launches = 0
zinb_fwdbwd.wgmma_launches = 0   # of the column pass on wgmma


def zinb_bwd(g, h, heads, x, eps: float = 1e-6):
    """(dh, (dW_r, db_r), (dW_p, db_p), (dW_z, db_z)), all f32, for the
    per-arm cotangent ``g`` (A,) of the loss sums, with the forward
    recomputed: the separate backward kernel on CUDA tensors,
    ``zinb_bwd_plain`` on CPU tensors.  ``heads`` is ((w_r, b_r),
    (w_p, b_p), (w_z, b_z))."""
    (w_r, b_r), (w_p, b_p), (w_z, b_z) = heads
    tensors = (h, w_r, b_r, w_p, b_p, w_z, b_z, x)
    A, B, F, D = _check_shapes(*tensors)
    if tuple(g.shape) != (A,):
        raise ValueError(f"g {tuple(g.shape)} is not ({A},)")
    if on_cpu(g, *tensors):
        return zinb_bwd_plain(g, h, heads, x, eps)
    dtype, args = _kernel_args(tensors, A, B, F, D, eps)
    lib = _lib_fwdbwd()
    dev = h.device
    g32 = g.float().contiguous()
    work, dh, dw, db = _grad_buffers(lib, dtype, A, B, F, D, dev)
    fn = lib.zinb_bwd_f32 if dtype == torch.float32 else lib.zinb_bwd_bf16
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(g32.data_ptr(), *args, work.data_ptr(), dh.data_ptr(),
                 dw.data_ptr(), db.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"zinb_bwd kernel launch failed: CUDA error {err}")
    zinb_bwd.launches += 1
    zinb_bwd.wgmma_launches += 1
    return dh, (dw[0], db[0]), (dw[1], db[1]), (dw[2], db[2])


zinb_bwd.launches = 0
zinb_bwd.wgmma_launches = 0


class _FusedZINB(torch.autograd.Function):
    """The fused training op: forward = ``zinb_fwdbwd``; backward scales
    the stashed gradients by the per-arm cotangent, cast to the primals'
    dtypes.  ``x`` gets no gradient."""

    @staticmethod
    def forward(ctx, h, w_r, b_r, w_p, b_p, w_z, b_z, x, eps):
        loss, dh, gr, gp, gz = zinb_fwdbwd(h, w_r, b_r, w_p, b_p, w_z, b_z,
                                           x, eps)
        ctx.save_for_backward(dh, *gr, *gp, *gz)
        ctx.dtypes = tuple(t.dtype for t in (h, w_r, b_r, w_p, b_p, w_z, b_z))
        return loss

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 9
        ga = g.float()
        # scaled in place: the stash is used once
        grads = tuple(
            t.mul_(ga.reshape((-1,) + (1,) * (t.dim() - 1))).to(dt)
            for t, dt in zip(ctx.saved_tensors, ctx.dtypes))
        return (*grads, None, None)
