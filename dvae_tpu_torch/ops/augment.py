"""The frozen augmenter's fused linear layer: one kernel for

    Y = relu(((X W + b) − mean) · rsqrt(var + eps)) [· (mask > 0)]

with the batch norm on its running statistics (the augmenter is frozen).
That is every layer the augmenter routes here: fc1–fc11, each a ReLU
after a batch norm without affine parameters (fc11 after none).
It replaces no TPU kernel: the JAX package leaves the augmenter's products
to XLA.  ``csrc/augment_fc.cu`` (its source note states its bound and
design) carries it on Hopper's ``wgmma``: f32 as 3xTF32, bf16 as one bf16
product, f32 accumulation, the epilogue in the plain layer's order.
``augment/augmenter.augment_arms`` routes fc1–fc11 through ``augment_fc``
on CUDA tensors; ``augment_fc.launches`` counts its launches.

The kernel reads W in a layout the wrapper prepares once per weight
tensor (``prepare_weight``: K padded to the stage, N to the tile, tiles of
K-major core matrices, the K order of a stage permuted by ``k_order``, f32
split into tf32 halves by ``split_tf32``), cached on the tensor and its
version counter (``prepared``), so a weight changed in place is prepared
again.  It reads X through TMA, which needs rows on 16-byte boundaries:
``padded_rows`` allocates activations so, ``aligned_rows`` copies an input
that is not.

On CPU tensors ``augment_fc`` runs its plain version,
``augment_fc_reference``; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Optional

import torch

from dvae_tpu_torch.ops import _build
from dvae_tpu_torch.ops._common import KERNEL_DTYPES, on_cpu

BM, BN = 128, 128        # rows and columns of a tile
ROW_BYTES = 128          # bytes of K a stage (one swizzle row of X)
RUN_STAGES = {torch.float32: 1, torch.bfloat16: 4}   # stages a run of sums
_QNAN = 0x7FC00000

_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
              ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_longlong, ctypes.c_void_p])


def _lib() -> ctypes.CDLL:
    lib = _build.load("augment_fc")
    if not getattr(lib, "_dvae_bound", False):
        for fn in (lib.augment_fc_f32, lib.augment_fc_bf16):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.augment_fc_consts.argtypes = [ctypes.c_int,
                                          ctypes.POINTER(ctypes.c_longlong)]
        lib.augment_fc_consts.restype = ctypes.c_int
        lib._dvae_bound = True
    return lib


def kernel_consts(bf16: bool) -> dict:
    """The library's own constants (a check that this module's layout
    follows them): rows and columns of a tile, K a stage, stages, shared
    memory a block, row tiles a raster group, stages a run of sums."""
    out = (ctypes.c_longlong * 7)()
    _lib().augment_fc_consts(int(bf16), out)
    return dict(zip(("bm", "bn", "kt", "stages", "smem", "group_m", "run"),
                    out))


# ---------------------------------------------------------------------------
# The weight layout
# ---------------------------------------------------------------------------

def k_tile(dtype: torch.dtype) -> int:
    """K a stage: one 128-byte row of X (32 f32, 64 bf16)."""
    return ROW_BYTES * 8 // torch.finfo(dtype).bits


def k_order(dtype: torch.dtype) -> list:
    """The column of a stage (of X, and of W's rows) at each K position of
    the kernel's products.  f32 k step s (8 positions) takes columns
    8 t + 2 s for slot t < 4 and 8 t + 2 s + 1 for slot t + 4; bf16 k step
    s (16) columns 16 t + 4 s + {0, 1} for slots 2 t, 2 t + 1 and
    16 t + 4 s + {2, 3} for slots 2 t + 8, 2 t + 9.  So the A fragment of
    the thread with t = lane % 4 comes from columns 8 t .. 8 t + 7 (f32) or
    16 t .. 16 t + 15 (bf16) of its rows, for every k step of the stage."""
    if dtype == torch.float32:
        return [8 * (j % 4) + 2 * s + j // 4
                for s in range(4) for j in range(8)]
    return [16 * ((j % 8) // 2) + 4 * s + 2 * (j // 8) + j % 2
            for s in range(4) for j in range(16)]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to tf32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna`` and ``csrc/mma.cuh`` ``tf32_bits`` do;
    every NaN becomes the quiet NaN 0x7FC00000 first, which the rounding
    keeps."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = torch.where(torch.isnan(x), torch.full_like(bits, _QNAN), bits)
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 1 << 31, bits - (1 << 32), bits)
    return bits.to(torch.int32).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """(hi, lo), both tf32 values in f32: hi = x rounded, lo = the rest
    rounded; hi + lo is x within 2^-22 of |x|, and both are NaN where x is
    (either encoding)."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def prepare_weight(w: torch.Tensor) -> torch.Tensor:
    """W (K, N) as the kernel reads it, one flat tensor on W's device:
    K padded with zeros to whole stages (``k_tile``), N to whole tiles of
    128 columns; tile (column tile j, stage c) at ((j · stages + c) ·
    planes) · 128 · KT, each plane's element (n, k) at ((n // 8) (KT / E) +
    k // E) 8 + n % 8) E + k % E (core matrices of 8 rows × 16 bytes,
    K-major; E values a 16-byte run), holding W[KT c + k_order[k], 128 j +
    n]; f32 as the planes hi, lo of ``split_tf32``, bf16 as it is."""
    if w.dim() != 2 or w.dtype not in KERNEL_DTYPES:
        raise ValueError(f"w {tuple(w.shape)} {w.dtype}: expected (K, N) in "
                         f"one of {KERNEL_DTYPES}")
    K, N = w.shape
    kt = k_tile(w.dtype)
    nk, nt = -(-K // kt), -(-N // BN)
    order = (torch.arange(nk, device=w.device)[:, None] * kt
             + torch.tensor(k_order(w.dtype), device=w.device)[None, :])
    wp = torch.zeros((nk * kt, nt * BN), dtype=w.dtype, device=w.device)
    wp[:K, :N] = w
    wl = wp.index_select(0, order.reshape(-1))
    planes = (torch.stack(split_tf32(wl)) if w.dtype == torch.float32
              else wl[None])
    e = 16 // w.element_size()
    tiles = planes.view(planes.shape[0], nk, kt // e, e, nt, BN // 8, 8)
    return tiles.permute(4, 1, 0, 5, 2, 6, 3).contiguous().view(-1)


_CACHE: dict = {}


def _cached(t: torch.Tensor, key, make):
    """``make()``, kept until ``t`` dies or changes: its version counter,
    storage, shape or dtype."""
    k = (id(t), key)
    sig = (t._version, t.data_ptr(), tuple(t.shape), t.dtype)
    hit = _CACHE.get(k)
    if hit is not None and hit[0]() is t and hit[1] == sig:
        return hit[2]
    value = make()
    _CACHE[k] = (weakref.ref(t, lambda _, k=k: _CACHE.pop(k, None)), sig,
                 value)
    return value


def prepared(w: torch.Tensor) -> torch.Tensor:
    """``prepare_weight(w)``, made once per weight tensor and version."""
    return _cached(w, "weight", lambda: prepare_weight(w))


def running_rstd(stats: dict, eps: float) -> torch.Tensor:
    """rsqrt(var + eps) of a batch norm's running variance, as ``_bn``
    computes it, made once per variance tensor and version."""
    var = stats["var"]
    return _cached(var, ("rstd", float(eps)), lambda: torch.rsqrt(var + eps))


# ---------------------------------------------------------------------------
# Activations the kernel reads
# ---------------------------------------------------------------------------

def padded_rows(rows: int, cols: int, dtype: torch.dtype,
                device) -> torch.Tensor:
    """An uninitialised (rows, cols) view whose rows start on 16-byte
    boundaries (the row stride rounded up)."""
    e = 128 // torch.finfo(dtype).bits
    ld = -(-cols // e) * e
    return torch.empty((rows, ld), dtype=dtype, device=device)[:, :cols]


def rows_aligned(x: torch.Tensor) -> bool:
    """Whether TMA can read the 2-D ``x``: unit column stride, base and
    row stride on 16 bytes."""
    e = x.element_size()
    return (x.stride(1) == 1 and x.data_ptr() % 16 == 0
            and (x.stride(0) * e) % 16 == 0 and x.stride(0) >= x.shape[1])


def aligned_rows(x: torch.Tensor) -> torch.Tensor:
    """The 2-D ``x`` itself if TMA can read it, else a copy whose rows
    start on 16-byte boundaries."""
    if rows_aligned(x):
        return x
    out = padded_rows(x.shape[0], x.shape[1], x.dtype, x.device)
    out.copy_(x)
    return out


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------

def _round_bf16(y: torch.Tensor) -> torch.Tensor:
    return y.to(torch.bfloat16).float()


def augment_fc_reference(x, w, b=None, stats=None, eps: float = 0.0,
                         mask=None) -> torch.Tensor:
    """Plain version of the kernel, in its order.  The product by runs of
    ``RUN_STAGES`` stages of ``k_tile`` columns (K padded with zeros to
    whole stages), each run's sum added to the total: f32 as the three
    tf32 products of ``split_tf32`` (the small ones, lo·hi + hi·lo, then
    hi·hi), bf16 as one product in f32.  Then the epilogue: + b, − mean, · rstd
    (``running_rstd``), ReLU, · (mask[row % len(mask)] > 0); bf16 rounded to bf16 after the product, the bias and
    the batch norm, as the plain bf16 layer rounds.  Returns (M, N) in x's
    dtype."""
    M, K = x.shape
    f32 = x.dtype == torch.float32
    kt = k_tile(x.dtype)
    nk = -(-K // kt)
    xp = torch.zeros((M, nk * kt), dtype=torch.float32, device=x.device)
    xp[:, :K] = x
    wp = torch.zeros((nk * kt, w.shape[1]), dtype=torch.float32,
                     device=w.device)
    wp[:K] = w
    if f32:
        (xh, xl), (wh, wl) = split_tf32(xp), split_tf32(wp)
    y = None
    step = kt * RUN_STAGES[x.dtype]
    for c in range(0, nk * kt, step):
        s = slice(c, c + step)
        if f32:
            run = (xl[:, s] @ wh[s] + xh[:, s] @ wl[s]) + xh[:, s] @ wh[s]
        else:
            run = xp[:, s] @ wp[s]
        y = run if y is None else y + run
    rnd = (lambda v: v) if f32 else _round_bf16
    y = rnd(y)
    if b is not None:
        y = rnd(y + b.float())
    if stats is not None:
        y = rnd((y - stats["mean"]) * running_rstd(stats, eps))
    y = torch.relu(y)
    if mask is not None:
        rows = torch.arange(M, device=x.device) % mask.shape[0]
        y = y * (mask[rows] > 0).to(y.dtype)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check_vector(name: str, t, n: int, dtype: torch.dtype) -> None:
    if t is not None and (tuple(t.shape) != (n,) or t.dtype != dtype
                          or not t.is_contiguous()):
        raise ValueError(f"{name} {tuple(t.shape)} {t.dtype}: expected a "
                         f"contiguous ({n},) {dtype} vector")


def augment_fc(x: torch.Tensor, w: torch.Tensor,
               b: Optional[torch.Tensor] = None,
               stats: Optional[dict] = None, eps: float = 0.0,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One fused layer of the frozen augmenter on rows ``x`` (M, K).

    Args:
      x: (M, K) activations, unit column stride; on CUDA with rows on
        16-byte boundaries (``aligned_rows``).
      w: (K, N) weight, x's dtype.  b: (N,) bias or None.
      stats: a batch norm's running statistics {"mean", "var"} (f32), or
        None for no batch norm; one with affine parameters is refused.
        eps: its epsilon.
      mask: (R, N) in x's dtype, or None: row r of the output is
        multiplied by (mask[r % R] > 0).

    Returns the (M, N) output, on CUDA in rows padded to 16 bytes
    (``padded_rows``), which the next layer's TMA reads as they are.  The
    kernel on CUDA tensors, the plain version on CPU tensors.
    """
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} are not "
                         "(M, K) and (K, N)")
    if stats is not None and "scale" in stats:
        raise ValueError("a batch norm with affine parameters: the kernel "
                         "applies the running statistics alone")
    M, K = x.shape
    N = w.shape[1]
    mean = var = None
    if stats is not None:
        mean, var = stats["mean"], stats["var"]
    if mask is not None and (mask.dim() != 2 or mask.shape[1] != N
                             or mask.stride(1) != 1 or mask.dtype != x.dtype):
        raise ValueError(f"mask {tuple(mask.shape)} {mask.dtype}: expected "
                         f"(R, {N}) {x.dtype} with unit column stride")
    given = [t for t in (x, w, b, mean, var, mask) if t is not None]
    if on_cpu(*given):
        return augment_fc_reference(x, w, b, stats, eps, mask)
    if x.dtype != w.dtype or x.dtype not in KERNEL_DTYPES:
        raise ValueError(f"x {x.dtype} and w {w.dtype}: expected one dtype "
                         f"among {KERNEL_DTYPES}")
    _check_vector("b", b, N, x.dtype)
    for name, t in (("mean", mean), ("var", var)):
        _check_vector(name, t, N, torch.float32)
    if not rows_aligned(x):
        raise ValueError("x's rows do not start on 16-byte boundaries "
                         "(aligned_rows)")
    wp = prepared(w)
    rstd = None if stats is None else running_rstd(stats, eps)
    out = padded_rows(M, N, x.dtype, x.device)
    lib = _lib()
    fn = lib.augment_fc_f32 if x.dtype == torch.float32 else lib.augment_fc_bf16
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), x.stride(0), M, K, wp.data_ptr(), N, _ptr(b),
                 _ptr(mean), _ptr(rstd), _ptr(mask), 0 if mask is None else mask.stride(0),
                 0 if mask is None else mask.shape[0], out.data_ptr(),
                 out.stride(0), stream)
    if err != 0:
        raise RuntimeError(f"augment_fc kernel launch failed: CUDA error {err}")
    augment_fc.launches += 1
    return out


augment_fc.launches = 0
