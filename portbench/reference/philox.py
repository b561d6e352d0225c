"""Philox4x32-10 and the fused encoder's dropout mask.

The program's fused dropout+fc1 kernel keeps element (arm, row, col) of x
when the 31 low bits of word ``col % 4`` of Philox4x32-10 at counter
(col / 4, row, arm, 0) under key (seed, 0x5EED0001) fall below
``(1 − rate)·2³¹`` (Salmon et al., "Parallel random numbers: as easy as 1,
2, 3", SC 2011, for the generator; the counter layout and the key's second
word are the kernel's).  ``keep_mask`` works the mask out on any device
with 64-bit integer arithmetic: a 32 × 32-bit product is taken in 16-bit
halves so that no intermediate leaves the signed 64-bit range.
``keep_mask_numpy`` is the same in numpy, for tests.
"""

from __future__ import annotations

import numpy as np
import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
KEY1 = 0x5EED0001
MASK32 = 0xFFFFFFFF


def keep_threshold(rate: float) -> int:
    return min(int((1.0 - rate) * (1 << 31)), (1 << 31) - 1)


def _mulhilo(m: int, c: torch.Tensor):
    """(high, low) 32-bit words of m·c for 32-bit c in an int64 tensor."""
    a = m * (c >> 16)              # < 2**48
    b = m * (c & 0xFFFF)           # < 2**48
    hi = (a + (b >> 16)) >> 16
    lo = (((a & 0xFFFF) << 16) + b) & MASK32
    return hi, lo


def philox(c0, c1, c2, c3, k0: int, k1: int = KEY1):
    """The four output words of Philox4x32-10 at counters (c0..c3), int64
    tensors of 32-bit words, under key (k0, k1)."""
    ka, kb = k0 & MASK32, k1 & MASK32
    for r in range(10):
        if r:
            ka = (ka + W0) & MASK32
            kb = (kb + W1) & MASK32
        h0, l0 = _mulhilo(M0, c0)
        h1, l1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = h1 ^ c1 ^ ka, l1, h0 ^ c3 ^ kb, l0
    return c0, c1, c2, c3


def keep_mask(seed: int, shape, rate: float, device) -> torch.Tensor:
    """The (A, B, D) bool keep-mask the kernel draws for ``seed``."""
    A, B, D = shape
    n4 = -(-D // 4)
    thr = keep_threshold(rate)
    out = torch.empty((A, B, D), dtype=torch.bool, device=device)
    col4 = torch.arange(n4, device=device, dtype=torch.int64)[None, :]
    row = torch.arange(B, device=device, dtype=torch.int64)[:, None]
    c0 = col4.expand(B, n4)
    c1 = row.expand(B, n4)
    zero = torch.zeros((B, n4), dtype=torch.int64, device=device)
    for a in range(A):
        words = philox(c0, c1, zero + a, zero, int(seed))
        keep = torch.stack([(w & 0x7FFFFFFF) < thr for w in words], dim=-1)
        out[a] = keep.reshape(B, 4 * n4)[:, :D]
    return out


def keep_mask_numpy(seed: int, shape, rate: float) -> np.ndarray:
    """``keep_mask`` in numpy (uint64 products are exact for 32-bit words)."""
    A, B, D = shape
    n4 = -(-D // 4)
    arm, row, col4 = np.meshgrid(np.arange(A, dtype=np.uint64),
                                 np.arange(B, dtype=np.uint64),
                                 np.arange(n4, dtype=np.uint64), indexing="ij")
    c0, c1, c2, c3 = col4, row, arm, np.zeros_like(col4)
    m32 = np.uint64(MASK32)
    ka, kb = np.uint64(int(seed) & MASK32), np.uint64(KEY1)
    for r in range(10):
        if r:
            ka = (ka + np.uint64(W0)) & m32
            kb = (kb + np.uint64(W1)) & m32
        p0 = np.uint64(M0) * c0
        p1 = np.uint64(M1) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ ka, p1 & m32,
                          (p0 >> np.uint64(32)) ^ c3 ^ kb, p0 & m32)
    thr = np.uint64(keep_threshold(rate))
    keep = np.stack([(w & np.uint64(0x7FFFFFFF)) < thr
                     for w in (c0, c1, c2, c3)], -1)
    return keep.reshape(A, B, 4 * n4)[:, :, :D]
