"""Shared helpers of the port's kernel wrappers: the argument checks every
wrapper makes before it hands pointers to a kernel, and the numpy twin of
the kernels' counter-based random bits (``csrc/philox.cuh``)."""

from __future__ import annotations

import numpy as np
import torch

KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (the wrapper then runs the
    plain version); False when every tensor lies on one CUDA device.
    Anything else raises: a wrapper never moves data between devices."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def check_kernel_operands(names, tensors) -> torch.dtype:
    """One dtype among KERNEL_DTYPES for all operands, each contiguous."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or next(iter(dtypes)) not in KERNEL_DTYPES:
        raise ValueError(
            f"operands {names} need one dtype among {KERNEL_DTYPES}, got "
            f"{[t.dtype for t in tensors]}")
    for name, t in zip(names, tensors):
        if not t.is_contiguous():
            raise ValueError(f"operand {name} is not contiguous")
    return dtypes.pop()


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 on uint64 numpy arrays holding 32-bit words (the
    products of two 32-bit words are exact in 64 bits): the four output
    words of counter (c0, c1, c2, c3) under key (k0, k1)."""
    m32 = np.uint64(0xFFFFFFFF)
    ka, kb = np.uint64(k0), np.uint64(k1)
    for r in range(10):
        if r:
            ka = (ka + np.uint64(0x9E3779B9)) & m32
            kb = (kb + np.uint64(0xBB67AE85)) & m32
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = ((p1 >> np.uint64(32)) ^ c1 ^ ka, p1 & m32,
                          (p0 >> np.uint64(32)) ^ c3 ^ kb, p0 & m32)
    return c0, c1, c2, c3
