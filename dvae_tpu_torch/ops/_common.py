"""Shared helpers of the port's kernel wrappers: the argument checks every
wrapper makes before it hands pointers to a kernel."""

from __future__ import annotations

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
