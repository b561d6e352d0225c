"""Peaks of the card and the roofline share of a kernel's work.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no
sparsity), at its full power limit of 700 W.  A configuration in float32
counts against the tensor cores' TF32 rate: the port's f32 kernels and a
TF32 product both run there, and a share of the FP32-core rate would read
above 100% for them.
"""

from __future__ import annotations

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(calls, dtype: str) -> float:
    """Least time of a list of calls, each (operations, bytes): per call
    the larger of operations over the peak and bytes over the bandwidth."""
    peak = PEAK_FLOPS[dtype]
    return sum(max(f / peak, b / HBM_BYTES_PER_S) for f, b in calls)


def share_pct(bound: float, measured: float):
    """``bound`` over ``measured`` seconds in percent; None (no reading)
    when nothing was measured."""
    if measured <= 0 or bound <= 0:
        return None
    return 100.0 * bound / measured


def kernel_share(readings, kernels, phase: str, work_fn):
    """Roofline share (%) of the kernels whose names hold one of
    ``kernels``, launched in ``phase`` of the profiled slice: the bound of
    ``work_fn(model, rows, bytes an element)`` over every call's rows (the
    slice's ``calls[phase]``) over their device time.  None without a
    profiled slice, calls or kernel time."""
    calls = readings.calls.get(phase)
    if readings.slice is None or not calls:
        return None
    nbytes = DTYPE_BYTES[readings.dtype]
    bound = sum(bound_s(work_fn(readings.model, rows, nbytes),
                        readings.dtype) for rows in calls)
    return share_pct(bound, readings.slice.time_s(kernels, phase))


def mfu_pct(flops: float, seconds: float, dtype: str):
    """Model operations over seconds, as a share (%) of the peak."""
    if seconds <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (seconds * PEAK_FLOPS[dtype])
