"""Roofline share (%) of the fused dropout + fc1 kernels in the augmented
cell (``ops/encoder.py`` → ``csrc/encoder_fc1.cu``): their per-arm-x
branch, in which each arm reads its own view.  The work is
``core/work.encoder_fc1``'s with x read once per arm, (A, B, D), in both
calls."""

from portbench.core import roofline, work

KERNELS = ("encoder_fwd_tiles", "encoder_bwd_tiles")
PHASE = "train"


def per_arm_x(m: dict, rows: int, nbytes: int) -> list:
    more = (m["n_arm"] - 1) * rows * m["input_dim"] * nbytes
    return [(f, b + more) for f, b in work.encoder_fc1(m, rows, nbytes)]


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, per_arm_x)
