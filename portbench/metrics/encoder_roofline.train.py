"""Roofline share (%) of the fused dropout + fc1 kernels in training
(``ops/encoder.py`` → ``csrc/encoder_fc1.cu``): fc1's forward and its
weight gradient, a call each a step."""

from portbench.core import roofline, work

KERNELS = ("encoder_fwd_tiles", "encoder_bwd_tiles")
PHASE = "train"
WORK = work.encoder_fc1


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, WORK)
