"""Roofline share (%) of the MSE output layer and loss, forward only, in
serving (``ops/recon.py`` → ``csrc/recon_fwd.cu``: prep, tiles,
reduction), over every batch of the profiled requests."""

from portbench.core import roofline, work

KERNELS = ("recon_fwd_prep", "recon_fwd_tiles", "recon_fwd_reduce")
PHASE = "request"
WORK = work.recon_serve


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, WORK)
