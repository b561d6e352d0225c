"""Roofline share (%) of the three ZINB heads and their loss, forward
only, in serving (``ops/zinb.py`` → ``csrc/zinb_fwd.cu``: the row pass and
the loss reduction), over every batch of the profiled requests."""

from portbench.core import roofline, work

KERNELS = ("zinb_rows", "zinb_loss_reduce")
PHASE = "request"
WORK = work.zinb_serve


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, WORK)
