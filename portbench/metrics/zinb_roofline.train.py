"""Roofline share (%) of the three ZINB heads and their loss, forward and
backward, in training (``ops/zinb.py`` → ``csrc/zinb_fwdbwd.cu``: its row
and column passes and reductions)."""

from portbench.core import roofline, work

KERNELS = ("zinb_rows", "zinb_cols", "zinb_dh_reduce", "zinb_loss_reduce")
PHASE = "train"
WORK = work.zinb_train


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, WORK)
