"""Roofline share (%) of the MSE output layer and loss, forward and
backward, in training (``ops/recon.py`` → ``csrc/recon_fwdbwd.cu``: its
row and column passes, reductions and copies)."""

from portbench.core import roofline, work

KERNELS = ("recon_rows", "recon_cols", "recon_dh_reduce",
           "recon_loss_reduce", "quiet_copy")
PHASE = "train"
WORK = work.recon_train


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, WORK)
