"""Roofline share (%) of the MSE output layer and loss, forward and
backward, in the augmented cell (``ops/recon.py`` →
``csrc/recon_fwdbwd.cu``): their per-arm-target branch, in which each arm
is compared with its own view.  The work is ``core/work.recon_train``'s
with the target read once per arm, (A, B, D)."""

from portbench.core import roofline, work

KERNELS = ("recon_rows", "recon_cols", "recon_dh_reduce",
           "recon_loss_reduce", "quiet_copy")
PHASE = "train"


def per_arm_target(m: dict, rows: int, nbytes: int) -> list:
    more = (m["n_arm"] - 1) * rows * m["input_dim"] * nbytes
    return [(f, b + more) for f, b in work.recon_train(m, rows, nbytes)]


def read(r):
    return roofline.kernel_share(r, KERNELS, PHASE, per_arm_target)
