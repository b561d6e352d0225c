"""Model operations of the training window's steps (every product's
forward, weight gradient and input gradient once, ``core/work.py``) over
the window's wall time and the card's peak for the configuration's dtype
(``core/roofline.py``), in %.  The same clock as ``train_cells_per_s``."""

from portbench.core import roofline, work


def read(r):
    steps = r.host.get("train_steps", 0)
    if steps <= 0:
        return None
    flops = steps * work.train_step_flops(r.model, r.host["batch"])
    return roofline.mfu_pct(flops, r.host["window_s"], r.dtype)
