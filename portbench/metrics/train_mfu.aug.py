"""Model operations of the training window's steps over the window's wall
time and the card's peak for the configuration's dtype, in %: the VAE's
step (``core/work.py``: every product's forward, weight gradient and input
gradient once) and the frozen augmenter's forward
(``metrics/augment_roofline.train.aug.py``).  The same clock as
``train_cells_per_s``."""

from portbench.core import roofline, spec, work

AUG = spec.metric_reader("augment_roofline.train.aug")


def read(r):
    steps = r.host.get("train_steps", 0)
    if steps <= 0:
        return None
    B = r.host["batch"]
    flops = steps * (work.train_step_flops(r.model, B)
                     + AUG.forward_flops(r.model, B))
    return roofline.mfu_pct(flops, r.host["window_s"], r.dtype)
