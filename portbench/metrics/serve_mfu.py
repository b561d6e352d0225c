"""Model operations of the eval forward (loss included) of every cell
served in the window (``core/work.py``) over the window's wall time and
the card's peak for the configuration's dtype, in %.  The same clock as
``serve_cells_per_s``."""

from portbench.core import roofline, work


def read(r):
    cells = r.host.get("served_cells", 0)
    if cells <= 0:
        return None
    return roofline.mfu_pct(work.eval_flops(r.model, cells),
                            r.host["window_s"], r.dtype)
