"""Host wall time (ms) inside ``dvae.eval.drain`` spans per 1,000 cells
served in the profiled requests: ``eval_model``'s reads of its results,
the wait for the card and the copies into numpy (beside
``result_copy_ms.serve``, the copies' device time)."""

from portbench.core import spans
from portbench.core.trace import merge


def read(r):
    cells = r.host.get("slice_served_cells", 0)
    sl = spans.device_slice(r)
    if sl is None or cells <= 0:
        return None
    drains = spans.intervals(sl, "eval.drain")
    if not drains:
        return None
    return spans.total(merge(drains)) / 1e3 / (cells / 1e3)
