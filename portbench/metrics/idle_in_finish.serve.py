"""Share (%) of the profiled requests' window in which the host is inside
``dvae.eval.finish`` (``eval_model``'s host work after its last read:
weighted averages, the consensus of the labels) and nothing runs on the
card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["eval.finish"])
