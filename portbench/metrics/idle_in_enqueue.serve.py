"""Share (%) of the profiled requests' window in which the host is inside
``dvae.eval.batch`` (the enqueue of an eval chunk or batch) and nothing
runs on the card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["eval.batch"])
