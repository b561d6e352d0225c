"""Share (%) of the profiled requests' window in which the host is inside
``dvae.eval.drain`` (a read of ``eval_model``'s results) and nothing runs
on the card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["eval.drain"])
