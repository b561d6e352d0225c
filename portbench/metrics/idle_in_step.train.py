"""Share (%) of the profiled training slice's window in which the host is
inside a ``dvae.step`` span (the enqueue of a step: forward, autograd,
Adam) and nothing runs on the card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["step"])
