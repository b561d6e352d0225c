"""Share (%) of the profiled training slice's window in which the host is
inside ``dvae.runner`` (one chunk of the epoch runner) but outside every
``dvae.step``: permutations, batch gathers, the host draws, the epoch's
consensus and metrics, with nothing running on the card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["runner"], exclude=["step"])
