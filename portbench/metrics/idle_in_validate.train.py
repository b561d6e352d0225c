"""Share (%) of the profiled training slice's window in which the host is
inside ``dvae.validate`` (the orchestrator's validation: its batches,
reads and consensus) and nothing runs on the card."""

from portbench.core import spans


def read(r):
    return spans.idle_share(r, ["validate"])
