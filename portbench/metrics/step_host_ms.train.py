"""Mean wall time (ms) of a ``dvae.step`` span in the profiled training
slice: the host's enqueue of one training step (in a device-paced cell it
includes the waits on a full launch queue).  None where the program marks
no step, or without a device trace."""

from portbench.core import spans


def read(r):
    sl = spans.device_slice(r)
    if sl is None:
        return None
    steps = spans.intervals(sl, "step")
    if not steps:
        return None
    return spans.total(steps) / len(steps) / 1e3
