"""Share (%) of the profiled serving slice's wall time in which no
kernel, copy or memset runs on the card (the union of their intervals)."""


def read(r):
    if r.slice is None or r.slice.window_s <= 0 or not r.slice.device:
        return None
    return 100.0 * (1.0 - r.slice.busy_s() / r.slice.window_s)
