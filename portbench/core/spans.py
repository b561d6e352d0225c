"""The program's own spans in a profiled slice, and the device's idle time
inside them.

The program marks its layer boundaries with ranges of the profiler that
records the device's work (``dvae_tpu_torch/utils/profiling.span``:
``dvae.runner``, ``dvae.step``, ``dvae.validate``, ``dvae.eval.drain``,
...), so they share the clock of the slice's kernels, copies and
memsets.  "Idle inside X" is the slice's wall time in which the host is
inside a span X (and outside every excluded span) while nothing runs on
the device.  A program that marks no such span, or a slice without a
device trace (a CPU run), gives ``None``: the metric is left out of the
line.  Times in µs as the trace has them.
"""

from __future__ import annotations

from typing import Optional

from portbench.core.trace import merge

PREFIX = "dvae."


def device_slice(r):
    """The profiled slice of a metric's readings ``r`` where it holds a
    device trace, else None."""
    sl = r.slice
    if sl is None or sl.t1 <= sl.t0 or not sl.device:
        return None
    return sl


def intervals(sl, name: str) -> list:
    """[(start, end)] of every span ``dvae.<name>`` of the slice's host,
    clipped to the slice's window (a span outside it is left out), by
    start."""
    full = PREFIX + name
    out = []
    for e in sl.events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name") == full):
            s = max(float(e["ts"]), sl.t0)
            t = min(float(e["ts"]) + float(e.get("dur", 0.0)), sl.t1)
            if t > s:
                out.append((s, t))
    return sorted(out)


def subtract(a: list, b: list) -> list:
    """The parts of the disjoint sorted intervals ``a`` outside the
    disjoint sorted intervals ``b``."""
    out, j = [], 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            if b[k][0] > s:
                out.append((s, b[k][0]))
            s = max(s, b[k][1])
            k += 1
        if e > s:
            out.append((s, e))
    return out


def total(ivs: list) -> float:
    return sum(e - s for s, e in ivs)


def idle_inside(sl, names, exclude=()) -> Optional[float]:
    """µs of the window inside a span of ``names``, outside every span of
    ``exclude``, with no kernel, copy or memset running; None when the
    slice holds no span of ``names``."""
    inside = merge(iv for n in names for iv in intervals(sl, n))
    if not inside:
        return None
    region = subtract(inside, merge(iv for n in exclude
                                    for iv in intervals(sl, n)))
    busy = merge((d["ts"], d["ts"] + d["dur"]) for d in sl.device)
    return total(subtract(region, busy))


def idle_share(r, names, exclude=()) -> Optional[float]:
    """``idle_inside`` as a % of the slice's window, from a metric's
    readings ``r``; None without a device trace."""
    sl = device_slice(r)
    if sl is None:
        return None
    idle = idle_inside(sl, names, exclude)
    return None if idle is None else 100.0 * idle / (sl.t1 - sl.t0)
