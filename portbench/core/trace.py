"""The profiled slice of a traced run, reduced to what the per-layer
metrics read.

The benchmark marks what it drives with spans of its own
(``torch.profiler.record_function("portbench.<phase>")``); the device's
kernels, copies and memsets are attributed to the phase whose span holds
the host call that launched them (the trace's correlation ids link the
two).  The reduction is copied from ``dvae_tpu_torch/utils/profiling.py``
(Kineto's device categories) so that a later change to the program cannot
move the yardstick.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict

# Chrome-trace categories of the work a card does (Kineto's names)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# host-side categories; a launch through the CUDA runtime or driver API
# carries the correlation id of the device event it starts
LAUNCH_CATEGORIES = ("cuda_runtime", "cuda_driver")
HOST_CATEGORIES = ("cpu_op", "user_annotation") + LAUNCH_CATEGORIES
SPAN_PREFIX = "portbench."
SLICE = "slice"


def span(phase: str):
    """A span of the benchmark's own around one call into the program; a
    no-op outside a profile."""
    import torch
    return torch.profiler.record_function(SPAN_PREFIX + phase)


def short_name(name: str, limit: int = 100) -> str:
    """A kernel's name without its return type, namespaces and argument
    list, at most ``limit`` long."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    head = name.split("(", 1)[0].strip()
    return head[:limit]


def merge(intervals):
    """The union of (start, end) intervals, sorted and disjoint."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSlice:
    """Device events of one profiled slice, by phase.  Times in seconds."""

    def __init__(self, events: list):
        self.events = events
        spans = [e for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"
                 and str(e.get("name", "")).startswith(SPAN_PREFIX)]
        self.spans = [(e["name"][len(SPAN_PREFIX):], float(e["ts"]),
                       float(e["ts"]) + float(e.get("dur", 0.0)))
                      for e in spans]
        whole = [s for s in self.spans if s[0] == SLICE]
        self.t0, self.t1 = ((whole[0][1], whole[0][2]) if whole else
                            (min((s[1] for s in self.spans), default=0.0),
                             max((s[2] for s in self.spans), default=0.0)))
        launch = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = float(e["ts"])
        self.device = []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATEGORIES:
                continue
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            corr = (e.get("args") or {}).get("correlation")
            at = launch.get(corr, ts)
            self.device.append({"name": str(e.get("name", "")),
                                "cat": e["cat"], "ts": ts, "dur": dur,
                                "phase": self.phase_at(at)})

    def phase_at(self, ts: float) -> str:
        """The innermost benchmark span (other than the slice) holding
        host time ``ts``; ``"other"`` where none does."""
        best, width = "other", None
        for name, s, e in self.spans:
            if name != SLICE and s <= ts <= e and (width is None
                                                  or e - s < width):
                best, width = name, e - s
        return best

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def busy_s(self) -> float:
        """Seconds in which a kernel, copy or memset ran: the union."""
        return sum(e - s for s, e in merge(
            (d["ts"], d["ts"] + d["dur"]) for d in self.device)) / 1e6

    def events_in(self, phase=None, cats=DEVICE_CATEGORIES) -> list:
        return [d for d in self.device if d["cat"] in cats
                and (phase is None or d["phase"] == phase)]

    def time_s(self, patterns, phase=None, cats=("kernel",)) -> float:
        """Device seconds of the events whose name holds one of
        ``patterns``."""
        return sum(d["dur"] for d in self.events_in(phase, cats)
                   if any(p in d["name"] for p in patterns)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by = defaultdict(float)
        for d in self.device:
            by[short_name(d["name"])] += d["dur"] / 1e6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])
                ][:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest stretches of the slice with nothing on the device,
        each named by the innermost host event at its middle (none: the
        host ran Python between recorded operators) and by the benchmark
        phase there."""
        busy = merge((d["ts"], d["ts"] + d["dur"]) for d in self.device)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        host = [e for e in self.events if e.get("ph") == "X"
                and e.get("cat") in HOST_CATEGORIES
                and not str(e.get("name", "")).startswith(SPAN_PREFIX)]
        out = []
        for s, e in gaps[:n]:
            mid = 0.5 * (s + e)
            inner, width = "Python between ops", None
            for h in host:
                hs, hd = float(h["ts"]), float(h.get("dur", 0.0))
                if hs <= mid <= hs + hd and (width is None or hd < width):
                    inner, width = short_name(str(h["name"]), 60), hd
            out.append([f"{self.phase_at(mid)}: {inner}", (e - s) / 1e6])
        return out


@contextlib.contextmanager
def profiled():
    """Profile the block (host and device activity) inside a ``slice``
    span; yields a holder whose ``.slice`` is the ``TraceSlice`` once the
    block has ended.  The Chrome trace goes to a temporary directory under
    ``$TMPDIR`` and is removed after it is read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    class Holder:
        slice = None

    holder = Holder()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with span(SLICE):
            yield holder
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "slice.pt.trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    holder.slice = TraceSlice(events)
