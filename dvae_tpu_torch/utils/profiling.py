"""Profiling, tracing and memory observability of the PyTorch port.

Counterpart of dvae_tpu/utils/profiling.py (the reference's profiling kit,
dist/fsdp.py:44-80 and fsdp_mnist.py:401-452):
  * ``profile_run`` — ``torch.profiler`` around a block, written as a
    Chrome trace (``*.pt.trace.json``) under ``trace_dir``;
  * ``span`` — the program's own named ranges (``dvae.*``) at its layer
    boundaries, recorded by that profiler on the clock of its kernels;
    ``spanned``, the same around every call of a function;
  * ``trace_total_device_ms`` — the device time of such traces (kernels,
    copies, memsets); it takes the place of the JAX package's XProf
    readers (``xplane_total_device_ms``, ``op_profile_total_ps``), whose
    files torch never writes;
  * ``memory_snapshot`` — ``torch.cuda.memory_stats`` of every card (JSON);
  * ``StepTimer`` — wall-clock steps that wait for the card.

Tracing a run: wrap the calls in ``profile_run`` and open the written
trace in Perfetto (ui.perfetto.dev, "Open trace file")::

    with profile_run("profiles/"):
        model.train(x_train, x_val, n_epoch=10)   # or model.eval_model(x)

Beside the kernels, the host row then shows the span tree:

  * training: ``dvae.runner`` (one chunk of epochs) → ``dvae.step`` (the
    host's enqueue of one step) → ``dvae.step.augment`` (with a frozen
    augmenter only: its per-arm views of the batch), ``dvae.step.forward``,
    ``dvae.step.backward`` (autograd), ``dvae.step.update`` (gradient
    mask, Adam, parameter mask); ``dvae.runner.epoch_end`` (the epoch's
    consensus and metrics); ``dvae.validate``; ``dvae.checkpoint``;
  * eval (``validate``, ``eval_model``, ``_predict_labels``):
    ``dvae.eval`` (one ``eval_model`` call) → ``dvae.eval.batch`` (the
    enqueue of a chunk or batch; with a frozen augmenter it holds
    ``dvae.eval.augment``, each batch's views), ``dvae.eval.drain`` (a
    device→host read of results: the wait for the card and the copy),
    ``dvae.eval.finish`` (host work after the last read).

A gap in the device row lies inside the spans that held the host then.
Without an active profiler ``span`` returns one shared null context:
no flag turns the spans on, and they never touch the card.
"""

from __future__ import annotations

import contextlib
import functools
import glob
import json
import os
import socket
import time
from typing import Optional

import numpy as np
import torch

# Chrome-trace categories of the work a card does (Kineto's names); runtime
# calls, CPU operators and gpu_user_annotation ranges (which enclose
# kernels) are not device time
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "dvae."
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A range ``dvae.<name>`` of the active ``torch.profiler`` (the test
    torch itself makes, ``torch.autograd._profiler_enabled``); without
    one, the same null context on every call, which costs a function call
    and that test.  It touches no tensor and never synchronises."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


def spanned(name: str):
    """A decorator: every call of the function runs inside ``span(name)``
    (the span for a whole call; ``with span(...)`` marks a part of one)."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class TraceDir(str):
    """The trace directory ``profile_run`` yields: a ``str`` equal to
    ``trace_dir`` that also carries the ``torch.profiler.profile`` of the
    block (``.profiler``), whose ``key_averages()`` read the same run."""

    profiler = None


@contextlib.contextmanager
def profile_run(trace_dir: str = "profiles/",
                create_perfetto_link: bool = False):
    """Trace everything inside the block with ``torch.profiler`` (CPU
    activity, plus CUDA where a card is present) and write one Chrome trace
    into ``trace_dir`` when the block ends; yields ``trace_dir``.

    ``create_perfetto_link``: JAX serves the trace to a Perfetto link.
    Nothing here touches a network: a Chrome trace opens in Perfetto
    (ui.perfetto.dev → "Open trace file") as it is, so True prints the
    written file's path with that instruction."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(trace_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = TraceDir(trace_dir)
    with profile(activities=activities) as prof:
        out.profiler = prof
        yield out
    path = os.path.join(trace_dir, f"{socket.gethostname()}_{os.getpid()}."
                                   f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if create_perfetto_link:
        print(f"trace written to {path}; open it in Perfetto "
              "(ui.perfetto.dev, 'Open trace file')", flush=True)


def trace_total_device_ms(trace_dir: str) -> float:
    """Total device time (ms) of the Chrome traces under ``trace_dir``: the
    sum of the ``dur`` of every kernel, memcpy and memset event in the
    ``*.pt.trace.json`` files, recursively.  0.0 for traces without device
    events (a CPU run); ``FileNotFoundError`` when there is no trace.  It
    reads what ``key_averages()``'s device self times sum over the same
    profile once its user annotations are left out: a ``record_function``
    range (``span``) is a CUDA row there whose self time is the whole
    range, as torch's own table knows (``is_user_annotation``)."""
    files = glob.glob(os.path.join(trace_dir, "**", "*.pt.trace.json"),
                      recursive=True)
    if not files:
        raise FileNotFoundError(f"no .pt.trace.json under {trace_dir}")
    total_us = 0.0
    for path in sorted(files):
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        total_us += sum(float(e.get("dur", 0.0)) for e in events
                        if e.get("ph") == "X"
                        and e.get("cat") in DEVICE_CATEGORIES)
    return total_us / 1e3


def memory_snapshot(path: Optional[str] = None) -> dict:
    """``torch.cuda.memory_stats`` of every card, keyed ``"cuda:0"``, …;
    ``{"cpu": {}}`` without a card.  Dumped to JSON when ``path`` is
    given (the CUDA memory-history analogue, dist/fsdp.py:44-51)."""
    if torch.cuda.is_available():
        snap = {f"cuda:{i}": dict(torch.cuda.memory_stats(i))
                for i in range(torch.cuda.device_count())}
    else:
        snap = {"cpu": {}}
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(snap, f, indent=2, default=int)
    return snap


def _first_tensor(tree):
    """The first tensor leaf of nested dicts (keys sorted, as JAX orders
    them), lists and tuples; None when there is none."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


class StepTimer:
    """Wall-clock step timing with a wait for the card (the reference's
    paired CUDA events, fsdp_mnist.py:401-452): ``stop(sync_on=tree)``
    synchronises the device of the tree's first tensor before it reads the
    clock."""

    def __init__(self):
        self.times: list[float] = []
        self._t0: Optional[float] = None

    @staticmethod
    def sync(x) -> None:
        """Wait for the device of ``x``'s first tensor leaf: a CUDA tensor's
        card is synchronised; CPU tensors and empty trees need nothing."""
        t = _first_tensor(x)
        if t is not None and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, sync_on=None) -> float:
        if sync_on is not None:
            self.sync(sync_on)
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return float(np.mean(self.times)) if self.times else 0.0

    def summary(self) -> dict:
        t = np.asarray(self.times)
        if len(t) == 0:
            return {}
        return {"mean_s": float(t.mean()), "p50_s": float(np.median(t)),
                "p95_s": float(np.percentile(t, 95)), "n": len(t)}
