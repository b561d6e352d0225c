"""What the program's spans (``utils/profiling.span``) cost, and where the
device's idle time of a benchmark cell lies among them.

    python3 scripts/trace_cost.py --cell mse-train-20k --seed 1234 \
        [--pairs 3] [--out trace_cost.json]

Run from the root of a checkout, on an NVIDIA GPU.

* Off: ns per ``span`` with no profiler active (enter and exit), beside a
  bare ``contextlib.nullcontext`` and an empty function call.
* On, per span: ns per ``span`` (a ``record_function`` range) under an
  active profiler of host and device, as the benchmark's slice has it;
  times the spans a step or a request that the slices below count.
* On, end to end: the cell's own profiled slice (``portbench/traffic``:
  a chunk of the window's runner and a validation, or the same
  ``trace_requests`` requests each time), in turns with the spans on and
  with ``span`` swapped for the null context in every module that holds
  ``profiling.span`` (on, off, off, on, ...) after one profiled slice of
  warm-up.  Each slice gives its window's ms a step or a request and its
  device idle share.
* Where the idle lies: for each slice with the spans on, every per-layer
  metric of the cell as its reader in ``portbench/metrics`` reads the
  slice, the share of the device's idle time inside some ``dvae.`` span,
  and the ten longest idle gaps as the benchmark names them.

Prints one JSON object and writes it to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
import timeit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.core.guard import environment  # noqa: E402

for _k, _v in environment().items():
    os.environ.setdefault(_k, _v)

import torch  # noqa: E402

import dvae_tpu_torch.train.cpl_mixvae  # noqa: E402,F401  (every span user)
from dvae_tpu_torch.utils import profiling  # noqa: E402
from portbench.core import harness, spans, spec, trace  # noqa: E402

NULL = contextlib.nullcontext()


def off_cost(n: int = 200_000) -> dict:
    """ns per call with no profiler active."""
    def spanned():
        with profiling.span("step"):
            pass

    def null():
        with NULL:
            pass

    def call():
        pass

    out = {}
    for name, fn in (("span", spanned), ("nullcontext", null),
                     ("call", call)):
        best = min(timeit.repeat(fn, number=n, repeat=5))
        out[name] = 1e9 * best / n
    return out


def on_cost(n: int = 20_000) -> dict:
    """ns per ``span`` under an active profiler of host and device (the
    ``record_function`` enter and exit, and its event), beside the null
    context under the same profiler."""
    from torch.profiler import ProfilerActivity, profile

    def spanned():
        with profiling.span("step"):
            pass

    def null():
        with NULL:
            pass

    out = {}
    for name, fn in (("span", spanned), ("nullcontext", null)):
        best = float("inf")
        for _ in range(5):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                best = min(best, timeit.timeit(fn, number=n))
        out[name] = 1e9 * best / n
    return out


@contextlib.contextmanager
def spans_off():
    """``span`` replaced by the null context in every loaded module that
    holds ``profiling.span`` (``profiling`` itself included, which the
    ``spanned`` decorator reads)."""
    real = profiling.span
    users = [m for m in list(sys.modules.values())
             if getattr(m, "span", None) is real]
    for m in users:
        m.span = lambda name: NULL
    try:
        yield
    finally:
        for m in users:
            m.span = real


def split(ctx, sl, host: dict, calls: dict) -> dict:
    """Every per-layer metric of the cell read from the slice by its own
    reader, the share (%) of the device's idle time that lies inside some
    ``dvae.`` span, the spans counted, and the benchmark's longest idle
    gaps."""
    r = harness.Readings(ctx.model, ctx.config["dtype"], host, sl, calls)
    out = {m["name"]: spec.metric_reader(m["name"]).read(r)
           for m in spec.per_layer_for(spec.benchmark(), ctx.cell["name"])}
    names = [str(e["name"]) for e in sl.events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(spans.PREFIX)]
    every = sorted({n[len(spans.PREFIX):] for n in names})
    inside = spans.idle_inside(sl, every) or 0.0
    busy = trace.merge((d["ts"], d["ts"] + d["dur"]) for d in sl.device)
    idle = spans.total(spans.subtract([(sl.t0, sl.t1)], busy))
    out["inside_share_of_idle"] = 100.0 * inside / idle if idle > 0 else 0
    out["spans"] = len(names)
    out["idle_gaps"] = sl.idle_gaps()
    return out


def train_slices(ctx, pairs: int) -> list:
    from portbench.traffic import train_resident as tr
    s = tr.setup(ctx)
    trainer, runner = s["trainer"], s["runner"]
    x_train, x_val = s["x_train"], s["x_val"]
    trainer.validate(x_val, trainer.temp)
    B = ctx.train["batch_size"]
    steps_per_epoch = x_train.shape[0] // B
    out = []
    for on in [None] + [True, False, False, True] * pairs:
        counts = {"epochs": 0}
        with (contextlib.nullcontext() if on is not False else spans_off()):
            with trace.profiled() as prof:
                tr._chunk(trainer, runner, x_train, trainer.temp, counts)
                with trace.span("validate"):
                    trainer.validate(x_val, trainer.temp)
        n = counts["epochs"] * steps_per_epoch
        sl = prof.slice
        if on is None:      # the first profile of the process: warm-up
            continue
        host = {"slice_train_steps": n, "batch": B}
        out.append({"spans": on, "ms_per_step": 1e3 * sl.window_s / n,
                    "units": n,
                    "device_idle": 100.0 * (1 - sl.busy_s() / sl.window_s),
                    **({"split": split(ctx, sl, host, {"train": [B] * n})}
                       if on else {})})
    return out


def serve_slices(ctx, pairs: int) -> list:
    from portbench.traffic import serve_closed_loop as sc
    p, B = ctx.params, ctx.train["batch_size"]
    s = sc.setup(ctx)
    atlas, server, reqs = s["atlas"], s["server"], s["reqs"]
    for n in p["warm_sizes"]:
        server.eval_model(atlas[:n], batch_size=B)
    k = p["trace_requests"]
    out = []
    for on in [None] + [True, False, False, True] * pairs:
        with (contextlib.nullcontext() if on is not False else spans_off()):
            with trace.profiled() as prof:
                for off, n in reqs[:k]:    # the same requests every time
                    with trace.span("request"):
                        server.eval_model(atlas[off:off + n], batch_size=B)
        sl = prof.slice
        if on is None:      # the first profile of the process: warm-up
            continue
        sizes = [n for _, n in reqs[:k]]
        host = {"slice_served_cells": sum(sizes)}
        calls = {"request": [b for n in sizes for b in sc.batches(n, B)]}
        out.append({"spans": on, "ms_per_request": 1e3 * sl.window_s / k,
                    "units": k,
                    "device_idle": 100.0 * (1 - sl.busy_s() / sl.window_s),
                    **({"split": split(ctx, sl, host, calls)} if on
                       else {})})
    return out


def summary(rows: list, key: str, on_ns: float) -> dict:
    """Medians with the spans on and off, the spans a step or request, and
    what they cost at ``on_ns`` each (µs a step or request)."""
    out = {}
    for on in (True, False):
        v = [r[key] for r in rows if r["spans"] is on]
        d = [r["device_idle"] for r in rows if r["spans"] is on]
        out["on" if on else "off"] = {
            key: statistics.median(v), key + "_all": v,
            "device_idle": statistics.median(d), "device_idle_all": d}
    per = statistics.median(r["split"]["spans"] / r["units"] for r in rows
                            if r["spans"])
    out["spans_per_unit"] = per
    out["on_us_per_unit"] = per * on_ns / 1e3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("trace_cost: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    cell = spec.workload(args.cell)
    config = spec.config(cell["config"])
    ctx = harness.Context(cell, config, args.seed, 0.0, True,
                          torch.device("cuda:0"), time.perf_counter())
    res = {"cell": args.cell, "seed": args.seed, "card": harness.card_line(),
           "off_ns": off_cost(), "on_ns": on_cost()}
    if cell["traffic_kind"] == "train_resident":
        rows = train_slices(ctx, args.pairs)
        res["summary"] = summary(rows, "ms_per_step",
                                 res["on_ns"]["span"])
    else:
        rows = serve_slices(ctx, args.pairs)
        res["summary"] = summary(rows, "ms_per_request",
                                 res["on_ns"]["span"])
    res["slices"] = rows
    text = json.dumps(res)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
