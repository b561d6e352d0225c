"""One run of one cell: find its files, run its traffic, read its metrics,
judge its outputs, print the line."""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import zlib
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from portbench.core import compare, guard, spec


@dataclass
class Context:
    """What a traffic kind's ``run`` gets."""

    cell: dict            # workloads/<cell>.json
    config: dict          # configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: object        # torch.device
    t_start: float        # perf_counter at process start

    @property
    def model(self) -> dict:
        return self.config["model"]

    @property
    def train(self) -> dict:
        return self.config.get("train", {})

    @property
    def params(self) -> dict:
        return self.cell["params"]

    def seed_for(self, what: str) -> int:
        """A 63-bit seed of its own for ``what``, from the run's seed."""
        ss = np.random.SeedSequence([int(self.seed),
                                     zlib.crc32(what.encode())])
        return int(ss.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1)


@dataclass
class Result:
    """What a traffic kind's ``run`` returns."""

    e2e: dict = field(default_factory=dict)        # end-to-end metric values
    host: dict = field(default_factory=dict)       # host readings
    slice: Optional[object] = None                 # trace.TraceSlice
    calls: dict = field(default_factory=dict)      # phase → rows per call
    numbers: dict = field(default_factory=dict)    # compared numbers
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    notes: list = field(default_factory=list)      # lines for stderr


@dataclass
class Readings:
    """What a per-layer metric's ``read`` gets."""

    model: dict
    dtype: str
    host: dict
    slice: Optional[object]
    calls: dict


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def run_cell(cell: dict, config: dict, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> Result:
    ctx = Context(cell, config, seed, seconds, trace, device, t_start)
    return spec.traffic(cell["traffic_kind"]).run(ctx)


def _finite(v):
    """A JSON number: infinities as ±1e308, NaN as None."""
    v = float(v)
    if math.isnan(v):
        return None
    if math.isinf(v):
        return math.copysign(1e308, v)
    return v


def build_line(bench: dict, name: str, cell: dict, config: dict,
               trace: bool, result: Result, device: dict) -> dict:
    """The result line of one run (without printing it).  An end-to-end
    metric reads the quantity its name begins with (``spec.quantity``)."""
    metrics = {}
    if not trace:
        for m in spec.end_to_end_for(bench, name):
            q = spec.quantity(m["name"])
            if q not in result.e2e:
                raise KeyError(f"cell {name} did not measure {q}")
            metrics[m["name"]] = {"value": float(result.e2e[q]),
                                  "unit": m["unit"]}
    else:
        r = Readings(config["model"], config["dtype"], result.host,
                     result.slice, result.calls)
        for m in spec.per_layer_for(bench, name):
            v = spec.metric_reader(m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    ok, checks = compare.judge(result.numbers, cell["limits"])
    correct = ok and result.failed == 0 and result.attempted > 0
    line = {"correct": bool(correct), "attempted": int(result.attempted),
            "failed": int(result.failed), "metrics": metrics,
            "device": device}
    if trace and result.slice is not None:
        line["breakdown"] = {"device_ops": result.slice.top_ops(),
                             "idle_gaps": result.slice.idle_gaps()}
    line["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                      for k, v in checks.items()}
    return line


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.workload)
    cell = spec.workload(args.workload)
    if (cell["config"], cell["traffic"]) != (entry["config"],
                                             entry["traffic"]):
        raise ValueError(f"workloads/{args.workload}.json and BENCHMARK.json "
                         "name different configurations or traffic")
    config = spec.config(cell["config"])
    try:
        guard.require_cards(int(entry["chips"]))
    except guard.NoCard as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    device = torch.device("cuda:0")
    result = run_cell(cell, config, args.seed, args.seconds,
                      bool(args.trace), device, t_start)
    card = card_line()
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": int(entry["chips"]),
           "memory_peak_bytes": int(result.memory_peak_bytes),
           "card": card}
    if args.trace and result.slice is not None:
        dev["busy_s"] = result.slice.busy_s()
        dev["window_s"] = result.slice.window_s
    line = build_line(bench, args.workload, cell, config, bool(args.trace),
                      result, dev)
    bad = guard.forbidden_modules()
    if bad:
        print("portbench: modules that a run may not load were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for note in result.notes:
        print(note, file=sys.stderr)
    print(f"card: {card}", file=sys.stderr)
    for k, v in line["checks"].items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(f"correct = {line['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
