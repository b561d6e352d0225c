"""Readings that the correctness limits of ``mse-train-aug`` are set from
(not run by the benchmark's own runs).

    python3 portbench/control_aug.py --seeds 1,2,3 [--out FILE]

For every seed, in one process, at the cell's own size
(``traffic/train_resident_aug.readings``): the program's compared numbers
against the plain reference (the lower reading), and against the same
reference the control, the augmenter's products in TF32 (and every
product in TF32), and the planted faults: a noise scale twice the
configuration's, one layer's weights (fc6) scaled by 1 + 1e-3, the trunk
normalised with batch statistics, a batch of which half is left out (the
upper readings).  Prints one JSON line a seed and, with ``--out``, writes
them all.  Needs the card.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from portbench.control import _clean  # noqa: E402
from portbench.core import guard, harness, spec  # noqa: E402

CELL = "mse-train-aug"


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control_aug.py")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.workload(CELL)
    config = spec.config(cell["config"])
    guard.require_cards(int(cell["chips"]))
    import torch
    dev = torch.device("cuda:0")
    mod = spec.traffic(cell["traffic_kind"])
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(cell, config, seed, 0.0, False, dev, t0)
        got = {k: _clean(v) for k, v in mod.readings(ctx).items()}
        row = {"workload": CELL, "seed": seed, **got,
               "seconds": time.perf_counter() - t0}
        print(json.dumps(row), flush=True)
        rows.append(row)
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    bad = guard.forbidden_modules()
    if bad:
        print("control: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
