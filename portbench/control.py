"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--out FILE]

For every seed, in one process, at the cell's own size: the program's
compared numbers against the plain reference (the sound runs: the lower
reading), the control's (the reference with TF32 products put in the
program's place: the upper reading), and for a training cell the fault of
a batch of which half is left out, the mean taken over the rest.  A
training step that leaves the state unchanged reads 1 on ``change`` by
construction and needs no run.  Prints one JSON line a seed and, with
``--out``, writes them all.  Needs the card, as a run does.
"""

import os
import sys
import time

T_START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import json  # noqa: E402

from portbench.core import compare, guard, harness, spec  # noqa: E402


def _clean(d: dict) -> dict:
    return {k: (v if isinstance(v, (int, float, str)) else str(v))
            for k, v in d.items()}


def train_readings(ctx) -> dict:
    import torch
    mod = spec.traffic("train_resident")
    s = mod.setup(ctx)
    m, B, n = ctx.model, ctx.train["batch_size"], ctx.params["probe_steps"]
    unapplied = abs(s["epochs"] * (ctx.params["n_train"] // B)
                    - int(s["trainer"].state.opt_state.count))
    del s["trainer"], s["runner"]
    torch.cuda.empty_cache()
    args = (s["weights"], s["x_train"], m, ctx.seed, B, n, m["lr"], ctx.device)
    want = mod.follow(*args)
    # the reference in the program's place applies every step it takes
    return {"program": {**compare.train_numbers(s["prog"], want),
                        "steps_unapplied": unapplied},
            "control_tf32": {**compare.train_numbers(
                mod.follow(*args, mode="tf32"), want), "steps_unapplied": 0},
            "fault_half_batch": {**compare.train_numbers(
                mod.follow(*args, rows=B // 2), want), "steps_unapplied": 0}}


def serve_readings(ctx) -> dict:
    import torch
    mod = spec.traffic("serve_closed_loop")
    s = mod.setup(ctx)
    B = ctx.train["batch_size"]
    kept = {}
    for j in sorted(s["keep"]):
        off, n = s["reqs"][j]
        kept[j] = s["server"].eval_model(s["atlas"][off:off + n],
                                         batch_size=B)
    del s["server"]
    torch.cuda.empty_cache()
    control = {j: mod.as_served(mod.reference(ctx, s, j, "tf32"), ctx.model)
               for j in kept}
    return {"program": mod.judge(ctx, s, kept),
            "control_tf32": mod.judge(ctx, s, control)}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="portbench/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.workload(args.workload)
    config = spec.config(cell["config"])
    guard.require_cards(int(cell["chips"]))
    import torch
    dev = torch.device("cuda:0")
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        ctx = harness.Context(cell, config, seed, 0.0, False, dev, t0)
        fn = (train_readings if cell["traffic_kind"] == "train_resident"
              else serve_readings)
        got = {k: _clean(v) for k, v in fn(ctx).items()}
        row = {"workload": args.workload, "seed": seed, **got,
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
