"""Sharding × precision × model benchmark sweeps.

Counterpart of dvae_tpu/bench/sweep.py (the reference's sweep generator
over STRATS×MODELS×GPUS, dist/plot_config.py:6-22,51-60, its run-artifact
dumps, fsdp_mnist.py:477-495, and its log parsers, dist/plot.py:25-168),
with structured JSONL artifacts.

Several devices are one process per device, joined by
``torch.distributed``: every rank of the world runs each config (a
config's ``n_devices`` below the world size runs on the group of the
first ranks, the others waiting), and rank 0 appends one JSONL record a
config with the JAX package's keys.  This is the tutorial's sweep, not
the port's benchmark of the VAE.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Iterable, Optional, Sequence

STRATEGIES = ("full", "grad-op", "no", "hybrid", "hybrid-zero2", "ddp")
PRECISIONS = ("fp32", "bf16")
MODELS = ("shallow", "deep")


@dataclass(frozen=True)
class SweepConfig:
    model: str
    strategy: str
    precision: str
    n_devices: Optional[int] = None
    n_epochs: int = 2
    batch_size: int = 512


def gen_configs(models: Sequence[str] = ("shallow",),
                strategies: Sequence[str] = STRATEGIES,
                precisions: Sequence[str] = ("fp32",),
                device_counts: Sequence[Optional[int]] = (None,),
                **kw) -> list[SweepConfig]:
    """Cartesian sweep grid (reference gen_configs, dist/plot_config.py:51-60)."""
    return [SweepConfig(m, s, p, d, **kw)
            for m, s, p, d in itertools.product(models, strategies,
                                                precisions, device_counts)]


def run_sweep(configs: Iterable[SweepConfig],
              out_path: str = "sweep_results.jsonl",
              verbose: bool = True, device="cuda", data=None,
              test_data=None) -> list[dict]:
    """Run each config through the FSDP tutorial harness on every rank of
    the world; rank 0 appends one JSON record per run (the fsdp_mnist.py
    run-artifact contract).  Returns this rank's records (none for a
    config whose group it is outside).  ``data``/``test_data`` pass
    through to ``train_mnist_fsdp``."""
    from dvae_tpu_torch.examples.fsdp_tutorial import train_mnist_fsdp
    from dvae_tpu_torch.parallel.runtime import process_info

    rank = process_info()[0]
    results = []
    for cfg in configs:
        t0 = time.perf_counter()
        res = train_mnist_fsdp(model=cfg.model, strategy=cfg.strategy,
                               precision=cfg.precision,
                               n_devices=cfg.n_devices,
                               n_epochs=cfg.n_epochs,
                               batch_size=cfg.batch_size, verbose=False,
                               device=device, data=data, test_data=test_data)
        if res is None:
            continue
        rec = {**asdict(cfg), **res._asdict(),
               "wall_s": time.perf_counter() - t0}
        results.append(rec)
        if verbose and rank == 0:
            print(f"{cfg.model}/{cfg.strategy}/{cfg.precision}: "
                  f"epoch={res.epoch_times_s[-1]:.3f}s "
                  f"loss={res.train_losses[-1]:.4f} acc={res.test_accs[-1]:.3f}")
        if out_path and rank == 0:
            with open(out_path, "a") as f:
                f.write(json.dumps(rec, default=float) + "\n")
    return results


def load_results(path: str) -> list[dict]:
    """Parse sweep artifacts (the dist/plot.py log-parser analogue)."""
    out = []
    if not os.path.exists(path):
        return out
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def summarize(results: list[dict]) -> dict:
    """Epoch-time / loss / accuracy table keyed by (model, strategy,
    precision, n_devices) — what dist/plot.py plotted across run dirs."""
    table = {}
    for r in results:
        key = (r["model"], r["strategy"], r["precision"],
               int(r["n_devices"]))
        table[key] = {
            "epoch_time_s": float(r["epoch_times_s"][-1]),
            "final_loss": float(r["train_losses"][-1]),
            "final_acc": float(r["test_accs"][-1]),
            "n_params": int(r["n_params"]),
            "n_devices": int(r["n_devices"]),
        }
    return table


def main(argv=None) -> int:
    """CLI: ``python -m dvae_tpu_torch.bench.sweep --models shallow
    --precisions fp32 bf16`` (once per rank, with ``cli train``'s
    multi-process flags, for several devices) — run the grid and print
    the summary table on rank 0."""
    import argparse

    from dvae_tpu_torch.parallel.census import add_world_flags
    from dvae_tpu_torch.parallel.runtime import (initialize_distributed,
                                                 process_info, shutdown)

    ap = argparse.ArgumentParser(description="sharding x precision sweep")
    ap.add_argument("--models", nargs="+", default=["shallow"],
                    choices=list(MODELS))
    ap.add_argument("--strategies", nargs="+", default=list(STRATEGIES),
                    choices=list(STRATEGIES))
    ap.add_argument("--precisions", nargs="+", default=["fp32"],
                    choices=list(PRECISIONS))
    ap.add_argument("--n_epochs", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=512)
    ap.add_argument("--out", type=str, default="sweep_results.jsonl")
    add_world_flags(ap)
    args = ap.parse_args(argv)
    initialize_distributed(args.coordinator, args.num_processes,
                           args.process_id, backend=args.dist_backend,
                           device=args.device)
    try:
        cfgs = gen_configs(args.models, args.strategies, args.precisions,
                           n_epochs=args.n_epochs, batch_size=args.batch_size)
        results = run_sweep(cfgs, out_path=args.out, device=args.device)
        if process_info()[0] == 0:
            for key, row in summarize(results).items():
                print(key, row)
    finally:
        shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
