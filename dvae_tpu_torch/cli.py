"""Command-line entry point of the PyTorch port: ``evaluate``.

Counterpart of ``dvae_tpu.cli evaluate`` (dvae_tpu/cli.py:185-215,
reference evaluation.py:92-127):

    python -m dvae_tpu_torch.cli evaluate --ckpt model.ckpt --synthetic

loads a checkpoint written by either package, runs batched inference
over the dataset, and prints the consensus and adjusted-MI metrics as one
JSON line (also saved to ``evaluation/A{n}-RUN{run}-E{epoch}.npy``).
The model runs on ``--device`` (default ``cuda``).  The dataset is the
synthetic one (``--syn_cells``/``--syn_genes``/``--syn_types``); reading
``.h5ad`` files is not ported yet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def cmd_evaluate(args) -> int:
    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    from dvae_tpu_torch.eval.evaluate import (avg_consensus, avg_max,
                                              mutinfo, summarize_inference)
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
    from dvae_tpu_torch.utils.checkpoint import latest_checkpoint

    ckpt = args.ckpt or latest_checkpoint(args.saving_folder or ".")
    if not ckpt:
        print("no checkpoint found", file=sys.stderr)
        return 1
    ds = synthetic_dataset(n_cells=args.syn_cells, n_genes=args.syn_genes,
                           n_types=args.syn_types, seed=args.seed)
    # a fresh instance: load_model rebuilds cfg/tcfg from the metadata
    cpl = CplMixVAE(saving_folder=args.saving_folder or ".",
                    device=args.device)
    preds = summarize_inference(cpl, ckpt, ds.log1p)
    n_arm = preds["pred_label"].shape[0]
    if n_arm != args.n_arm:
        print(f"note: checkpoint has {n_arm} arms (flag said {args.n_arm})")
    mis = [avg_max(mutinfo(preds["c_prob"][a], ds.c_onehot.astype(int)))
           for a in range(n_arm)]
    consensus = avg_consensus(preds["pred_label"])
    res = {"pairwise": consensus["pairwise"], "all": consensus["all"],
           "mi": mis, "avg_mi": float(np.mean(mis)), "arms": n_arm,
           "consensus": preds["consensus"]}
    os.makedirs(args.out_dir, exist_ok=True)
    np.save(os.path.join(args.out_dir,
                         f"A{n_arm}-RUN{args.run}-E{args.n_epoch}.npy"), res)
    print(json.dumps(res, default=float))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="dvae_tpu_torch",
                                     description=__doc__.splitlines()[0])
    sub = parser.add_subparsers(dest="cmd", required=True)
    pe = sub.add_parser("evaluate", help="consensus + adjusted-MI metrics")
    pe.add_argument("--ckpt", type=str, default=None)
    pe.add_argument("--saving_folder", type=str, default="")
    pe.add_argument("--device", type=str, default="cuda",
                    help="torch device of the model (cuda or cpu)")
    pe.add_argument("--n_arm", type=int, default=2)
    pe.add_argument("--synthetic", action="store_true",
                    help="use the synthetic dataset (the only input the "
                         "port reads so far)")
    pe.add_argument("--syn_cells", type=int, default=5000)
    pe.add_argument("--syn_genes", type=int, default=500)
    pe.add_argument("--syn_types", type=int, default=20)
    pe.add_argument("--run", type=int, default=0)
    pe.add_argument("--n_epoch", type=int, default=0)
    pe.add_argument("--seed", type=int, default=546)
    pe.add_argument("--out_dir", type=str, default="evaluation")
    pe.set_defaults(fn=cmd_evaluate)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
