"""Consensus-convergence demonstration in the port: train to the
early-stop criterion.

Counterpart of dvae_tpu/examples/consensus_convergence.py.  The
reference's quality bar is train consensus (the mean diagonal of the
normalized arm-pair confusion matrix) reaching ``good_enuf_consensus``
0.75 (mmidas/cpl_mixvae.py:336, :851), where training stops and
checkpoints.  This runs the whole CplMixVAE pipeline on planted-structure
synthetic data until the criterion fires, and reports the curve.

Run: ``python -m dvae_tpu_torch.examples.consensus_convergence
[--cells 4000 --genes 500 --types 15 --categories 30 --epochs 3000
--device cuda]``
"""

from __future__ import annotations

import argparse
import glob
import json
import tempfile


def run(n_cells: int = 2000, n_genes: int = 200, n_types: int = 10,
        n_categories: int = 12, n_arm: int = 2, batch_size: int = 500,
        n_epoch: int = 8000, epochs_per_jit: int = 200, lr: float = 1e-3,
        tau: float = 0.005, lam: float = 5.0, stop: float = 0.75,
        seed: int = 546, folder: str = "", verbose: bool = True,
        device="cuda") -> dict:
    """The JAX script's defaults (its note: they early-stop at consensus
    ≥ 0.75 by epoch ~800)."""
    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

    ds = synthetic_dataset(n_cells=n_cells, n_genes=n_genes,
                           n_types=n_types, seed=seed)
    tr, te = stratified_split_indices(ds.cluster_label, 0.9, seed)
    folder = folder or tempfile.mkdtemp(prefix="consensus_demo_")
    cpl = CplMixVAE(saving_folder=folder, seed=seed, device=device)
    cpl.init_model(n_categories=n_categories, input_dim=n_genes,
                   fc_dim=100, lowD_dim=10, n_arm=n_arm, tau=tau, lr=lr,
                   lam=lam, batch_size=batch_size,
                   epochs_per_jit=epochs_per_jit)
    cpl.train(ds.log1p[tr], x_val=ds.log1p[te], n_epoch=n_epoch,
              early_stop_consensus=stop, save_plots=True)

    # the consensus curve from the structured history
    with open(glob.glob(folder + "/metrics.jsonl")[0]) as fh:
        hist = [json.loads(line) for line in fh]
    cons = [(h["step"], h["train/consensus"]) for h in hist
            if "train/consensus" in h]
    final_epoch, final_cons = cons[-1]
    res = cpl.eval_model(ds.log1p[te])
    out = {
        "folder": folder,
        "final_epoch": final_epoch,
        "train_consensus": final_cons,
        "test_consensus": res["consensus"],
        "reached_criterion": final_cons >= stop,
        "curve_tail": cons[-10:],
    }
    if verbose:
        print(json.dumps(out, indent=2, default=float))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=2000)
    ap.add_argument("--genes", type=int, default=200)
    ap.add_argument("--types", type=int, default=10)
    ap.add_argument("--categories", type=int, default=12)
    ap.add_argument("--n_arm", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=8000)
    ap.add_argument("--stop", type=float, default=0.75)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    out = run(args.cells, args.genes, args.types, args.categories,
              args.n_arm, args.batch_size, args.epochs, stop=args.stop,
              device=args.device)
    return 0 if out["reached_criterion"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
