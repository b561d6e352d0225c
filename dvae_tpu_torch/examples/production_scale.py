"""Production-scale end-to-end run in the port: the reference's A2 recipe.

Counterpart of dvae_tpu/examples/production_scale.py: train the coupled
mixVAE at the reference production shape (D=5032 genes, C=92 categories,
B=5000, A=2 arms; train-scripts/run-train-A2-E100000) on planted-structure
synthetic data with 92 types, through the hand-written kernels on CUDA
(bf16, block shuffle 8), then score the reference's north-star metrics
(evaluation.py:25-41) with the port's numpy AMI: each arm's labels against
the planted truth, and arm against arm.  An optional pruning phase
(reference cpl_mixvae.py:996-1444) removes zero-agreement categories.

Run: ``python -m dvae_tpu_torch.examples.production_scale
[--epochs 20000 --prune-iters 0 --folder OUT --device cuda]``
"""

from __future__ import annotations

import argparse
import json
import tempfile
import time

# the recipe's sizes (the JAX script's); tests lower them
N_CELLS, N_GENES, N_TYPES = 20000, 5032, 92
BATCH_SIZE, EPOCHS_PER_JIT = 5000, 500


def run(n_epoch: int = 20000, prune_iters: int = 0, n_epoch_p: int = 1000,
        folder: str = "", seed: int = 3, verbose: bool = True,
        mode: str = "MSE", n_arm: int = 2, align_every: int = 0,
        device="cuda") -> dict:
    import numpy as np

    from dvae_tpu_torch.data.anndata_io import synthetic_dataset
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.eval.evaluate import adjusted_mutual_info_score
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

    t0 = time.time()
    ds = synthetic_dataset(n_cells=N_CELLS, n_genes=N_GENES,
                           n_types=N_TYPES, seed=seed)
    tr, te = stratified_split_indices(ds.cluster_label, 0.9, seed)
    folder = folder or tempfile.mkdtemp(prefix="prod_scale_")
    cpl = CplMixVAE(saving_folder=folder, seed=seed, device=device)
    cpl.init_model(n_categories=N_TYPES, input_dim=N_GENES, n_arm=n_arm,
                   lam=5.0, batch_size=BATCH_SIZE,
                   epochs_per_jit=EPOCHS_PER_JIT, bf16=True, rng_impl="rbg",
                   shuffle_block=8, mode=mode, align_arms_every=align_every)
    cpl.train(ds.log1p[tr], x_val=ds.log1p[te], n_epoch=n_epoch,
              n_epoch_p=n_epoch_p if prune_iters else 0,
              max_prun_it=prune_iters, early_stop_consensus=0.75,
              save_plots=False)

    # best-consensus state → north-star metrics on held-out cells
    cpl.load_model(f"{folder}/cpl_mixVAE_model_best_train.ckpt")
    labels = cpl._predict_labels(ds.log1p[te], 1.0)
    true = ds.cluster_id[te]
    res = cpl.eval_model(ds.log1p[te])
    out = {
        "folder": folder,
        "n_arm": n_arm,
        "align_every": align_every,
        "wall_min": round((time.time() - t0) / 60, 1),
        "final_epoch": int(cpl.state.epoch),
        "categories_remaining": int(cpl.state.mask.sum()),
        "test_consensus": float(res["consensus"]),
        "ami_vs_truth": [adjusted_mutual_info_score(true, labels[a])
                         for a in range(labels.shape[0])],
        "ami_arm_arm": float(np.mean([
            adjusted_mutual_info_score(labels[a], labels[b])
            for a in range(labels.shape[0]) for b in range(a)])),
    }
    if verbose:
        print(json.dumps(out, indent=2))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20000)
    ap.add_argument("--prune-iters", type=int, default=0)
    ap.add_argument("--folder", type=str, default="")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--mode", type=str, default="MSE",
                    choices=["MSE", "ZINB"],
                    help="reconstruction mode (ZINB: the three-head "
                         "zero-inflated NB loss, reference "
                         "nn_model.py:642-676)")
    ap.add_argument("--arms", type=int, default=2)
    ap.add_argument("--align_every", type=int, default=0,
                    help="Hungarian cross-arm category alignment cadence "
                         "(train/alignment.py; 0 = off)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    return run(n_epoch=args.epochs, prune_iters=args.prune_iters,
               folder=args.folder, seed=args.seed, mode=args.mode,
               n_arm=args.arms, align_every=args.align_every,
               device=args.device)


if __name__ == "__main__":
    main()
