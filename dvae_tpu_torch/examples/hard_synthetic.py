"""Hard-mode quality study in the PyTorch port: the production recipe on
ZINB-count synthetic data with real-scRNA failure modes.

Counterpart of dvae_tpu/examples/hard_synthetic.py, the recipe, flags and
output JSON kept.  It trains the production recipe (A=2, lam 5, batch
5000, bf16, block shuffle 8; examples/production_scale.py) on
``data/anndata_io.hard_synthetic_dataset`` (ZINB counts, library-size
variation, expression-dependent dropout, hierarchically overlapping types)
and scores, with the port's numpy AMI (``eval/evaluate.
adjusted_mutual_info_score``):

  * **leaf AMI** — against the 92 planted leaf types (siblings share ~97%
    of their program, so leaf recovery stays below 1.0);
  * **root AMI** — against the 12 root programs.

Run: ``python -m dvae_tpu_torch.examples.hard_synthetic
[--epochs 25000 --mode MSE|ZINB --seed 3 --device cuda]``;
add ``--categories 100 --prune_iters 8 --prune_epochs 2000`` for the
pruning K-selection loop, ``--align_every 500`` for cross-arm alignment,
``--aug_file <ckpt>`` for a pretrained frozen augmenter in the training
loop (reference train.py:97-113; train one with
``python -m dvae_tpu_torch.examples.hard_augmenter``), ``--data_seed`` to
keep the dataset fixed across training seeds.

The port's counts are another draw than the JAX package's at the same seed
(the taxonomy is the same, tests/test_torch_train.py), so its numbers are
compared with the JAX rows, not equal to them.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

# the recipe's sizes (the JAX script's); tests lower them
N_CELLS, N_GENES, N_TYPES = 20000, 5032, 92
BATCH_SIZE, EPOCHS_PER_JIT = 5000, 500


def _dataset(seed: int, device="cuda"):
    """hard_synthetic_dataset(N_CELLS, N_GENES, N_TYPES) with a disk cache in
    the temporary directory, so the MSE and ZINB studies share one draw.
    The counts are drawn on ``device`` (a CUDA draw is another than a CPU
    one) and are not the JAX package's: the cache name says so, and the
    JAX package's file is never read."""
    import numpy as np
    import torch

    from dvae_tpu_torch.data.anndata_io import (CellDataset,
                                                hard_synthetic_dataset)

    kind = torch.device(device).type
    path = os.path.join(
        tempfile.gettempdir(),
        f"hard_syn_torch_{kind}_{seed}_{N_CELLS}x{N_GENES}x{N_TYPES}.npz")
    try:
        z = np.load(path, allow_pickle=False)
        return CellDataset(
            log1p=z["log1p"], gene_id=z["gene_id"],
            cluster_label=z["cluster_label"], cluster_id=z["cluster_id"],
            c_onehot=z["c_onehot"], c_p=z["c_p"], n_type=int(z["n_type"]))
    except (OSError, KeyError):
        pass
    ds = hard_synthetic_dataset(n_cells=N_CELLS, n_genes=N_GENES,
                                n_types=N_TYPES, seed=seed, device=device)
    try:
        np.savez(path, log1p=ds.log1p, gene_id=ds.gene_id,
                 cluster_label=ds.cluster_label, cluster_id=ds.cluster_id,
                 c_onehot=ds.c_onehot, c_p=ds.c_p, n_type=ds.n_type)
    except OSError:
        pass
    return ds


def run(n_epoch: int = 25000, folder: str = "", seed: int = 3,
        verbose: bool = True, mode: str = "MSE", n_arm: int = 2,
        x_drop: float = 0.5, align_every: int = 0,
        n_categories: int = 92, n_epoch_p: int = 0, max_prun_it: int = 0,
        min_con: float = 0.99, aug_file: str = "",
        data_seed: int | None = None, device="cuda") -> dict:
    import glob

    import numpy as np

    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.eval.evaluate import adjusted_mutual_info_score
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

    t0 = time.time()
    data_seed = seed if data_seed is None else data_seed
    ds = _dataset(data_seed, device)
    zero_frac = float((ds.log1p == 0).mean())
    tr, te = stratified_split_indices(ds.cluster_label, 0.9, data_seed)
    folder = folder or tempfile.mkdtemp(prefix="hard_syn_")
    cpl = CplMixVAE(saving_folder=folder, seed=seed,
                    aug_file=aug_file or None, device=device)
    # the production recipe (examples/production_scale.py): only the data
    # is harder
    cpl.init_model(n_categories=n_categories, input_dim=N_GENES,
                   n_arm=n_arm, lam=5.0, batch_size=BATCH_SIZE,
                   epochs_per_jit=EPOCHS_PER_JIT, bf16=True, rng_impl="rbg",
                   shuffle_block=8, mode=mode, x_drop=x_drop,
                   align_arms_every=align_every)
    last = cpl.train(ds.log1p[tr], x_val=ds.log1p[te], n_epoch=n_epoch,
                     n_epoch_p=n_epoch_p, max_prun_it=max_prun_it,
                     min_con=min_con, early_stop_consensus=0.75,
                     save_plots=False)

    # with a pruning phase the masked final state is the result (the
    # reference's K-selection workflow); without one, the best-consensus
    # checkpoint of the main phase
    if max_prun_it > 0:
        if not last:
            # a NaN halt returns "": the newest checkpoint any chunk wrote
            cands = sorted(glob.glob(f"{folder}/cpl_mixVAE_model_*.ckpt"),
                           key=os.path.getmtime)
            if not cands:
                raise RuntimeError(
                    f"training halted before any checkpoint landed in "
                    f"{folder}; nothing to score")
            last = cands[-1]
        cpl.load_model(last)
    else:
        cpl.load_model(f"{folder}/cpl_mixVAE_model_best_train.ckpt")

    labels = cpl._predict_labels(ds.log1p[te], 1.0)
    leaf_true = ds.cluster_id[te]
    root_true = np.array([lab.split("_")[0] for lab in ds.cluster_label[te]])
    res = cpl.eval_model(ds.log1p[te])
    mask = cpl.state.mask.cpu().numpy()

    # with the augmenter in the loop, the train-phase consensus is the
    # reference's augmentation consensus (cpl_mixvae.py:515-552)
    train_consensus = None
    try:
        with open(f"{folder}/metrics.jsonl") as fh:
            for line in fh:
                row = json.loads(line)
                if "train/consensus" in row:
                    train_consensus = float(row["train/consensus"])
    except OSError:
        pass

    out = {
        "folder": folder,
        "mode": mode,
        "n_arm": n_arm,
        "x_drop": x_drop,
        "align_every": align_every,
        "aug_file": aug_file or None,
        "data_seed": data_seed,
        "train_consensus": train_consensus,
        "n_categories": n_categories,
        "prune": {"n_epoch_p": n_epoch_p, "max_prun_it": max_prun_it,
                  "min_con": min_con, "active": int(mask.sum()),
                  "pruned_idx": np.flatnonzero(mask == 0).tolist()}
        if max_prun_it > 0 else None,
        "seed": seed,
        "zero_frac": round(zero_frac, 3),
        "wall_min": round((time.time() - t0) / 60, 1),
        "final_epoch": int(cpl.state.epoch),
        "test_consensus": float(res["consensus"]),
        "ami_leaf": [adjusted_mutual_info_score(leaf_true, labels[a])
                     for a in range(labels.shape[0])],
        "ami_root": [adjusted_mutual_info_score(root_true, labels[a])
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
    ap.add_argument("--epochs", type=int, default=25000)
    ap.add_argument("--folder", type=str, default="")
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--mode", type=str, default="MSE",
                    choices=["MSE", "ZINB"])
    ap.add_argument("--arms", type=int, default=2)
    ap.add_argument("--xdrop", type=float, default=0.5,
                    help="input dropout (reference default 0.5)")
    ap.add_argument("--align_every", type=int, default=0,
                    help="Hungarian cross-arm category alignment cadence "
                         "(train/alignment.py; 0 = off)")
    ap.add_argument("--categories", type=int, default=92,
                    help="model categories K (above the 92 planted types "
                         "to exercise the pruning K-selection loop)")
    ap.add_argument("--prune_epochs", type=int, default=0,
                    help="retraining epochs per prune iteration (n_epoch_p)")
    ap.add_argument("--prune_iters", type=int, default=0,
                    help="max pruning iterations (0 = no pruning phase)")
    ap.add_argument("--min_con", type=float, default=0.99,
                    help="prune while the worst per-category cross-arm "
                         "agreement is at or below this")
    ap.add_argument("--aug_file", type=str, default="",
                    help="pretrained frozen augmenter checkpoint (either "
                         "package's); see examples/hard_augmenter")
    ap.add_argument("--data_seed", type=int, default=None,
                    help="dataset seed (default: --seed)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device (cuda or cpu)")
    args = ap.parse_args(argv)
    return run(n_epoch=args.epochs, folder=args.folder, seed=args.seed,
               mode=args.mode, n_arm=args.arms, x_drop=args.xdrop,
               align_every=args.align_every, n_categories=args.categories,
               n_epoch_p=args.prune_epochs, max_prun_it=args.prune_iters,
               min_con=args.min_con, aug_file=args.aug_file,
               data_seed=args.data_seed, device=args.device)


if __name__ == "__main__":
    main()
