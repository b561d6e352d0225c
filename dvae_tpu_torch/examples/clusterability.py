"""Clusterability study of the PyTorch port: how separable are the
discovered categories?

Counterpart of dvae_tpu/examples/clusterability.py (the reference's
``notebooks/4_clusterability.ipynb`` workflow, backed by
mmidas/utils/cluster_analysis.py): given a trained model's latent
representations and cluster assignments, score them with k-fold
classifiers and silhouette analysis against the reference taxonomy labels.
As in the JAX example the classifiers are the random forest and LDA; the
forest is scikit-learn's (``eval.cluster_analysis``), so the study needs
scikit-learn for that row.

Run: ``python -m dvae_tpu_torch.examples.clusterability [--ckpt <path>]
[--device cpu]`` (a checkpoint of either package through
``models.api.load_vae`` → ``generate``; without one a small model trained
on synthetic data).
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from dvae_tpu_torch.eval.cluster_analysis import (cluster_compare,
                                                  get_SilhScore,
                                                  kfold_classifier)


def clusterability_study(x_low: np.ndarray, pred_labels: np.ndarray,
                         ref_labels: np.ndarray, kfold: int = 3,
                         num_pc: int = 0, device=None) -> dict:
    """Score discovered vs reference labelings on the latent representation.

    ``x_low``: (N, L) latent embeddings (one arm); ``pred_labels``: (N,)
    discovered categories; ``ref_labels``: (N,) taxonomy labels.  The
    silhouette and the PCA run on ``x_low``'s device or ``device``.
    """
    label_sets = {"discovered": pred_labels, "reference": ref_labels}
    out = {}
    for kind in ("rf", "lda"):
        acc, _, _ = kfold_classifier(x_low, label_sets, kfold=kfold,
                                     kind=kind)
        out[f"{kind}_accuracy"] = {k: float(np.mean(v))
                                   for k, v in acc.items()}
    for name, y in label_sets.items():
        if len(np.unique(y)) > 1:
            _, overall = get_SilhScore(x_low, y, device=device)
            out[f"silhouette_{name}"] = overall
    if num_pc > 0:
        _, _, sil, _ = cluster_compare(x_low, label_sets, num_pc=num_pc,
                                       device=device)
        out["silhouette_pca"] = dict(zip(label_sets, map(float, sil)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--kfold", type=int, default=3)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from dvae_tpu_torch.data.anndata_io import synthetic_dataset

    if args.ckpt:
        from dvae_tpu_torch.models.api import generate, load_vae
        cfg, params, bn, mask = load_vae(args.ckpt, device=args.device)
        # the dataset must match the checkpoint's gene dimension
        ds = synthetic_dataset(n_cells=600, n_genes=cfg.input_dim,
                               n_types=min(cfg.n_categories, 6), seed=0)
        out = generate(cfg, params, bn, ds.log1p, mask=mask)
    else:
        import tempfile

        from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE
        ds = synthetic_dataset(n_cells=600, n_genes=80, n_types=6, seed=0)
        cpl = CplMixVAE(saving_folder=tempfile.mkdtemp(), device=args.device)
        cpl.init_model(n_categories=6, input_dim=80, fc_dim=16, lowD_dim=8,
                       n_arm=2, tau=0.1, batch_size=100, epochs_per_jit=10)
        cpl.train(ds.log1p, n_epoch=30, save_plots=False)
        out = cpl.eval_model(ds.log1p)

    res = clusterability_study(out["x_low"][0], out["pred_label"][0],
                               ds.cluster_label, kfold=args.kfold,
                               device=args.device)
    print(json.dumps(res, indent=2, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
