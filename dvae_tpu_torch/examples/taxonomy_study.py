"""Taxonomy study of the PyTorch port: which dendrogram level do the
discovered categories match?

Counterpart of dvae_tpu/examples/taxonomy_study.py (the reference's
``notebooks/3_analysis.ipynb`` / ``tree_based_analysis.py`` workflow):
planted HIERARCHICAL data — a synthetic binary taxonomy whose expression
programs drift less at deeper splits — a ``CplMixVAE`` training run, and
the merge sweep (``HTree.get_merged_types`` at every level, scored with
the port's numpy AMI) on its labels.  The data are bit for bit the JAX
package's from the same seed.  The dendrogram plots need matplotlib; the
rest needs neither pandas nor scikit-learn.

Run: ``python -m dvae_tpu_torch.examples.taxonomy_study
[--depth 4 --cells 4000 --genes 400 --epochs 4000] [--device cpu]``
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from dvae_tpu_torch.analysis.taxonomy import HTree
from dvae_tpu_torch.eval.evaluate import adjusted_mutual_info_score

ROOT = "n1"


def synthetic_taxonomy(depth: int = 3, seed: int = 0):
    """A full binary dendrogram in the HTree schema.

    Returns (HTree, leaf_names).  Internal nodes are ``n1`` (root), ``n2``,
    ... in BFS order at y = depth − level; leaves are ``t00``, ``t01``, ...
    left-to-right at y = 0 — the (x, y, leaf, label, parent, col) layout of
    the Allen dend CSV export (reference taxonomy.py:49-81).
    """
    rows = []
    n_leaves = 2 ** depth
    leaf_names = [f"t{i:02d}" for i in range(n_leaves)]
    # internal nodes, BFS: node i at level l has children 2i, 2i+1
    n_internal = 2 ** depth - 1
    for i in range(1, n_internal + 1):
        level = i.bit_length() - 1
        rows.append({"label": f"n{i}", "leaf": False,
                     "parent": (np.nan if i == 1 else f"n{i // 2}"),
                     "x": 0.0, "y": float(depth - level), "col": "#000000"})
    palette = ("#1f77b4", "#ff7f0e", "#2ca02c", "#d62728",
               "#9467bd", "#8c564b", "#e377c2", "#7f7f7f")
    for j, name in enumerate(leaf_names):
        rows.append({"label": name, "leaf": True,
                     "parent": f"n{(n_internal + 1 + j) // 2}",
                     "x": float(j), "y": 0.0,
                     "col": palette[j % len(palette)]})
    tree = HTree(htree_df={k: [r[k] for r in rows] for k in rows[0]})
    tree.update_layout()
    return tree, leaf_names


def hierarchical_synthetic(depth: int = 3, n_cells: int = 2000,
                           n_genes: int = 200, seed: int = 0,
                           base_scale: float = 1.6, decay: float = 0.72,
                           noise: float = 0.3, sparsity: float = 0.7):
    """Cells whose expression programs follow the taxonomy.

    Each leaf centroid is the root program plus one perturbation per edge
    on the root→leaf path, with per-level scale ``base_scale · decay^level``
    — coarse splits move expression more than fine splits, so sibling
    leaves are more alike than cousins (the property the merge sweep
    detects).  Returns (HTree, X (N, D) f32, labels (N,) leaf names).
    """
    rng = np.random.default_rng(seed)
    tree, leaf_names = synthetic_taxonomy(depth, seed)
    n_leaves = len(leaf_names)
    base = rng.gamma(2.0, 2.0, n_genes) * (rng.random(n_genes) > sparsity)

    # perturbation per internal EDGE, keyed by the child index in the
    # implicit heap numbering (leaf j is heap node 2^depth + j)
    def centroid(leaf_j: int) -> np.ndarray:
        c = base.copy()
        node = 2 ** depth + leaf_j
        path = []
        while node > 1:
            path.append(node)
            node //= 2
        for heap_id in reversed(path):   # root-side edges first
            level = heap_id.bit_length() - 2   # edge into this node
            edge_rng = np.random.default_rng((seed, heap_id))
            mask = edge_rng.random(n_genes) > sparsity
            c = c + (base_scale * decay ** level
                     * edge_rng.normal(0.0, 1.0, n_genes) * mask)
        return c

    centers = np.stack([centroid(j) for j in range(n_leaves)])
    centers = np.maximum(centers, 0.0)
    assign = rng.integers(0, n_leaves, n_cells)
    X = centers[assign] + rng.normal(0, noise, (n_cells, n_genes))
    X = np.maximum(X, 0.0).astype(np.float32)
    labels = np.array(leaf_names, dtype=object)[assign].astype(str)
    return tree, X, labels


def merge_sweep(tree: HTree, true_labels: np.ndarray,
                pred_labels: np.ndarray) -> list:
    """AMI of the discovered categories vs the taxonomy partition at every
    merge level, finest first (the reference's level-matching question).

    ``pred_labels``: (A, N) per-arm categories.  Returns rows of
    {n_classes, ami (per arm), merges_applied}.
    """
    merges = tree.get_mergeseq()
    rows = []
    seen_k = set()
    for applied in range(0, len(merges)):
        merged, _, _ = tree.get_merged_types(true_labels,
                                             num_classes=applied + 1,
                                             node=ROOT)
        k = len(np.unique(merged))
        if k < 2 or k in seen_k:
            continue
        seen_k.add(k)
        rows.append({
            "n_classes": int(k),
            "merges_applied": applied,
            "ami": [float(adjusted_mutual_info_score(merged, arm))
                    for arm in pred_labels],
        })
    rows.sort(key=lambda r: -r["n_classes"])
    return rows


def run(depth: int = 3, n_cells: int = 2000, n_genes: int = 200,
        n_categories: int = 0, n_arm: int = 2, batch_size: int = 500,
        n_epoch: int = 3000, epochs_per_jit: int = 200, tau: float = 0.005,
        lam: float = 5.0, seed: int = 546, folder: str = "",
        save_plots: bool = True, verbose: bool = True,
        device="cuda") -> dict:
    """Train on hierarchical data on ``device``, then run the taxonomy
    analysis loop."""
    from dvae_tpu_torch.data.pipeline import stratified_split_indices
    from dvae_tpu_torch.train.cpl_mixvae import CplMixVAE

    tree, X, labels = hierarchical_synthetic(depth, n_cells, n_genes, seed)
    n_leaves = 2 ** depth
    n_categories = n_categories or int(1.5 * n_leaves)
    tr, te = stratified_split_indices(labels, 0.9, seed)
    folder = folder or tempfile.mkdtemp(prefix="taxonomy_study_")

    cpl = CplMixVAE(saving_folder=folder, seed=seed, device=device)
    cpl.init_model(n_categories=n_categories, input_dim=n_genes,
                   fc_dim=100, lowD_dim=10, n_arm=n_arm, tau=tau, lam=lam,
                   batch_size=batch_size, epochs_per_jit=epochs_per_jit)
    cpl.train(X[tr], x_val=X[te], n_epoch=n_epoch,
              early_stop_consensus=0.75, save_plots=False)
    best = os.path.join(folder, "cpl_mixVAE_model_best_train.ckpt")
    if os.path.exists(best):
        cpl.load_model(best)

    pred = cpl._predict_labels(X[te], 1.0)     # (A, N_test)
    truth = labels[te]
    leaf_ami = [float(adjusted_mutual_info_score(truth, arm))
                for arm in pred]
    levels = merge_sweep(tree, truth, pred)
    best_level = max(levels, key=lambda r: float(np.mean(r["ami"]))) \
        if levels else None

    out = {
        "folder": folder,
        "n_leaves": n_leaves,
        "n_categories": n_categories,
        "leaf_ami": leaf_ami,
        "levels": levels,
        "best_level": best_level,
    }

    if save_plots:
        from dvae_tpu_torch.analysis.hierarchy_viz import (heatmap_plot,
                                                           hierarchy_plot)
        uniq = sorted(set(truth))
        # (K, T): each category's cell fraction per true leaf type
        mat = np.zeros((n_categories, len(uniq)))
        for c, t in zip(pred[0], truth):
            mat[int(c), uniq.index(t)] += 1
        mat /= np.maximum(mat.sum(axis=1, keepdims=True), 1)
        heatmap_plot(tree, mat, uniq, leaf_size=n_leaves,
                     save_path=os.path.join(folder,
                                            "category_type_heatmap.png"))
        top = int(np.bincount(pred[0].astype(int),
                              minlength=n_categories).argmax())
        hierarchy_plot(tree, mat[top], uniq,
                       save_path=os.path.join(
                           folder, "top_category_hierarchy.png"))
        import matplotlib.pyplot as plt
        plt.close("all")
        out["plots"] = ["category_type_heatmap.png",
                        "top_category_hierarchy.png"]

    if verbose:
        print(json.dumps(out, indent=2, default=float))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--cells", type=int, default=4000)
    ap.add_argument("--genes", type=int, default=400)
    ap.add_argument("--categories", type=int, default=0)
    ap.add_argument("--n_arm", type=int, default=2)
    ap.add_argument("--batch_size", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=4000)
    ap.add_argument("--folder", type=str, default="")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    out = run(depth=args.depth, n_cells=args.cells, n_genes=args.genes,
              n_categories=args.categories, n_arm=args.n_arm,
              batch_size=args.batch_size, n_epoch=args.epochs,
              folder=args.folder, device=args.device)
    return 0 if out["leaf_ami"] and np.isfinite(out["leaf_ami"]).all() else 1


if __name__ == "__main__":
    raise SystemExit(main())
