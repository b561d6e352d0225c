"""Taxonomy-aligned visualization of discovered categories, PyTorch port.

Counterpart of dvae_tpu/analysis/hierarchy_viz.py (reference
``mmidas/utils/celltype_hierarchy.py``):
  * ``cell_nodes_dict`` :10-18 — node → ancestor-chain lookup (all nodes
    up to ``num_cell``, matching the reference's enumeration); pure numpy.
  * ``hierarchy_plot`` :20-75 — dendrogram skeleton with per-category
    probability bars over the leaves; returns (ax, fig).
  * ``heatmap_plot`` :77-170 — category × cell-type assignment heatmap laid
    out in taxonomy order; returns (fig, matrix).
  * ``dent_plot`` :172+ — dendrogram + per-category markers; returns fig.

The three plots need matplotlib, imported inside ``_plt()``; the module
imports without it.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from dvae_tpu_torch.analysis.taxonomy import HTree


def cell_nodes_dict(tree: HTree, num_cell: int = 132) -> dict:
    """Node name → ancestor chain for the first ``num_cell`` + 1 nodes,
    leaves and internal alike (reference :10-18 enumerates all children)."""
    out = {}
    for i, s in enumerate(tree.child):
        if i <= num_cell:
            out[s] = tree.get_ancestors(s)
    return out


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _draw_skeleton(ax, tree: HTree, skip_parents: Sequence[str] = (),
                   flip_y: bool = True):
    xx, yy = tree.x, np.nan_to_num(tree.y)
    sgn = -1.0 if flip_y else 1.0
    for p in np.unique(tree.parent):
        if p in skip_parents:
            continue
        sel = tree.child == p
        if not sel.any():
            continue
        xp, yp = float(xx[sel][0]), float(yy[sel][0])
        for c in tree.child[tree.parent == p]:
            cs = tree.child == c
            xc, yc = float(xx[cs][0]), float(yy[cs][0])
            ax.plot([xc, xc], [sgn * yc, sgn * yp], color="#BBBBBB")
            ax.plot([xc, xp], [sgn * yp, sgn * yp], color="#BBBBBB")


def hierarchy_plot(tree: HTree, p_cat: np.ndarray,
                   unique_types: Sequence[str],
                   skip_parents: Sequence[str] = (),
                   save_path: Optional[str] = None):
    """Dendrogram + per-leaf probability bars (reference :20-75).

    ``p_cat``: per-type probability mass (e.g. a category's posterior
    aggregated per type); ``unique_types``: the type names indexing p_cat.
    """
    plt = _plt()
    fig = plt.figure(figsize=(9, 3))
    ax = fig.gca()
    _draw_skeleton(ax, tree, skip_parents)

    leaves = tree.child[tree.isleaf]
    xs = tree.x[tree.isleaf]
    cols = tree.col[tree.isleaf]
    unique_types = list(unique_types)
    for leaf, x, col in zip(leaves, xs, cols):
        # climb until the leaf (or an ancestor) appears in unique_types
        node = leaf
        while node not in unique_types:
            anc = tree.get_ancestors(node)
            if not anc:
                node = None
                break
            node = anc[0]
        if node is None:
            continue
        h = float(p_cat[unique_types.index(node)])
        ax.plot(x, 0, "s", c=col, ms=1)
        ax.bar(x, height=h, width=1, bottom=0.03, align="center", color=col)
    ax.axis("off")
    ax.set_ylim([-0.5, 1.1])
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return ax, fig


def heatmap_plot(tree: HTree, cluster_per_cat: np.ndarray,
                 unique_types: Sequence[str], leaf_size: int,
                 markSize: int = 1, save_path: Optional[str] = None):
    """Category × taxonomy-ordered-type heatmap (reference :77-170).

    ``cluster_per_cat``: (K, T) fraction of each category's cells falling
    in each type; columns are re-ordered by the tree's leaf x positions.
    """
    plt = _plt()
    leaves = tree.child[tree.isleaf][:leaf_size]
    order = np.argsort(tree.x[tree.isleaf][:leaf_size])
    unique_types = list(unique_types)
    col_idx = [unique_types.index(l) for l in leaves[order]
               if l in unique_types]
    mat = cluster_per_cat[:, col_idx]

    fig, (ax_tree, ax_heat) = plt.subplots(
        2, 1, figsize=(10, 6), gridspec_kw={"height_ratios": [1, 3]})
    _draw_skeleton(ax_tree, tree, flip_y=False)
    ax_tree.axis("off")
    im = ax_heat.imshow(mat, aspect="auto", cmap="binary",
                        interpolation="nearest")
    ax_heat.set_xlabel("cell types (taxonomy order)")
    ax_heat.set_ylabel("categories")
    fig.colorbar(im, ax=ax_heat, fraction=0.02)
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return fig, mat


def dent_plot(tree: HTree, cluster_per_cat: np.ndarray,
              types: Optional[np.ndarray] = None,
              save_path: Optional[str] = None):
    """Dendrogram with per-category dominant-type markers (reference :172+,
    which renders the matrix as a styled heatmap; the markers here place
    each category over its dominant taxonomy leaf).

    ``types``: the (T,) leaf names labelling ``cluster_per_cat``'s columns
    (``heatmap_plot`` builds the matrix in ``np.unique`` type order, which
    is generally NOT the dendrogram's left-to-right leaf order).  When
    omitted, columns are assumed to already be in tree leaf order.
    """
    plt = _plt()
    fig = plt.figure(figsize=(10, 4))
    ax = fig.gca()
    _draw_skeleton(ax, tree)
    leaf_names = np.asarray(tree.child)[tree.isleaf]
    xs = tree.x[tree.isleaf]
    if types is not None:
        # map each column's type name to that leaf's x position
        pos = {str(n): float(x) for n, x in zip(leaf_names, xs)}
        col_x = np.array([pos.get(str(t), np.nan) for t in types])
    else:
        col_x = np.asarray(xs, float)
    dom = np.argmax(cluster_per_cat, axis=1)
    for k, t in enumerate(dom):
        if t < len(col_x) and np.isfinite(col_x[t]):
            ax.plot(col_x[t], 0.05 + 0.02 * k, ".", ms=3)
    ax.axis("off")
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return fig
