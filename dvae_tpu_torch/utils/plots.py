"""Training artifacts of the PyTorch port: loss curves and consensus-matrix
images.

The port's own copy of dvae_tpu/utils/plots.py (reference loss-curve PNGs,
mmidas/cpl_mixvae.py:931-945, :1418-1443, and arm-pair consensus matrices
with agreement-sorted axes, :820-850, :893-925).  matplotlib is imported
inside the functions, so the port runs without it: the artifact set is
then skipped with a message.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from dvae_tpu_torch.eval.metrics import compute_confmat, confmat_normalize


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def loss_curve_plot(history: Sequence[dict], keys: Sequence[str] = (),
                    save_path: Optional[str] = None, title: str = ""):
    """Plot metric curves from a MetricLogger history (list of dicts)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 4))
    if not keys:
        keys = sorted({k for row in history for k in row
                       if k.endswith("/loss")})
    for k in keys:
        xs = [r.get("step", i) for i, r in enumerate(history) if k in r]
        ys = [r[k] for r in history if k in r]
        if ys:
            ax.plot(xs, ys, label=k)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300)
    return fig


def consensus_matrix_plot(cm: np.ndarray, arm_a: int = 0, arm_b: int = 1,
                          sort: bool = True,
                          save_path: Optional[str] = None):
    """Normalized arm-pair confusion matrix image, axes ordered by
    per-category agreement (reference cpl_mixvae.py:820-850: imshow of
    ``armA_vs_armB[:, ind_sort][ind_sort]`` in the 'binary' colormap)."""
    plt = _plt()
    if sort:
        order = np.argsort(np.diag(cm))[::-1]
        cm = cm[:, order][order]
    fig, ax = plt.subplots()
    im = ax.imshow(cm, cmap="binary")
    fig.colorbar(im, ax=ax)
    ax.set_xlabel(f"arm_{arm_a}", fontsize=14)
    ax.set_ylabel(f"arm_{arm_b}", fontsize=14)
    ax.set_title(f"|c|={cm.shape[0]}", fontsize=14)
    ax.set_xticks([])
    ax.set_yticks([])
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return fig


def save_training_artifacts(folder: str, history: Sequence[dict],
                            labels: Optional[np.ndarray] = None,
                            K: Optional[int] = None,
                            tag: str = "") -> list[str]:
    """Write the end-of-training artifact set (the loss curve and every
    arm pair's consensus matrix) as the reference does on early stop or
    finish; returns the paths written.  Without matplotlib it prints
    "plot artifacts skipped: ..." and writes nothing."""
    os.makedirs(folder, exist_ok=True)
    written = []
    try:
        p = os.path.join(folder, f"loss_curve{tag}.png")
        loss_curve_plot(history, save_path=p)
        written.append(p)
        if labels is not None and K:
            A = labels.shape[0]
            for a in range(A):
                for b in range(a + 1, A):
                    cm = confmat_normalize(
                        compute_confmat(labels[a], labels[b], K))
                    p = os.path.join(
                        folder, f"consensus{tag}_arm_{a}_arm_{b}.png")
                    consensus_matrix_plot(cm, a, b, save_path=p)
                    written.append(p)
    except Exception as e:  # matplotlib unavailable
        print(f"plot artifacts skipped: {e}")
    return written
