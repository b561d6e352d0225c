"""Synthetic single-cell expression made on the device from a seed.

The model of the counts follows the port's hard synthetic data
(``dvae_tpu_torch/data/anndata_io.hard_synthetic_dataset``), copied here
so that the inputs do not move when the program does: root expression
programs, leaf types that perturb a few percent of their root's genes,
Dirichlet type abundances, log-normal library sizes and per-gene zero
inflation, strongest for weakly expressed genes (a median library of 4
counts a gene puts about 0.70 of the entries at zero, as the port's hard
synthetic data read 0.68).  The small tables (types
by genes) are drawn with numpy on the host; the cells are drawn on the
device with one ``torch.Generator`` in large chunks.  The count given a
cell's mean is a floored exponential: a negative binomial of inverse
dispersion 1 (a geometric count), which needs one uniform an element.

``kind`` ``"logcpm"``: log1p counts per million (what the MSE model is
trained on, ``dvae_tpu_torch/utils/tools.logcpm``); ``"log1p"``: log1p of
the counts themselves (what the ZINB loss turns back into counts).
"""

from __future__ import annotations

import numpy as np
import torch

KINDS = ("logcpm", "log1p")


def tables(seed: int, n_genes: int, n_types: int = 92, n_roots: int = 12,
           marker_frac: float = 0.03, root_frac: float = 0.4,
           zi_max: float = 0.5) -> dict:
    """Per-type expression proportions (T, D), type abundances (T,), and
    per-gene zero-inflation probabilities (D,), from ``seed``."""
    rng = np.random.default_rng([int(seed), 0x7AB1E5])
    base = rng.gamma(0.3, 1.0, n_genes)
    roots = np.tile(base, (n_roots, 1))
    for r in range(n_roots):
        sel = rng.random(n_genes) < root_frac
        roots[r, sel] *= rng.lognormal(0.0, 1.5, sel.sum())
    leaf_root = np.sort(rng.integers(0, n_roots, n_types))
    progs = roots[leaf_root].copy()
    for t in range(n_types):
        sel = rng.random(n_genes) < marker_frac
        progs[t, sel] *= rng.lognormal(0.0, 1.0, sel.sum())
    props = progs / progs.sum(axis=1, keepdims=True)
    abund = rng.dirichlet(np.full(n_types, 1.5))
    abund = np.maximum(abund, 0.3 / n_types)
    abund /= abund.sum()
    mean_prop = (abund[:, None] * props).sum(axis=0)
    zi = np.clip(zi_max * np.exp(-2e4 * mean_prop), 0.01, zi_max)
    return {"props": props.astype(np.float32),
            "abund": abund.astype(np.float32),
            "zi": zi.astype(np.float32),
            "lib_mu": float(np.log(4.0 * n_genes)), "lib_sigma": 0.6}


def fill(out: torch.Tensor, seed: int, kind: str, chunk: int = 50_000,
         tab: dict = None) -> torch.Tensor:
    """Fill ``out`` (N, D) f32 on its device with cells drawn from
    ``seed``; returns ``out``."""
    if kind not in KINDS:
        raise ValueError(f"unknown data kind {kind!r}")
    n, d = out.shape
    dev = out.device
    tab = tab or tables(seed, d)
    props = torch.as_tensor(tab["props"], device=dev)
    abund = torch.as_tensor(tab["abund"], device=dev)
    keep_p = 1.0 - torch.as_tensor(tab["zi"], device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) & ((1 << 63) - 1))
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        rows = hi - lo
        types = torch.multinomial(abund, rows, replacement=True,
                                  generator=gen)
        lib = torch.exp(tab["lib_mu"] + tab["lib_sigma"] * torch.randn(
            rows, 1, generator=gen, device=dev))
        mean = props.index_select(0, types).mul_(lib)
        u = torch.rand(rows, d, generator=gen, device=dev)
        # floor(Exponential(mean)): −mean·log(1 − u), 1 − u in (0, 1]
        counts = torch.floor(mean.mul_(torch.log1p(-u).neg_()))
        u = torch.rand(rows, d, generator=gen, device=dev)
        counts.mul_(u < keep_p)
        if kind == "logcpm":
            total = counts.sum(dim=1, keepdim=True)
            counts.mul_(torch.where(total > 0, 1e6 / total,
                                    torch.zeros_like(total)))
        out[lo:hi] = counts.log1p_()
        del mean, counts, u
    return out


def make(n: int, d: int, seed: int, kind: str, device,
         chunk: int = 50_000) -> torch.Tensor:
    """A new (n, d) f32 matrix of cells on ``device``."""
    out = torch.empty((n, d), dtype=torch.float32, device=device)
    return fill(out, seed, kind, chunk)
