"""Config loading, input transforms and gene ranking of the PyTorch port
(numpy and the standard library only).

The port's own copy of dvae_tpu/utils/tools.py (reference
mmidas/utils/tools.py): ``get_paths`` (:27, a cached TOML loader that
resolves the per-dataset sections of ``dvae.toml`` against the working
directory), ``normalize_cellxgene`` and ``logcpm`` (:106-116, log1p CPM)
and ``reorder_genes`` (:119, genes ranked by the spread of their
binarized expression).  ``download_file`` and ``enable_compile_cache`` are
not carried: the port reads no network and compiles no XLA.
"""

from __future__ import annotations

import os
from functools import lru_cache
from pathlib import Path
from typing import Any

import numpy as np


@lru_cache(maxsize=None)
def get_paths(toml_file: str, sub_file: str = "files",
              verbose: bool = False) -> dict[str, Any]:
    """Load a TOML config and resolve existing paths to ``Path`` objects.

    ``config['paths']['main_dir']`` is the working directory; values of
    [paths] and of the ``sub_file`` dataset section become ``Path`` where
    they exist on disk.  A missing file gives {}."""
    import tomllib

    package_dir = Path(os.getcwd())
    config_file = package_dir / toml_file
    if not config_file.is_file():
        print(f"Did not find project`s toml file: {config_file}")
        return {}
    with open(config_file, "rb") as f:
        config = tomllib.load(f)
    config.setdefault("paths", {})["main_dir"] = package_dir
    if verbose:
        for key, val in config.items():
            print(f"{key}: {val}")
    for section in ("paths", sub_file):
        for k, v in list(config.get(section, {}).items()):
            if isinstance(v, str) and Path(v).exists():
                config[section][k] = Path(v)
    return config


def normalize_cellxgene(x: np.ndarray) -> np.ndarray:
    """L1-normalize each cell's expression row (reference :61-70)."""
    x = np.asarray(x, dtype=np.float64)
    sums = np.abs(x).sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    return x / sums


def logcpm(x: np.ndarray, scaler: float = 1e6) -> np.ndarray:
    """log1p counts-per-million (reference :73-83)."""
    return np.log1p(normalize_cellxgene(x) * scaler)


def reorder_genes(x: np.ndarray, chunksize: int = 1000,
                  eps: float = 1e-1) -> np.ndarray:
    """Gene indices ranked by the std of their binarized expression,
    descending (reference :86-103); genes whose binarized std is at most
    ``eps`` are dropped.  Walks the genes in chunks to bound memory."""
    t_gene = x.shape[1]
    g_bin_std = []
    for i in range(t_gene // chunksize + 1):
        lo, hi = i * chunksize, min(t_gene, (i + 1) * chunksize)
        if lo >= hi:
            break
        x_bin = np.where(x[:, lo:hi] > eps, 1, 0)
        g_bin_std.append(np.std(x_bin, axis=0))
    g_bin_std = np.concatenate(g_bin_std)
    order = np.argsort(g_bin_std)
    kept = order[np.sort(g_bin_std) > eps]
    return kept[::-1]
