"""Input transforms of the PyTorch port (numpy only).

The port's own copy of ``normalize_cellxgene`` and ``logcpm`` of
dvae_tpu/utils/tools.py:106-116 (reference mmidas/utils/tools.py:61-83).
"""

from __future__ import annotations

import numpy as np


def normalize_cellxgene(x: np.ndarray) -> np.ndarray:
    """L1-normalize each cell's expression row (reference :61-70)."""
    x = np.asarray(x, dtype=np.float64)
    sums = np.abs(x).sum(axis=1, keepdims=True)
    sums[sums == 0] = 1.0
    return x / sums


def logcpm(x: np.ndarray, scaler: float = 1e6) -> np.ndarray:
    """log1p counts-per-million (reference :73-83)."""
    return np.log1p(normalize_cellxgene(x) * scaler)
