"""Train/test splits of the PyTorch port (numpy only).

Counterpart of the split half of dvae_tpu/data/pipeline.py (:41-65): the
same indices from the same seed.  Batching lives in the epoch runner
(``train/step.make_epoch_runner``), on the device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def train_test_split_indices(n: int, train_size: float, seed: Optional[int]):
    """Uniform shuffled split of ``range(n)`` (reference ``data_gen``,
    dataloader.py:73-83); ``train_size`` is a fraction or a count."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(train_size * n) if isinstance(train_size, float) else train_size
    return np.sort(perm[:n_train]), np.sort(perm[n_train:])


def stratified_split_indices(labels: np.ndarray, train_size: float,
                             seed: Optional[int]):
    """Per-label shuffled split: ``train_size`` of each label's cells go
    to the training set."""
    rng = np.random.default_rng(seed)
    train_ind, test_ind = [], []
    for ll in np.unique(labels):
        idx = np.where(labels == ll)[0]
        perm = rng.permutation(len(idx))
        k = int(train_size * len(idx))
        train_ind.append(idx[perm[:k]])
        test_ind.append(idx[perm[k:]])
    return np.concatenate(train_ind), np.concatenate(test_ind)
