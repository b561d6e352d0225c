"""Train/test splits and host loaders of the PyTorch port (numpy only).

Counterpart of dvae_tpu/data/pipeline.py: the splits (:41-65), the same
indices from the same seed, and the host iterators ``BatchIterator``
(:89) and ``get_loaders`` (:130), the same batches.  Training batches its
data in the epoch runner (``train/step.make_epoch_runner``, on the
device) or the streamer (``data/stream.py``); ``shard_for_process``
arrives with the multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

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


# ---------------------------------------------------------------------------
# Host-side iterators (the torch DataLoader surface of the reference)
# ---------------------------------------------------------------------------

@dataclass
class BatchIterator:
    """Shuffling batch iterator over (x, index) pairs
    (dvae_tpu/data/pipeline.py:89).

    The reference train loader (B=5000, shuffle, drop_last,
    dataloader.py:123-132); with ``batch_size=1, shuffle=False, drop_last=
    False`` the test loader (:143-152); with ``shuffle=False`` over all rows
    the all-data loader (:155-168).  Epoch ``e`` of a shuffled iterator is
    ``default_rng((seed, e)).permutation(n)``, the streamer's plan."""

    x: np.ndarray            # (N, D) float32
    indices: np.ndarray      # (N,) global sample indices (for ref-prior
                             # gathers, reference cpl_mixvae.py:427-432)
    batch_size: int
    shuffle: bool = True
    drop_last: bool = True
    seed: int = 0

    def __post_init__(self):
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reference ``sampler.set_epoch``."""
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.indices)
        return (n // self.batch_size if self.drop_last
                else -(-n // self.batch_size))

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(self.indices)
        order = np.arange(n)
        if self.shuffle:
            order = np.random.default_rng(
                (self.seed, self._epoch)).permutation(n)
            self._epoch += 1
        for i in range(len(self)):
            sel = order[i * self.batch_size: (i + 1) * self.batch_size]
            yield self.x[sel], self.indices[sel]


def get_loaders(dataset: np.ndarray, label=(), seed: Optional[int] = None,
                batch_size: int = 128, train_size: float = 0.9,
                use_dist_sampler: bool = False, world_size: int = 1,
                rank: int = 0):
    """Reference loader factory (dvae_tpu/data/pipeline.py:130,
    dataloader.py:86-168): (train, test, alldata) ``BatchIterator``s of
    numpy (x, index) pairs: stratified shuffled drop_last train batches,
    B=1 sequential test, a sequential full pass.  A distributed sampler over
    several processes arrives with the multi-GPU slice."""
    if use_dist_sampler and world_size > 1:
        from dvae_tpu_torch.train.cpl_mixvae import _not_ported
        raise _not_ported("a distributed sampler over several processes",
                          "multi-GPU")
    dataset = np.asarray(dataset, dtype=np.float32)
    n = dataset.shape[0]
    if len(label) > 0:
        train_ind, test_ind = stratified_split_indices(
            np.asarray(label), train_size, seed)
    else:
        train_ind, test_ind = train_test_split_indices(n, train_size, seed)
    train = BatchIterator(dataset[train_ind], train_ind, batch_size,
                          shuffle=True, drop_last=True, seed=seed or 0)
    test = BatchIterator(dataset[test_ind], test_ind, 1,
                         shuffle=False, drop_last=False)
    alldata = BatchIterator(dataset, np.arange(n), batch_size,
                            shuffle=False, drop_last=False)
    return train, test, alldata
