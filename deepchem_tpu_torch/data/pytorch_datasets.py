"""A dataset as a ``torch.utils.data.IterableDataset``, split among a
``DataLoader``'s workers and a process group's ranks, as the JAX
package's ``make_pytorch_dataset``."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _worker_shard() -> Tuple[int, int]:
    """``(first, step)``: this reader's share is every ``step``-th item
    from ``first``, over the ranks of an initialised process group and the
    workers of each."""
    first, step = 0, 1
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        first, step = dist.get_rank(), dist.get_world_size()
    info = torch.utils.data.get_worker_info()
    if info is not None:
        first = first * info.num_workers + info.id
        step = step * info.num_workers
    return first, step


class _TorchDataset(torch.utils.data.IterableDataset):

    def __init__(self, dataset, epochs: int, deterministic: bool,
                 batch_size: Optional[int]):
        self.dataset = dataset
        self.epochs = epochs
        self.deterministic = deterministic
        self.batch_size = batch_size

    def __iter__(self):
        first, step = _worker_shard()
        ds = self.dataset
        for _ in range(self.epochs):
            if self.batch_size is None:
                n = len(ds)
                order = np.arange(n) if self.deterministic \
                    else np.random.permutation(n)
                X, y, w, ids = ds.X, ds.y, ds.w, ds.ids
                for i in order[first::step]:
                    yield X[i], y[i], w[i], ids[i]
            else:
                for bi, batch in enumerate(ds.iterbatches(
                        batch_size=self.batch_size,
                        deterministic=self.deterministic)):
                    if (bi - first) % step == 0:
                        yield batch

    def __len__(self) -> int:
        return len(self.dataset) * self.epochs


def make_pytorch_dataset(dataset, epochs: int = 1,
                         deterministic: bool = False,
                         batch_size: Optional[int] = None
                         ) -> torch.utils.data.IterableDataset:
    """``dataset``'s samples (or, with ``batch_size``, its batches) for
    ``epochs`` epochs, in dataset order or (not ``deterministic``) a
    permutation from numpy's global stream an epoch, each reader taking
    its share (:func:`_worker_shard`)."""
    return _TorchDataset(dataset, epochs, deterministic, batch_size)
