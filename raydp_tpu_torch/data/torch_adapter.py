"""Torch interop: iterate an MLDataset shard as a torch IterableDataset
(the port's copy of ``raydp_tpu/data/torch_adapter.py``).

API parity with the reference's torch adapters
(reference: python/raydp/torch/torch_ml_dataset.py:25-111 —
TorchMLDataset/PrefetchedDataLoader). The difference from the JAX
package: there ``MLDataset.to_torch`` returns this dataset, and the
device path is ``to_jax``; in the port ``MLDataset.to_torch`` is the
device loader itself (a :class:`~raydp_tpu_torch.data.loader.ShardLoader`
onto the card), so this host-side dataset for a user's own
``DataLoader`` is ``MLDataset.to_torch_dataset``. Its batches are CPU
tensors, drawn from the shard's loader with ``device="cpu"`` and
``prefetch=0``.
"""
from __future__ import annotations

import torch
from torch.utils.data import IterableDataset


class TorchShardDataset(IterableDataset):
    """``torch.utils.data.IterableDataset`` over one shard's
    ``(features, labels)`` batches."""

    def __init__(self, dataset, rank, feature_columns, label_column,
                 batch_size, shuffle, seed):
        super().__init__()
        self._loader = dataset.to_torch(
            feature_columns=feature_columns,
            label_column=label_column,
            batch_size=batch_size,
            rank=rank,
            shuffle=shuffle,
            seed=seed,
            prefetch=0,
            device="cpu",
        )

    def __iter__(self):
        # Under DataLoader(num_workers>0) torch replicates the
        # IterableDataset per worker; split batches round-robin so
        # samples aren't duplicated (reference guards likewise via
        # get_worker_info, torch_ml_dataset.py:25-60).
        info = torch.utils.data.get_worker_info()
        wid = info.id if info is not None else 0
        nworkers = info.num_workers if info is not None else 1
        for i, (x, y) in enumerate(self._loader):
            if i % nworkers != wid:
                continue
            yield x, y

    def __len__(self):
        return len(self._loader)
