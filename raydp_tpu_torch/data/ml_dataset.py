"""Sharded ML dataset over local blocks: the handoff into training.

The counterpart of ``raydp_tpu/data/ml_dataset.py`` for blocks that are
already in this process, the form the BERT fine-tune uses
(``MLDataset([table], num_shards=1)``). A block is a dict of equal-length
numpy columns, or a ``pyarrow.Table`` where pyarrow imports. The shard
plan is the JAX package's: every shard yields exactly
``ceil(total_rows / num_shards)`` rows per epoch, padding by reuse.
"""
from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np

from raydp_tpu_torch.utils.sharding import BlockSlice, divide_blocks

Columns = Dict[str, np.ndarray]


def _as_columns(block) -> Columns:
    """A block as a dict of numpy columns of one length."""
    if isinstance(block, Mapping):
        cols = {str(k): np.asarray(v) for k, v in block.items()}
    else:
        import pyarrow as pa

        if not isinstance(block, pa.Table):
            raise TypeError(f"a block is a dict of numpy columns or a "
                            f"pyarrow.Table, got {type(block).__name__}")
        cols = {name: block.column(name).to_numpy(zero_copy_only=False)
                for name in block.column_names}
    lengths = {len(c) for c in cols.values()}
    if len(lengths) > 1:
        raise ValueError(f"block columns differ in length: {sorted(lengths)}")
    return cols


class MLDataset:
    """An immutable list of local blocks and a shard plan over them."""

    def __init__(self, blocks: Sequence, num_shards: int,
                 shuffle: bool = False, shuffle_seed: Optional[int] = None):
        if not blocks:
            raise ValueError("MLDataset needs at least one block")
        if len(blocks) < num_shards:
            raise ValueError(f"{len(blocks)} blocks cannot feed {num_shards} "
                             "shards; split the data into more blocks")
        self._blocks: List[Columns] = [_as_columns(b) for b in blocks]
        self.num_shards = num_shards
        self.block_sizes = [len(next(iter(b.values()), ()))
                            for b in self._blocks]
        self.shard_plan: Dict[int, List[BlockSlice]] = divide_blocks(
            self.block_sizes, num_shards, shuffle, shuffle_seed
        )

    @property
    def total_rows(self) -> int:
        return sum(self.block_sizes)

    @property
    def rows_per_shard(self) -> int:
        return math.ceil(self.total_rows / self.num_shards)

    def shard_columns(self, rank: int,
                      columns: Optional[List[str]] = None) -> Columns:
        """Shard ``rank`` materialised as contiguous numpy columns."""
        if rank not in self.shard_plan:
            raise IndexError(f"rank {rank} out of {self.num_shards}")
        names = columns or list(self._blocks[0])
        plan = self.shard_plan[rank]
        return {
            name: np.concatenate([
                self._blocks[s.block_index][name][s.offset:
                                                  s.offset + s.num_samples]
                for s in plan
            ])
            for name in names
        }

    def to_torch(self, feature_columns: List[str],
                 label_column: Optional[str] = None, batch_size: int = 256,
                 rank: int = 0, shuffle: bool = True, seed: int = 0,
                 feature_dtype=np.float32, label_dtype=np.float32,
                 prefetch: int = 2, device="cuda", drop_last: bool = False,
                 transfer_coalesce: Optional[int] = None):
        """The batch loader of shard ``rank`` onto ``device``
        (:class:`raydp_tpu_torch.data.loader.ShardLoader`)."""
        from raydp_tpu_torch.data.loader import ShardLoader

        return ShardLoader(
            self, rank=rank, feature_columns=feature_columns,
            label_column=label_column, batch_size=batch_size,
            shuffle=shuffle, seed=seed, feature_dtype=feature_dtype,
            label_dtype=label_dtype, prefetch=prefetch, device=device,
            drop_last=drop_last, transfer_coalesce=transfer_coalesce,
        )
