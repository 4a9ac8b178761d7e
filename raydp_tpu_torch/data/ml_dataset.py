"""Sharded ML dataset: the DataFrame → trainer handoff.

The counterpart of ``raydp_tpu/data/ml_dataset.py``. A block is a
``pyarrow.Table`` (a DataFrame partition; a dict of equal-length numpy
columns is stored as one), an ``ObjectRef`` of a table in a session's
object store (read through the session's resolver), or a partition the
DataFrame engine's streaming executor is still producing
(:class:`~raydp_tpu_torch.dataframe.scheduler.PendingPartition`).
:meth:`MLDataset.from_df` hands a frame's partitions over in partition
order as they are, pending or landed, as the JAX package's session
branch does: the shard plan waits for every block's size, and the
loader's epoch-0 prefix streamer serves the first landed blocks before
it exists. The plan needs only each block's row count, which a ref
carries, so a ref is not read for it. Each block is read into a table
at most once, by whichever consumer reaches it first (zero-copy from a
segment of this node, chunked fetches from a client); the table takes
the block's place, and ``blocks`` keeps returning the refs of blocks
nobody read. A ref's node is kept for ``block_nodes``. Ranks of a gang
read their own slices of the refs with :func:`resolve_plan_tables`. The shard plan is the JAX package's: every
shard yields exactly ``ceil(total_rows / num_shards)`` rows per epoch,
padding by reuse; given the node of each rank (``rank_nodes``), each
rank drains the blocks of its own node first (``divide_blocks_local``).
"""
from __future__ import annotations

import math
import threading
from typing import Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from raydp_tpu_torch.dataframe.scheduler import is_pending, resolve_one
from raydp_tpu_torch.store.object_store import ObjectRef
from raydp_tpu_torch.utils.sharding import (
    BlockSlice,
    divide_blocks,
    divide_blocks_local,
    locality_fraction,
)

Columns = Dict[str, np.ndarray]


def _checked(block):
    """A block as stored: a dict of numpy columns of one length becomes
    a ``pyarrow.Table``; tables, refs and pending partitions are kept as
    they are."""
    if is_pending(block) or isinstance(block, ObjectRef):
        return block
    import pyarrow as pa

    if isinstance(block, Mapping):
        cols = {str(k): np.asarray(v) for k, v in block.items()}
        lengths = {len(c) for c in cols.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"block columns differ in length: {sorted(lengths)}")
        return pa.table(cols)
    if not isinstance(block, pa.Table):
        raise TypeError(f"a block is a dict of numpy columns, a "
                        f"pyarrow.Table or an ObjectRef, got "
                        f"{type(block).__name__}")
    return block


class MLDataset:
    """An immutable list of blocks and a shard plan over them."""

    def __init__(self, blocks: Sequence, num_shards: int,
                 shuffle: bool = False, shuffle_seed: Optional[int] = None,
                 store=None, rank_nodes: Optional[Sequence[str]] = None):
        """``store`` reads ``ObjectRef`` blocks (a session's resolver;
        without one, the process's ambient resolver or store);
        ``rank_nodes`` (one node id per shard rank) turns on
        locality-preferring shard plans."""
        if not blocks:
            raise ValueError("MLDataset needs at least one block")
        if len(blocks) < num_shards:
            raise ValueError(f"{len(blocks)} blocks cannot feed {num_shards} "
                             "shards; split the data into more blocks")
        self._blocks: List = [_checked(b) for b in blocks]
        # One lock a block: a block is read into a table once, whichever
        # consumer (prefix streamer, plan, schema) reaches it first.
        self._block_mu = [threading.Lock() for _ in self._blocks]
        self._nodes: List[Optional[str]] = [
            b.node_id if isinstance(b, ObjectRef) else None
            for b in self._blocks]
        self.num_shards = num_shards
        self.shuffle = shuffle
        self.shuffle_seed = shuffle_seed
        self._store = store
        self.rank_nodes = list(rank_nodes) if rank_nodes is not None else None
        self.block_nodes: Optional[List[Optional[str]]] = None
        # The plan needs every block's size, so it waits until a
        # consumer asks (_ensure_plan); the epoch-0 prefix streamer reads
        # only the monotone lower bound in _known and never waits on it.
        self._plan_mu = threading.Lock()
        self._known: List[Optional[int]] = [
            None if is_pending(b) else _rows(b) for b in self._blocks]
        self._block_sizes: Optional[List[int]] = None
        self._shard_plan: Optional[Dict[int, List[BlockSlice]]] = None
        for i, b in enumerate(self._blocks):
            if is_pending(b):
                b.future.add_done_callback(
                    lambda f, i=i: self._note_block(i, f))
        if not any(is_pending(b) for b in self._blocks):
            self._ensure_plan()

    # -- constructors ---------------------------------------------------
    @staticmethod
    def from_df(df, num_shards: int, shuffle: bool = False,
                shuffle_seed: Optional[int] = None,
                rank_nodes: Optional[Sequence[str]] = None) -> "MLDataset":
        """From a :class:`raydp_tpu_torch.dataframe.DataFrame`, one block
        per partition in partition order; repartitions up to
        ``num_shards`` if short.

        A frame on a live session's cluster hands over its partitions as
        the JAX package's does (``raydp_tpu/data/ml_dataset.py:209-228``):
        each ``ObjectRef`` is transferred to the holder and read by the
        session's resolver (a zero-copy table over the mapped segment on
        this node, chunked fetches from a client); a partition still
        being produced stays pending. A local frame's partitions are
        taken as they are. ``rank_nodes`` (one node id per shard rank)
        turns on locality-preferring shard plans."""
        if df.num_partitions < num_shards:
            df = df.repartition(num_shards)
        from raydp_tpu_torch.context import current_session

        session = current_session()
        parts = df._to_block_parts() if session is not None else None
        if parts is None:
            return MLDataset(list(df._flush()._parts), num_shards, shuffle,
                             shuffle_seed, rank_nodes=rank_nodes)
        return MLDataset(parts, num_shards, shuffle, shuffle_seed,
                         store=session.cluster.resolver,
                         rank_nodes=rank_nodes)

    @staticmethod
    def from_refs(refs: Sequence[ObjectRef], num_shards: int,
                  shuffle: bool = False, shuffle_seed: Optional[int] = None,
                  rank_nodes: Optional[Sequence[str]] = None) -> "MLDataset":
        """Directly from ObjectRefs (parity with the reference's
        ``ray.data.from_arrow_refs`` entry, dataset.py:470-480), read
        through the live session's node-aware resolver."""
        from raydp_tpu_torch.context import require_session

        session = require_session()
        return MLDataset(list(refs), num_shards, shuffle, shuffle_seed,
                         store=session.cluster.resolver,
                         rank_nodes=rank_nodes)

    @staticmethod
    def from_parquet(paths: Union[str, Sequence[str]], num_shards: int,
                     shuffle: bool = False,
                     shuffle_seed: Optional[int] = None,
                     columns: Optional[List[str]] = None) -> "MLDataset":
        """One block per parquet row group."""
        import pyarrow.parquet as pq

        from raydp_tpu_torch.dataframe.io import _expand

        files = (_expand(paths, (".parquet", ".pq"))
                 if isinstance(paths, str) else list(paths))
        tables = []
        for f in files:
            pf = pq.ParquetFile(f)
            for rg in range(pf.num_row_groups):
                tables.append(pf.read_row_group(rg, columns=columns))
        return MLDataset(tables, num_shards, shuffle, shuffle_seed)

    def to_df(self):
        """Back to a DataFrame, one partition per block."""
        import pyarrow as pa

        from raydp_tpu_torch.dataframe.io import _distribute

        self._ensure_plan()
        return _distribute([self._table(i) for i in range(len(self._blocks))])

    # -- pending blocks -------------------------------------------------
    def has_pending_blocks(self) -> bool:
        """True while any block is still being produced."""
        return any(is_pending(b) and not b.future.done()
                   for b in self._blocks)

    def known_rows(self) -> Tuple[int, bool]:
        """(sum of the block sizes known so far, whether all are known):
        a lower bound of ``total_rows`` that only grows as blocks land."""
        with self._plan_mu:
            vals = list(self._known)
        return (sum(v for v in vals if v is not None),
                all(v is not None for v in vals))

    def iter_prefix_tables(self) -> Iterator[Tuple[int, object]]:
        """``(block_index, block)`` in block order, waiting on each
        pending block in turn: the dataset's prefix streams out while
        later blocks are still being produced."""
        for i in range(len(self._blocks)):
            yield i, self._table(i)

    def _note_block(self, i: int, fut) -> None:
        """Done-callback of pending block ``i``: record its row count
        the moment it lands (feeds ``known_rows``)."""
        if fut.exception() is not None:
            return
        rows = _rows(fut.result())
        if rows is None:
            return  # unknowable without a read; prefix iteration fills it
        with self._plan_mu:
            if self._known[i] is None:
                self._known[i] = rows

    def _ensure_plan(self) -> None:
        """Wait for every block and build the shard plan; every shard
        accessor comes through here."""
        if self._shard_plan is not None:
            return
        # Outside the plan lock: wait for pending blocks, and read only
        # those whose row count is still unknown (a ref without one).
        sizes = []
        for i in range(len(self._blocks)):
            rows = self._landed(i)
            sizes.append(rows if rows is not None
                         else self._table(i).num_rows)
        with self._plan_mu:
            if self._shard_plan is not None:
                return
            nodes = list(self._nodes)
            self._block_sizes = sizes
            self._known = list(sizes)
            self.block_nodes = nodes
            # Locality-aware division when the consumer topology is
            # known and the blocks carry their nodes (reference:
            # locality-preferring shard selection, dataset.py:411-443).
            if self.rank_nodes is not None and any(
                    n is not None for n in nodes):
                self._shard_plan = divide_blocks_local(
                    sizes, self.num_shards, [n or "node-0" for n in nodes],
                    self.rank_nodes, self.shuffle, self.shuffle_seed)
            else:
                self._shard_plan = divide_blocks(
                    sizes, self.num_shards, self.shuffle, self.shuffle_seed)

    def _landed(self, i: int) -> Optional[int]:
        """Wait for block ``i`` if it is pending and put what landed (a
        table or a ref, unread) in its place; returns its row count where
        known without a read."""
        with self._block_mu[i]:
            block = self._blocks[i]
            if is_pending(block):
                block = resolve_one(block)
                with self._plan_mu:
                    self._blocks[i] = block
                    if isinstance(block, ObjectRef):
                        self._nodes[i] = block.node_id
            rows = _rows(block)
            if rows is not None:
                with self._plan_mu:
                    if self._known[i] is None:
                        self._known[i] = rows
            return rows

    def _table(self, i: int):
        """Block ``i`` as a table, read at most once: waits for a pending
        partition and reads a ref through the dataset's store (else the
        process's ambient resolver or store), then keeps the table in
        the block's place and the ref's node in ``_nodes``."""
        with self._block_mu[i]:
            block = self._blocks[i]
            if not (is_pending(block) or isinstance(block, ObjectRef)):
                return block
            block = resolve_one(block)
            node = None
            if isinstance(block, ObjectRef):
                node = block.node_id
                if self._store is not None:
                    block = self._store.get_arrow_table(block)
                else:
                    from raydp_tpu_torch.store.object_store import (
                        resolve_ambient_table,
                    )

                    block = resolve_ambient_table(block)
            with self._plan_mu:
                self._nodes[i] = node
                self._blocks[i] = block
                if self._known[i] is None:
                    self._known[i] = block.num_rows
            return block

    def locality(self) -> Optional[float]:
        """Fraction of planned samples that are node-local (None when no
        topology was supplied)."""
        if self.rank_nodes is None:
            return None
        self._ensure_plan()
        nodes = [n or "node-0" for n in self.block_nodes]
        return locality_fraction(self._shard_plan, nodes, self.rank_nodes)

    # -- introspection --------------------------------------------------
    @property
    def blocks(self) -> List:
        """The landed blocks (waits for pending ones): tables, and the
        refs of blocks no consumer has read."""
        self._ensure_plan()
        return list(self._blocks)

    @property
    def shard_plan(self) -> Dict[int, List[BlockSlice]]:
        self._ensure_plan()
        return self._shard_plan

    @property
    def block_sizes(self) -> List[int]:
        self._ensure_plan()
        return list(self._block_sizes)

    @property
    def total_rows(self) -> int:
        return sum(self.block_sizes)

    @property
    def rows_per_shard(self) -> int:
        return math.ceil(self.total_rows / self.num_shards)

    def schema(self):
        """The ``pyarrow.Schema`` of the blocks; reads only block 0 and
        never waits for the whole plan."""
        return self._table(0).schema

    # -- shard access ---------------------------------------------------
    def shard_global_indices(self, rank: int) -> np.ndarray:
        """The dataset row index (block order, then row order in a block)
        of every sample of ``rank``'s plan, in plan order: the inverse of
        the plan. Padding rows map to the row they repeat, so a scatter
        of per-shard predictions through these collapses onto
        ``total_rows`` rows."""
        plan = self.shard_plan
        if rank not in plan:
            raise IndexError(f"rank {rank} out of {self.num_shards}")
        starts = np.zeros(len(self._block_sizes), dtype=np.int64)
        starts[1:] = np.cumsum(self._block_sizes[:-1])
        parts = [starts[s.block_index] + s.offset
                 + np.arange(s.num_samples, dtype=np.int64)
                 for s in plan[rank]]
        if not parts:
            return np.empty((0,), dtype=np.int64)
        return np.concatenate(parts)

    def shard_tables(self, rank: int) -> List:
        """The (sliced) blocks of ``rank``'s plan, as tables."""
        plan = self.shard_plan
        if rank not in plan:
            raise IndexError(f"rank {rank} out of {self.num_shards}")
        blocks = [self._table(s.block_index) for s in plan[rank]]
        return [b if s.offset == 0 and s.num_samples == b.num_rows
                else b.slice(s.offset, s.num_samples)
                for s, b in zip(plan[rank], blocks)]

    def shard_columns(self, rank: int,
                      columns: Optional[List[str]] = None) -> Columns:
        """Shard ``rank`` materialised as contiguous numpy columns. Table
        slices are concatenated as tables first, as the JAX package does,
        so a column's numpy dtype is the one it gives."""
        import pyarrow as pa

        parts = self.shard_tables(rank)
        names = columns or self._table(0).column_names
        merged = (pa.concat_tables(parts, promote_options="default")
                  if len(parts) > 1 else parts[0])
        return {n: merged.column(n).to_numpy(zero_copy_only=False)
                for n in names}

    def to_torch(self, feature_columns: List[str],
                 label_column: Optional[str] = None, batch_size: int = 256,
                 rank: int = 0, shuffle: bool = True, seed: int = 0,
                 feature_dtype=np.float32, label_dtype=np.float32,
                 prefetch: int = 2, device="cuda", drop_last: bool = False,
                 transfer_coalesce: Optional[int] = None,
                 infeed_depth: int = 2):
        """The batch loader of shard ``rank`` onto ``device``
        (:class:`raydp_tpu_torch.data.loader.ShardLoader`): the JAX
        package's ``to_jax``. Its ``to_torch``, a host-side
        ``IterableDataset``, is :meth:`to_torch_dataset` here."""
        from raydp_tpu_torch.data.loader import ShardLoader

        return ShardLoader(
            self, rank=rank, feature_columns=feature_columns,
            label_column=label_column, batch_size=batch_size,
            shuffle=shuffle, seed=seed, feature_dtype=feature_dtype,
            label_dtype=label_dtype, prefetch=prefetch, device=device,
            drop_last=drop_last, transfer_coalesce=transfer_coalesce,
            infeed_depth=infeed_depth,
        )

    def to_torch_dataset(self, feature_columns: List[str], label_column: str,
                         batch_size: int = 256, rank: int = 0,
                         shuffle: bool = True, seed: int = 0):
        """Torch IterableDataset over this shard, CPU batches (API parity
        with the reference's TorchMLDataset, torch/torch_ml_dataset.py:
        25-111; the JAX package's ``to_torch``)."""
        from raydp_tpu_torch.data.torch_adapter import TorchShardDataset

        return TorchShardDataset(
            self, rank, feature_columns, label_column, batch_size, shuffle,
            seed,
        )


def _rows(block) -> Optional[int]:
    """A landed block's row count, None where a ref does not carry it."""
    rows = block.num_rows
    return None if rows is None or rows < 0 else int(rows)


def resolve_plan_tables(master_address: str, namespace: str,
                        blocks: Sequence[ObjectRef], plan: Sequence[BlockSlice],
                        node_id: Optional[str] = None) -> List:
    """A gang rank's shard straight from a session's object store: only
    the block slices of this rank's ``plan`` (``MLDataset.shard_plan[r]``)
    are read, each block once, zero-copy for segments on this node
    (``node_id``, default the driver's ``node-0``) and through the store
    agents' chunked ``FetchObjectChunk`` for the rest, as the JAX
    package's ``resolve_plan_tables`` reads them
    (``raydp_tpu/train/torch_estimator.py:171-220``). A segment missing
    here falls back to an agent fetch, so a wrong node identity costs
    remote reads, not a failure. Imports no torch."""
    from raydp_tpu_torch.cluster.rpc import RpcClient
    from raydp_tpu_torch.store.object_store import DEFAULT_NODE, ObjectStore
    from raydp_tpu_torch.store.resolver import ObjectResolver

    client = RpcClient(master_address, "raydp.AppMaster")
    store = ObjectStore(namespace=namespace, node_id=node_id or DEFAULT_NODE)

    def meta(object_id):
        reply = client.call("GetObjectMeta", {"object_id": object_id})
        return reply.get("ref"), reply.get("agent")

    resolver = ObjectResolver(store, meta)
    try:
        tables, cache = [], {}
        for s in plan:
            t = cache.get(s.block_index)
            if t is None:
                t = resolver.get_arrow_table(blocks[s.block_index])
                cache[s.block_index] = t
            tables.append(t.slice(s.offset, s.num_samples))
        return tables
    finally:
        resolver.close()
        client.close()
