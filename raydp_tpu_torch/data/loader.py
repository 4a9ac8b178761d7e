"""Host→device batch pipeline: gather, pack, prefetch, one copy per chunk.

The counterpart of ``JaxShardLoader`` (``raydp_tpu/data/loader.py``).
Per epoch:

1. the shard's columns are staged once as a row-major ``[n, F]`` feature
   matrix (and a label vector) in the requested dtypes;
2. the epoch's row order is the JAX package's,
   ``np.random.default_rng(seed + epoch * 1009 + rank).permutation(n)``,
   and ``drop_last`` trims the ragged tail the same way, so batches come
   in the same order with the same rows;
3. rows are gathered in chunks of ``transfer_coalesce`` batches (numpy
   ``take``), and features and labels are packed into one uint8 buffer per
   chunk;
4. a background thread keeps ``prefetch`` packed chunks ahead;
5. on a CUDA device each chunk is packed into a pinned host buffer and
   crosses with ONE ``non_blocking`` copy; the typed features and labels
   are recovered on the device with ``.view(dtype)``, and batches are
   device slices of the chunk. Pinned buffers form a ring: a buffer goes
   back to the producer with the CUDA event recorded after its copy, and
   the producer waits on that event before packing into it again.

On the CPU the same packing runs without pinning or copies.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

# Auto chunk sizing, as the JAX loader: coalesce batches until a chunk
# reaches this many bytes, at most 32 batches.
_TARGET_CHUNK_BYTES = 128 * 1024 * 1024
_MAX_COALESCE = 32
_LABEL_ALIGN = 8  # label bytes start on an 8-byte boundary for .view()


def _torch_dtype(dtype: np.dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


class _PinnedRing:
    """Pinned host buffers reused round-robin by one producer thread and
    one consumer. ``acquire`` hands out a buffer whose last copy has
    finished; ``release`` records the event that marks that."""

    def __init__(self, n: int, nbytes: int):
        self.bufs = [torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
                     for _ in range(n)]
        self._events = [torch.cuda.Event() for _ in range(n)]
        self._free: "queue.Queue[Tuple[int, bool]]" = queue.Queue()
        for i in range(n):
            self._free.put((i, False))

    def acquire(self, stop: threading.Event) -> Optional[int]:
        while not stop.is_set():
            try:
                slot, copied = self._free.get(timeout=0.1)
            except queue.Empty:
                continue
            if copied:
                self._events[slot].synchronize()
            return slot
        return None

    def release(self, slot: int, stream: torch.cuda.Stream) -> None:
        self._events[slot].record(stream)
        self._free.put((slot, True))


class ShardLoader:
    """Iterable over ``(features, labels)`` device batches of one shard
    (bare feature batches without a label column). Re-iterable: each
    ``iter()`` is the next epoch; :meth:`set_epoch` picks one."""

    def __init__(
        self,
        dataset,
        rank: int,
        feature_columns: List[str],
        label_column: Optional[str],
        batch_size: int,
        shuffle: bool,
        seed: int,
        feature_dtype,
        label_dtype,
        prefetch: int,
        device: DeviceLike,
        drop_last: bool,
        transfer_coalesce: Optional[int] = None,
    ):
        self._dataset = dataset
        self._rank = rank
        self.feature_columns = list(feature_columns)
        self.label_column = label_column
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.feature_dtype = np.dtype(feature_dtype)
        self.label_dtype = np.dtype(label_dtype)
        self.prefetch = max(0, prefetch)
        self.device = resolve_device(device)
        self.drop_last = drop_last
        self.transfer_coalesce = transfer_coalesce
        self._epoch = 0
        self._staged: Optional[Tuple[np.ndarray, Optional[np.ndarray]]] = None

    def __len__(self) -> int:
        n = self._dataset.rows_per_shard
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        return self._epoch_iter(epoch)

    # -- staging --------------------------------------------------------
    def _stage_matrix(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Columns → one row-major ``[n, F]`` matrix (a gathered row is
        contiguous), built once and reused every epoch."""
        if self._staged is None:
            wanted = self.feature_columns + (
                [self.label_column] if self.label_column else [])
            cols = self._dataset.shard_columns(self._rank, wanted)
            matrix = np.stack(
                [cols[c].astype(self.feature_dtype, copy=False)
                 for c in self.feature_columns], axis=1)
            labels = (cols[self.label_column].astype(self.label_dtype,
                                                      copy=False)
                      if self.label_column else None)
            self._staged = (matrix, labels)
        return self._staged

    def _coalesce_batches(self) -> int:
        """Batches per chunk: the explicit setting, else sized toward
        ``_TARGET_CHUNK_BYTES`` and capped at ``_MAX_COALESCE``."""
        if self.transfer_coalesce is not None:
            return max(1, self.transfer_coalesce)
        row_bytes = (len(self.feature_columns) * self.feature_dtype.itemsize
                     + (self.label_dtype.itemsize if self.label_column else 0))
        batch_bytes = max(1, self.batch_size * row_bytes)
        return int(min(_MAX_COALESCE,
                       max(1, _TARGET_CHUNK_BYTES // batch_bytes)))

    def _layout(self, rows: int) -> Tuple[int, int]:
        """(label byte offset, total bytes) of a packed chunk of ``rows``."""
        nb_x = rows * len(self.feature_columns) * self.feature_dtype.itemsize
        if not self.label_column:
            return nb_x, nb_x
        y_off = -(-nb_x // _LABEL_ALIGN) * _LABEL_ALIGN
        return y_off, y_off + rows * self.label_dtype.itemsize

    def _pack(self, out: np.ndarray, x: np.ndarray,
              y: Optional[np.ndarray]) -> None:
        y_off, _ = self._layout(len(x))
        out[:x.nbytes] = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
        if y is not None:
            out[y_off:y_off + y.nbytes] = (
                np.ascontiguousarray(y).view(np.uint8).reshape(-1))

    def _unpack(self, buf: torch.Tensor, rows: int):
        """Typed (features, labels) views of one packed chunk."""
        nf = len(self.feature_columns)
        nb_x = rows * nf * self.feature_dtype.itemsize
        x = buf[:nb_x].view(_torch_dtype(self.feature_dtype)).view(rows, nf)
        if not self.label_column:
            return x, None
        y_off, end = self._layout(rows)
        return x, buf[y_off:end].view(_torch_dtype(self.label_dtype))

    # -- epoch iteration ------------------------------------------------
    def _chunk_rows(self, epoch: int) -> Iterator[Tuple[np.ndarray,
                                                        Optional[np.ndarray]]]:
        """The epoch's rows, gathered ``coalesce × batch`` at a time."""
        matrix, labels = self._stage_matrix()
        n = matrix.shape[0]
        order = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch * 1009 + self._rank)
            order = rng.permutation(n)
        n_used = min(n, len(self) * self.batch_size)
        step = self._coalesce_batches() * self.batch_size
        for lo in range(0, n_used, step):
            hi = min(lo + step, n_used)
            if order is None:
                x = matrix[lo:hi]
                y = labels[lo:hi] if labels is not None else None
            else:
                idx = order[lo:hi]
                x = np.take(matrix, idx, axis=0)
                y = np.take(labels, idx) if labels is not None else None
            yield x, y

    def _epoch_iter(self, epoch: int):
        bs = self.batch_size
        on_cuda = self.device.type == "cuda"
        ring = None
        if on_cuda:
            chunk_rows = self._coalesce_batches() * bs
            ring = _PinnedRing(self.prefetch + 2, self._layout(chunk_rows)[1])
        stop = threading.Event()

        def packed():
            for x, y in self._chunk_rows(epoch):
                rows = len(x)
                nbytes = self._layout(rows)[1]
                if ring is None:
                    out = np.empty(nbytes, dtype=np.uint8)
                    self._pack(out, x, y)
                    yield out, rows
                else:
                    slot = ring.acquire(stop)
                    if slot is None:
                        return
                    self._pack(ring.bufs[slot].numpy()[:nbytes], x, y)
                    yield slot, rows

        source = packed()
        if self.prefetch > 0:
            source = _background(source, self.prefetch, stop)
        try:
            for handle, rows in source:
                nbytes = self._layout(rows)[1]
                if ring is None:
                    buf = torch.from_numpy(handle)
                else:
                    stream = torch.cuda.current_stream(self.device)
                    buf = torch.empty(nbytes, dtype=torch.uint8,
                                      device=self.device)
                    buf.copy_(ring.bufs[handle][:nbytes], non_blocking=True)
                    ring.release(handle, stream)
                x, y = self._unpack(buf, rows)
                for lo in range(0, rows, bs):
                    xb = x[lo:lo + bs]
                    yield (xb, y[lo:lo + bs]) if self.label_column else xb
        finally:
            # An abandoned epoch unblocks the producer so it exits.
            stop.set()


def _background(it: Iterator, depth: int, stop: threading.Event):
    """Run ``it`` in a daemon thread, buffering ``depth`` items. Setting
    ``stop`` makes the producer exit promptly; a producer error is raised
    on the consumer's side at its next pull."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: List[BaseException] = []

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in it:
                if not put(item):
                    return
        except BaseException as exc:  # surfaced on the consumer's side
            err.append(exc)
        put(done)

    threading.Thread(target=producer, daemon=True).start()

    def consume():
        while True:
            item = q.get()
            if err:
                raise err[0]
            if item is done:
                return
            yield item

    return consume()
