"""Host→device batch pipeline: gather, pack, prefetch, one copy per chunk.

The counterpart of ``JaxShardLoader`` (``raydp_tpu/data/loader.py``).
Per epoch:

1. the shard's columns are staged once as contiguous numpy arrays (the
   label cast to its dtype);
2. the epoch's row order is the JAX package's,
   ``np.random.default_rng(seed + epoch * 1009 + rank).permutation(n)``,
   and ``drop_last`` trims the ragged tail the same way, so batches come
   in the same order with the same rows;
3. rows are gathered in chunks of ``transfer_coalesce`` batches straight
   from the columns into one uint8 buffer per chunk: the native row
   kernel (``native.gather_matrix``, ``raydp_tpu_torch/native``) writes
   the row-major ``[rows, F]`` features, the labels follow;
4. a background thread keeps ``prefetch`` packed chunks ahead;
5. on a CUDA device the chunk buffer is a pinned host buffer that
   crosses with ONE ``non_blocking`` copy; the typed features and labels
   are recovered on the device with ``.view(dtype)``, and batches are
   device slices of the chunk. Pinned buffers form a ring: a buffer goes
   back to the producer with the CUDA event recorded after its copy, and
   the producer waits on that event before gathering into it again.
   ``infeed_depth`` chunk copies (at least 1) are kept issued ahead of
   the chunk whose batches the step is consuming, as the JAX estimator's
   ``_sharded_prefetch`` window keeps its transfers in flight
   (``raydp_tpu/train/estimator.py:495-520``).

On the CPU the same gather runs into plain host buffers. Epoch 0 of rank
0, unshuffled over an unshuffled dataset whose blocks the DataFrame
engine is still producing, streams its prefix: whole chunks of the
blocks landed so far are served before the shard plan exists
(:meth:`ShardLoader._prefix_chunks`), as the JAX loader does.

Telemetry (``raydp_tpu/data/loader.py:161-214, 299-420, 495-505``): an
epoch with no job in scope mints a process-wide ``loader`` job; staging
the shard is an ``ingest/stage_matrix`` span and bills its bytes
(``staged_bytes``); each chunk's gather is an ``ingest/chunk`` span and
watchdog bracket, closed before the chunk is yielded, with a flight
record; a streamed block is an ``ingest/stream_block`` span under the
overlap counter; the host-to-device copy of a chunk (the JAX package's
``ingest/device_put``) is a watchdog bracket under the overlap counter,
host-side only (the copy stays ``non_blocking``). The prefetch thread
runs in the consumer's trace context, and the consumer's time blocked
on it is ``ingest/wait_seconds``.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import deque
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from raydp_tpu_torch.dataframe.scheduler import streaming_enabled
from raydp_tpu_torch.native import lib as native
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.telemetry import overlap as _overlap
from raydp_tpu_torch.telemetry import span
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.telemetry.propagation import current_context, propagated
from raydp_tpu_torch.utils.profiling import metrics
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

# Auto chunk sizing, as the JAX loader: coalesce batches until a chunk
# reaches this many bytes, at most 32 batches.
_TARGET_CHUNK_BYTES = 128 * 1024 * 1024
_MAX_COALESCE = 32
_LABEL_ALIGN = 8  # label bytes start on an 8-byte boundary for .view()
_NATIVE_OUT = (np.dtype(np.float32), np.dtype(np.int32))

# One chunk to gather: feature columns, label column, and the rows.
Chunk = Tuple[List[np.ndarray], Optional[np.ndarray], np.ndarray]


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
        infeed_depth: int = 2,
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
        self.infeed_depth = max(1, infeed_depth)
        self._epoch = 0
        self._staged: Optional[Tuple[List[np.ndarray],
                                     Optional[np.ndarray]]] = None

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
        # An epoch driven with no job in scope (a bare loader) bills its
        # ingest to a process-wide job of its own.
        if _acct.current_job() is None:
            _acct.set_process_job(_acct.mint_job("loader"))
        return self._epoch_iter(epoch)

    # -- staging --------------------------------------------------------
    def _stage_columns(self, cols) -> Tuple[List[np.ndarray],
                                            Optional[np.ndarray]]:
        """(contiguous feature columns, label column in its dtype)."""
        feats = [np.ascontiguousarray(cols[c]) for c in self.feature_columns]
        labels = (cols[self.label_column].astype(self.label_dtype,
                                                  copy=False)
                  if self.label_column else None)
        return feats, labels

    def _stage_shard(self) -> Tuple[List[np.ndarray], Optional[np.ndarray]]:
        """The shard's columns, staged once and reused every epoch."""
        if self._staged is None:
            wanted = self.feature_columns + (
                [self.label_column] if self.label_column else [])
            cols = self._dataset.shard_columns(self._rank, wanted)
            rows = len(cols[wanted[0]]) if wanted else 0
            with span("ingest/stage_matrix", rank=self._rank, rows=rows,
                      features=len(self.feature_columns)):
                feats, labels = self._stage_columns(cols)
            _acct.add_usage(
                _acct.STAGED_BYTES,
                sum(f.nbytes for f in feats)
                + (labels.nbytes if labels is not None else 0),
            )
            self._staged = feats, labels
        return self._staged

    def _coalesce_batches(self) -> int:
        """Batches per chunk: the explicit setting, else on a card sized
        toward ``_TARGET_CHUNK_BYTES`` and capped at ``_MAX_COALESCE``.
        On the CPU auto stays at 1, as the JAX loader's host path: there
        is no copy to amortize, and one batch a chunk keeps the prefetch
        memory small."""
        if self.transfer_coalesce is not None:
            return max(1, self.transfer_coalesce)
        if self.device.type != "cuda":
            return 1
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

    def _gather_into(self, out: np.ndarray, chunk: Chunk) -> int:
        """Gather ``chunk``'s rows into the packed layout in ``out``
        (uint8): row-major features cast to ``feature_dtype``, then the
        labels. Returns the rows."""
        feats, labels, idx = chunk
        rows, nf = len(idx), len(feats)
        y_off, _ = self._layout(rows)
        x = out[:rows * nf * self.feature_dtype.itemsize].view(
            self.feature_dtype).reshape(rows, nf)
        if self.feature_dtype in _NATIVE_OUT:
            native.gather_matrix(feats, idx, out_dtype=self.feature_dtype,
                                 out=x)
        else:
            for c, col in enumerate(feats):
                x[:, c] = col[idx].astype(self.feature_dtype, copy=False)
        if labels is not None:
            y = out[y_off:y_off + rows * self.label_dtype.itemsize].view(
                self.label_dtype)
            np.take(labels, idx, out=y)
        return rows

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
    def _chunks(self, epoch: int, start_row: int = 0) -> Iterator[Chunk]:
        """The epoch's rows, ``coalesce × batch`` at a time, from
        ``start_row`` (chunk-aligned: the rows a prefix stream served)."""
        feats, labels = self._stage_shard()
        n = len(feats[0]) if feats else 0
        order = None
        if self.shuffle:
            rng = np.random.default_rng(self.seed + epoch * 1009 + self._rank)
            order = rng.permutation(n)
        n_used = min(n, len(self) * self.batch_size)
        step = self._coalesce_batches() * self.batch_size
        for lo in range(start_row, n_used, step):
            hi = min(lo + step, n_used)
            idx = (np.arange(lo, hi, dtype=np.int64) if order is None
                   else order[lo:hi])
            yield feats, labels, idx

    def _streams_prefix(self, epoch: int) -> bool:
        """Whether this epoch starts with :meth:`_prefix_chunks`."""
        ds = self._dataset
        return (epoch == 0 and self._rank == 0 and not self.shuffle
                and self._staged is None and not ds.shuffle
                and ds.has_pending_blocks() and streaming_enabled())

    def _prefix_chunks(self, epoch: int) -> Iterator[Chunk]:
        """Epoch-0 prefix streamer: serve batches while later blocks are
        still being produced.

        Rank 0 of an unshuffled plan gets the dataset's prefix
        ``[0, ceil(total/num_shards))``, so rows of the first landed
        blocks ARE the head of this shard. ``known_rows()`` is a lower
        bound of ``total_rows``, so ``ceil(known/num_shards)`` never
        overshoots the shard's end: whole chunks below it are safe to
        serve before the plan exists. Once every block has landed, the
        rest of the epoch comes from :meth:`_chunks`, past what was
        served."""
        ds = self._dataset
        step = self._coalesce_batches() * self.batch_size
        wanted = self.feature_columns + (
            [self.label_column] if self.label_column else [])
        landed: List[dict] = []
        staged = emitted = 0
        for _, block in ds.iter_prefix_tables():
            # Staging a landed block is ingest work that overlaps the
            # still-running ETL tail.
            with _overlap.tracker.ingest(), \
                    span("ingest/stream_block", rank=self._rank,
                         rows=block.num_rows):
                landed.append({
                    n: block.column(n).to_numpy(zero_copy_only=False)
                    for n in wanted})
            staged += len(landed[-1][wanted[0]])
            known, complete = ds.known_rows()
            if complete:
                break
            bound = min(staged, -(-known // ds.num_shards))
            bound -= bound % self.batch_size  # batch-aligned
            if emitted + step > bound:
                continue
            feats, labels = self._stage_columns(
                {n: np.concatenate([b[n] for b in landed]) for n in wanted})
            while emitted + step <= bound:
                yield feats, labels, np.arange(emitted, emitted + step,
                                               dtype=np.int64)
                emitted += step
        metrics.counter_add("ingest/stream_prefix_rows", emitted)
        yield from self._chunks(epoch, start_row=emitted)

    def _epoch_iter(self, epoch: int):
        bs = self.batch_size
        on_cuda = self.device.type == "cuda"
        ring = None
        if on_cuda:
            chunk_rows = self._coalesce_batches() * bs
            ring = _PinnedRing(self.prefetch + 2, self._layout(chunk_rows)[1])
        stop = threading.Event()

        chunks = (self._prefix_chunks(epoch) if self._streams_prefix(epoch)
                  else self._chunks(epoch))

        rows_meter = metrics.meter("ingest/rows")
        bytes_meter = metrics.meter("ingest/bytes")

        def packed():
            for chunk in chunks:
                nbytes = self._layout(len(chunk[2]))[1]
                if ring is None:
                    handle = out = np.empty(nbytes, dtype=np.uint8)
                else:
                    handle = ring.acquire(stop)
                    if handle is None:
                        return
                    out = ring.bufs[handle].numpy()[:nbytes]
                # The span and the watchdog bracket close before the
                # yield: they cover the gather, not the generator's
                # suspension (which may last a whole step).
                with _watchdog.inflight("ingest/chunk", epoch=epoch,
                                        rank=self._rank), \
                        span("ingest/chunk", epoch=epoch, rank=self._rank,
                             rows=len(chunk[2])):
                    rows = self._gather_into(out, chunk)
                rows_meter.add(rows)
                bytes_meter.add(nbytes)
                _flight.record("loader", "chunk", epoch=epoch,
                               rank=self._rank, rows=rows)
                yield handle, rows

        source = packed()
        if self.prefetch > 0:
            source = _background(source, self.prefetch, stop)

        def batches(buf, rows):
            x, y = self._unpack(buf, rows)
            for lo in range(0, rows, bs):
                xb = x[lo:lo + bs]
                yield (xb, y[lo:lo + bs]) if self.label_column else xb

        # Chunks copied to the device whose batches are not served yet:
        # up to infeed_depth beyond the one being served.
        window: deque = deque()
        try:
            for handle, rows in source:
                nbytes = self._layout(rows)[1]
                if ring is None:
                    yield from batches(torch.from_numpy(handle), rows)
                    continue
                # A host-to-device copy that never completes is a
                # silent hang: bracketed for the watchdog (host-side
                # bookkeeping; the copy stays asynchronous).
                with _overlap.tracker.ingest(), \
                        _watchdog.inflight("ingest/device_put",
                                           rank=self._rank):
                    stream = torch.cuda.current_stream(self.device)
                    buf = torch.empty(nbytes, dtype=torch.uint8,
                                      device=self.device)
                    buf.copy_(ring.bufs[handle][:nbytes], non_blocking=True)
                    ring.release(handle, stream)
                metrics.counter_add("ingest/device_puts")
                window.append((buf, rows))
                if len(window) > self.infeed_depth:
                    yield from batches(*window.popleft())
            while window:
                yield from batches(*window.popleft())
        finally:
            # An abandoned epoch unblocks the producer so it exits.
            stop.set()


def _background(it: Iterator, depth: int, stop: threading.Event):
    """Run ``it`` in a daemon thread, buffering ``depth`` items. Setting
    ``stop`` makes the producer exit promptly; a producer error is raised
    on the consumer's side at its next pull. The producer runs in the
    consumer's trace context (captured here, inside the epoch span), so
    its ``ingest/*`` spans nest in the training trace."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    done = object()
    err: List[BaseException] = []
    trace_ctx = current_context()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        with propagated(trace_ctx):
            try:
                for item in it:
                    if not put(item):
                        return
            except BaseException as exc:  # surfaced on the consumer's side
                err.append(exc)
            put(done)

    threading.Thread(target=producer, daemon=True).start()

    def consume():
        # Seconds the training loop sat blocked waiting for data: the
        # input-wait half of a step.
        while True:
            t0 = time.perf_counter()
            item = q.get()
            metrics.counter_add("ingest/wait_seconds",
                                time.perf_counter() - t0)
            if err:
                raise err[0]
            if item is done:
                return
            yield item

    return consume()
