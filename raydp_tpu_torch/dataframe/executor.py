"""Partition executors: where DataFrame stages actually run.

Two backends with one interface:

  * ``LocalExecutor`` — partitions are in-memory ``pa.Table``s, stages run
    on a thread pool (pyarrow kernels release the GIL). Like Spark
    ``local[n]``; the default when no session is live.
  * ``ClusterExecutor`` — partitions are ``ObjectRef``s in the shm store,
    stages ship to the session's ETL worker processes through the
    control plane, as closures (``cluster/closure.py``; the reference's
    executor-side ``mapPartitions`` over Ray actors,
    ObjectStoreWriter.scala:93-164). Locality: a partition is routed to a
    stable worker per index so repeated stages reuse page-cache-warm
    segments (reference threads locality through getPreferredLocations,
    RayDatasetRDD.scala:53-55). The default while a session from
    ``raydp_tpu_torch.init()`` is live.

This module imports no torch: the workers load it to run their tasks.

Telemetry (``raydp_tpu/dataframe/executor.py:38-93``): every stage runs
in a ``df/stage`` span (under streaming dispatch the span covers the
scheduling; the stage's wall lands in its StageStats), the first stage
of a process with no job in scope mints a process-wide ``etl`` job, and
each exchange bills its bytes as ``shuffle_bytes``. Every stage also
passes the control plane's fair-share ``stage_gate``
(``raydp_tpu/dataframe/executor.py:69-77``): a one-slot turn from the
arbiter, granted in deficit-weighted round-robin order across jobs, and
a no-op unless ``RAYDP_TPU_SCHED_CAPACITY`` turns arbitration on.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, List, Optional, Sequence

import pyarrow as pa

from raydp_tpu_torch.cluster.cluster import TaskSpec
from raydp_tpu_torch.dataframe.scheduler import (
    PendingPartition,
    StreamingStage,
    resolve,
    resolve_one,
    streaming_enabled,
)
from raydp_tpu_torch.store.object_store import ObjectRef, ObjectStore
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import span
from raydp_tpu_torch.telemetry.progress import (
    StageStats,
    progress,
    stage_stats_enabled,
    stage_store,
)
from raydp_tpu_torch.utils.profiling import metrics

StageFn = Callable[[pa.Table], pa.Table]


# -- per-stage runtime statistics ------------------------------------------
# The planner names the stage it is about to run (``stage_label``); the
# executor records a StageStats per stage into ``stage_store`` and
# streams done/total task counts into ``progress``. The label context
# also collects the stage ids it covered, which is how DataFrame plan
# nodes re-associate runtime numbers with themselves for EXPLAIN
# ANALYZE, ``profile()`` and the AQE.
_stage_ctx = threading.local()


@contextlib.contextmanager
def stage_label(label: str):
    """Name the executor stages run inside this context after the plan
    node driving them; yields the list of stage ids recorded."""
    ids: List[int] = []
    prev = getattr(_stage_ctx, "cur", None)
    _stage_ctx.cur = (label, ids)
    try:
        yield ids
    finally:
        _stage_ctx.cur = prev


def _part_meta(part: Any) -> "tuple[int, int]":
    """(rows, bytes) of one partition without materializing it; rows is
    -1 while a pending partition has not landed, and when unknowable
    (refs stored without a row count)."""
    if isinstance(part, PendingPartition):
        if not part.future.done() or part.future.exception() is not None:
            return -1, 0
        part = part.future.result()
    if isinstance(part, ObjectRef):
        return part.num_rows, part.size
    if isinstance(part, pa.Table):
        return part.num_rows, part.nbytes
    return -1, 0


class _StageRecorder:
    """Accumulates one :class:`StageStats` while a stage runs.

    Cheap when disabled (``RAYDP_TPU_STAGE_STATS=0``): every method
    no-ops after one boolean check. ``task_meta`` doubles as the
    ``meta_sink`` callback of ``Cluster.submit_batch``/``submit_async``
    so worker-side exec seconds and per-worker attribution ride the
    existing task replies."""

    def __init__(self, op: str, parts_in: Sequence[Any], kind: str,
                 total_tasks: Optional[int] = None, streaming: bool = False):
        self.enabled = stage_stats_enabled()
        cur = getattr(_stage_ctx, "cur", None)
        self.op = cur[0] if cur else op
        self._ids_sink = cur[1] if cur else None
        self._ids_sunk = False
        self.kind = kind
        self.streaming = bool(streaming)
        self._t0 = time.perf_counter()
        self._dispatch_s = 0.0
        self._exec_s = 0.0
        self._workers: dict = {}
        self._mu = threading.Lock()
        self._outs: Optional[List[Any]] = None
        self._rows_in = self._bytes_in = 0
        self._out_meta: dict = {}
        self.stage_id = 0
        if not self.enabled:
            return
        self.stage_id = stage_store.next_id()
        self._parts_in = len(parts_in)
        if self.streaming:
            # Inputs may still be pending futures: rows_in/bytes_in
            # accrue per task at dispatch time (task_input), keeping the
            # totals identical to the barriered path. The stage id must
            # land in the label sink NOW — the planner copies that list
            # into the lineage node before this stage completes.
            if self._ids_sink is not None:
                self._ids_sink.append(self.stage_id)
                self._ids_sunk = True
        else:
            rows = nbytes = 0
            for p in parts_in:
                r, b = _part_meta(p)
                if r > 0:
                    rows += r
                nbytes += b
            self._rows_in, self._bytes_in = rows, nbytes
        total = total_tasks if total_tasks is not None else len(parts_in)
        progress.stage_begin(self.stage_id, self.op, total)

    def dispatched(self) -> None:
        """Mark the end of submission (dispatch time)."""
        if self.enabled:
            self._dispatch_s = time.perf_counter() - self._t0

    def task_meta(self, index: int, worker_id: Optional[str],
                  exec_s: float) -> None:
        """Per-task completion: worker attribution + measured exec
        seconds (``meta_sink`` shape)."""
        if not self.enabled:
            return
        with self._mu:
            self._exec_s += float(exec_s or 0.0)
            wid = worker_id or "?"
            self._workers[wid] = self._workers.get(wid, 0) + 1
        progress.task_done(self.stage_id)

    def task_done(self, n: int = 1) -> None:
        if self.enabled:
            progress.task_done(self.stage_id, n)

    def finish(self, parts_out: Sequence[Any]) -> None:
        if self.enabled:
            self._outs = list(parts_out)

    def task_input(self, dep_parts: Sequence[Any]) -> None:
        """Streaming mode: account one task's (resolved) inputs at
        dispatch time — by then the upstream partitions exist, so the
        stage totals match what the barriered path would have seen."""
        if not self.enabled:
            return
        rows = nbytes = 0
        for p in dep_parts:
            r, b = _part_meta(p)
            if r > 0:
                rows += r
            nbytes += b
        with self._mu:
            self._rows_in += rows
            self._bytes_in += nbytes

    def task_output(self, index: int, part: Any) -> None:
        """Streaming mode: record one completed task's output partition
        (keyed by index so skew stats stay order-stable regardless of
        completion order)."""
        if not self.enabled:
            return
        meta = _part_meta(part)
        with self._mu:
            self._out_meta[index] = meta

    def close_streaming(self) -> None:
        """Finalize a streaming stage: called by the scheduler after the
        last task lands, BEFORE the final output future resolves."""
        if not self.enabled:
            return
        with self._mu:
            meta = dict(self._out_meta)
        part_rows = [meta[i][0] for i in sorted(meta)]
        part_bytes = [meta[i][1] for i in sorted(meta)]
        self._emit(part_rows, part_bytes, len(meta))

    def close(self) -> None:
        if not self.enabled:
            return
        part_rows: List[int] = []
        part_bytes: List[int] = []
        for p in self._outs or ():
            r, b = _part_meta(p)
            part_rows.append(r)
            part_bytes.append(b)
        self._emit(part_rows, part_bytes, len(self._outs or ()))

    def _emit(self, part_rows: List[int], part_bytes: List[int],
              parts_out: int) -> None:
        wall = time.perf_counter() - self._t0
        # Queue time: stage wall minus dispatch minus measured worker
        # execution — the time tasks sat waiting for a slot.
        queue_s = max(0.0, wall - self._dispatch_s - self._exec_s)
        rows_out = sum(r for r in part_rows if r > 0)
        bytes_out = sum(part_bytes)
        stats = StageStats(
            stage_id=self.stage_id,
            op=self.op,
            executor=self.kind,
            rows_in=self._rows_in,
            rows_out=rows_out,
            bytes_in=self._bytes_in,
            bytes_out=bytes_out,
            parts_in=self._parts_in,
            parts_out=parts_out,
            wall_s=wall,
            dispatch_s=self._dispatch_s,
            queue_s=queue_s if self.kind == "cluster" else 0.0,
            workers=dict(self._workers),
            part_rows=part_rows,
            part_bytes=part_bytes,
        )
        stage_store.record(stats)
        progress.stage_end(self.stage_id)
        if self._ids_sink is not None and not self._ids_sunk:
            self._ids_sink.append(self.stage_id)
        metrics.counter_add(f"stage/rows_in/{self.op}", self._rows_in)
        metrics.counter_add(f"stage/rows_out/{self.op}", rows_out)
        metrics.counter_add(f"stage/bytes_in/{self.op}", self._bytes_in)
        metrics.counter_add(f"stage/bytes_out/{self.op}", bytes_out)
        metrics.counter_add(f"stage/seconds/{self.op}", wall)


def _ensure_etl_job() -> None:
    """A bare pipeline's job: the first stage executed in a process with
    no job in scope mints a process-wide ``etl`` job. An explicit
    ``job_scope`` (or a gang's job) takes precedence."""
    if _acct.current_job() is None:
        _acct.set_process_job(_acct.mint_job("etl"))


@contextlib.contextmanager
def _stage_span(op: str, n_parts: int, executor: str, **attrs):
    """Span and counter around one stage execution (driver side: submit
    and result gather on the cluster backend, the stage's wall as the
    planner sees it), inside the arbiter's fair-share turn."""
    from raydp_tpu_torch.control import stage_gate

    _ensure_etl_job()
    metrics.counter_add("df/stages")
    with stage_gate(label=op), span("df/stage", op=op, parts=n_parts,
                                    executor=executor, **attrs):
        yield


@contextlib.contextmanager
def _stage(op: str, parts_in: Sequence[Any], executor: str,
           total_tasks: Optional[int] = None):
    """Span, counter and StageStats recording around one stage."""
    rec = _StageRecorder(op, parts_in, executor, total_tasks)
    with _stage_span(op, len(parts_in), executor):
        try:
            yield rec
        finally:
            rec.close()

# Memoized gather-concat for coalesced runs (Spark's analog: shuffle
# block reuse). Interactive ETL re-runs queries over the SAME stored
# partitions; re-concatenating them rebuilds fresh buffers each time,
# which also defeats every buffer-identity cache downstream. Keyed by
# partition identity (table ids), LRU-bounded by bytes, per process.
_CONCAT_MEMO_BYTES = int(
    os.environ.get("RAYDP_TPU_CONCAT_CACHE_BYTES", 256 << 20)
)
_concat_memo: OrderedDict = OrderedDict()
_concat_memo_lock = threading.Lock()


def _concat_cached(tables: List[pa.Table], key, keepalive=None) -> pa.Table:
    """``_concat`` with identity-keyed memoization. ``keepalive`` pins
    the objects whose ids form ``key`` (local mode: id() reuse after GC
    would otherwise alias a stale entry)."""
    if key is None:
        return _concat(tables)
    with _concat_memo_lock:
        hit = _concat_memo.pop(key, None)
        if hit is not None:
            _concat_memo[key] = hit  # refresh LRU position
            return hit[1]
    out = _concat(tables)
    # Entry cost: arrow's concat is zero-copy (the output references the
    # input chunks' buffers), so ``out.nbytes`` already measures the
    # retained memory and the keepalive pins only object headers on top.
    cost = out.nbytes
    with _concat_memo_lock:
        _concat_memo[key] = (keepalive, out, cost)
        total = sum(c for _, _, c in _concat_memo.values())
        while total > _CONCAT_MEMO_BYTES and len(_concat_memo) > 1:
            _, (_, _, evicted_cost) = _concat_memo.popitem(last=False)
            total -= evicted_cost
    return out


def _fetch_concat_cached(ctx, refs) -> pa.Table:
    """Worker-side gather for pre_concat coalesced runs: on a memo hit
    the shm fetches are skipped along with the concat. Only ObjectRefs
    are memoized — their object ids are globally unique, while id() of
    a per-task unpickled raw ref could be recycled after GC and alias a
    stale entry."""
    if all(isinstance(r, ObjectRef) for r in refs):
        key = tuple(r.object_id for r in refs)
        with _concat_memo_lock:
            ent = _concat_memo.get(key)
            if ent is not None:
                _concat_memo.move_to_end(key)
                return ent[1]
    else:
        key = None
    tables = [ctx.get_table(r) for r in refs]
    return _concat_cached(tables, key)


class Executor:
    def map_partitions(self, parts: List[Any], fn: StageFn) -> List[Any]:
        raise NotImplementedError

    def map_partitions_indexed(
        self, parts: List[Any], fn: Callable[[pa.Table, int], pa.Table]
    ) -> List[Any]:
        """Like map_partitions, but ``fn`` also receives the partition
        index (for partition-indexed ops like monotonically_increasing_id)."""
        raise NotImplementedError

    def map_pairs(
        self,
        parts_a: List[Any],
        parts_b: List[Any],
        fn: Callable[[pa.Table, pa.Table], pa.Table],
    ) -> List[Any]:
        """Zip two equally-partitioned lists through a binary stage
        (bucket i of a shuffle join meets bucket i)."""
        raise NotImplementedError

    def exchange(
        self,
        parts: List[Any],
        splitter: Callable[[pa.Table], List[pa.Table]],
        n_out: int,
        combine: Optional[StageFn] = None,
        replan: Optional[Callable[[List[int]], Any]] = None,
    ) -> List[Any]:
        """All-to-all: split every partition into n_out chunks, then
        concatenate chunk i across partitions into output partition i.

        ``replan`` is the AQE hook: called with the measured per-bucket
        byte sizes AFTER the split phase and BEFORE merge dispatch — the
        one point where the true shuffle layout is known but nothing has
        been merged yet. It returns an
        :class:`raydp_tpu.dataframe.aqe.ExchangePlan` (or ``None`` to
        keep the static layout); the executor then builds output
        partitions group-by-group instead of one-per-bucket. ``split``
        groups are only legal with ``combine=None`` (a per-bucket
        combine over a sub-bucket would see partial groups)."""
        raise NotImplementedError

    def part_nbytes(self, part: Any) -> int:
        """Approximate in-memory/wire size of one partition, WITHOUT
        materializing it — drives adaptive shuffle planning (Spark AQE's
        coalescing decisions read shuffle statistics the same way)."""
        raise NotImplementedError

    def discard(self, parts: List[Any]) -> None:
        """Free intermediate partitions (shuffle temps). No-op where
        partitions are plain in-memory tables."""

    def run_coalesced(
        self,
        parts: List[Any],
        fn: Callable[[Any], pa.Table],
        pre_concat: bool = False,
    ) -> Any:
        """Run ``fn`` over ALL partitions in one task and return a single
        output partition. The adaptive small-data plan: when inputs (or
        partial-agg outputs) are small, one arrow kernel pass — which
        parallelizes internally across cores — beats a process-level
        hash exchange whose per-task orchestration would dominate.

        ``pre_concat=True``: the executor concatenates the partitions
        itself — memoized by partition identity (``_concat_cached``) so
        repeated queries over the same stored partitions hand ``fn`` the
        SAME table object (same buffers → downstream buffer-identity
        caches hit) — and ``fn`` receives one ``pa.Table`` instead of a
        list."""
        raise NotImplementedError

    def materialize(self, part: Any) -> pa.Table:
        raise NotImplementedError

    def head(self, part: Any, k: int) -> pa.Table:
        """First ``k`` rows of one partition (schema/peek probes).
        Backends cut the head where the partition lives — the caller
        never pulls the whole table for a 32-row probe."""
        raise NotImplementedError

    def put(self, table: pa.Table) -> Any:
        raise NotImplementedError

    def put_many(self, tables: List[pa.Table]) -> List[Any]:
        """Bulk ingest; overridden where scatter can run concurrently."""
        return [self.put(t) for t in tables]

    def num_rows(self, part: Any) -> int:
        raise NotImplementedError

    def sample_column(self, parts: List[Any], column: str, k: int) -> list:
        """Up to ``k`` non-null sample values of ``column`` per partition,
        WITHOUT materializing partitions in the caller (range-sort
        pivots)."""
        raise NotImplementedError

    def default_fanout(self) -> int:
        """How many output partitions a shuffle should target."""
        return 8


def _split_groups(items: List[Any], k: int) -> List[List[Any]]:
    """Distribute one bucket's per-input chunk list over ``k``
    contiguous, non-empty groups (AQE skew splitting). Contiguous in
    input order so sub-bucket contents stay deterministic run-to-run;
    ``plan_exchange`` clamps ``k`` to the input-partition count, the
    ``min`` here is belt-and-braces."""
    k = max(1, min(k, len(items)))
    base, extra = divmod(len(items), k)
    groups, offset = [], 0
    for i in range(k):
        size = base + (1 if i < extra else 0)
        groups.append(items[offset:offset + size])
        offset += size
    return groups


def _concat(tables: List[pa.Table]) -> pa.Table:
    tables = [t for t in tables if t is not None]
    if not tables:
        return pa.table({})
    # Drop empty tables: stages like distributed agg can emit empties with
    # an intermediate schema (partial-agg columns); schema-promoting concat
    # would leak those as all-null columns.
    non_empty = [t for t in tables if t.num_rows > 0]
    if not non_empty:
        return tables[0]
    if len(non_empty) == 1:
        return non_empty[0]
    return pa.concat_tables(non_empty, promote_options="default")


class LocalExecutor(Executor):
    def __init__(self, max_threads: Optional[int] = None):
        self._pool = ThreadPoolExecutor(
            max_workers=max_threads or min(8, (os.cpu_count() or 2) * 2)
        )

    def _stream_narrow(self, op, deps, call_of):
        """Event-driven narrow stage on the thread pool: each output's
        task runs the moment its upstream partitions exist; callers get
        pending partitions immediately."""
        rec = _StageRecorder(op, [d[0] for d in deps], "local",
                             total_tasks=len(deps), streaming=True)

        def run_one(i, vals):
            rec.task_input(vals[:1])
            out = call_of(i, vals)
            rec.task_done()
            return out

        def submit(items):
            return [self._pool.submit(run_one, i, vals)
                    for i, vals in items]

        stage = StreamingStage(deps, submit, on_output=rec.task_output,
                               on_close=rec.close_streaming, op=op)
        with _stage_span(op, len(deps), "local", streaming=True):
            outs = stage.start()
            rec.dispatched()
        return outs

    def map_partitions(self, parts, fn):
        if streaming_enabled() and parts:
            return self._stream_narrow(
                "map_partitions", [[p] for p in parts],
                lambda i, vals: fn(vals[0]),
            )
        parts = resolve(parts)
        with _stage("map_partitions", parts, "local") as rec:
            def run(t):
                out = fn(t)
                rec.task_done()
                return out

            outs = list(self._pool.map(run, parts))
            rec.finish(outs)
            return outs

    def map_partitions_indexed(self, parts, fn):
        if streaming_enabled() and parts:
            return self._stream_narrow(
                "map_partitions_indexed", [[p] for p in parts],
                lambda i, vals: fn(vals[0], i),
            )
        parts = resolve(parts)
        with _stage("map_partitions_indexed", parts, "local") as rec:
            def run(t, i):
                out = fn(t, i)
                rec.task_done()
                return out

            outs = list(self._pool.map(run, parts, range(len(parts))))
            rec.finish(outs)
            return outs

    def map_pairs(self, parts_a, parts_b, fn):
        if streaming_enabled() and parts_a:
            return self._stream_narrow(
                "map_pairs",
                [[a, b] for a, b in zip(parts_a, parts_b)],
                lambda i, vals: fn(vals[0], vals[1]),
            )
        parts_a = resolve(parts_a)
        parts_b = resolve(parts_b)
        with _stage("map_pairs", parts_a, "local") as rec:
            def run(ta, tb):
                out = fn(ta, tb)
                rec.task_done()
                return out

            outs = list(self._pool.map(run, parts_a, parts_b))
            rec.finish(outs)
            return outs

    def exchange(self, parts, splitter, n_out, combine=None, replan=None):
        # Wide stage: every input partition feeds every output bucket,
        # so this is a true barrier — resolve pendings up front.
        parts = resolve(parts)
        with _stage("exchange", parts, "local",
                    total_tasks=len(parts) + n_out) as rec:
            metrics.counter_add("shuffle/exchanges")
            chunked = list(self._pool.map(splitter, parts))
            rec.task_done(len(parts))
            rec.dispatched()
            moved = sum(
                c.nbytes for chunks in chunked for c in chunks
            )
            metrics.counter_add("shuffle/bytes", moved)
            # Single host: every chunk is already local to its merge.
            metrics.counter_add("shuffle/local_bytes", moved)
            _acct.add_usage(_acct.SHUFFLE_BYTES, moved)
            plan = None
            if replan is not None:
                plan = replan([
                    sum(chunks[i].nbytes for chunks in chunked)
                    for i in range(n_out)
                ])
            outs = []
            if plan is None:
                for i in range(n_out):
                    merged = _concat([chunks[i] for chunks in chunked])
                    outs.append(combine(merged) if combine else merged)
                    rec.task_done()
                rec.finish(outs)
                return outs
            for g in plan.groups:
                if g[0] == "merge":
                    # Bucket-major order: a group of one bucket is
                    # byte-identical to the static merge of that bucket.
                    merged = _concat(
                        [chunks[i] for i in g[1] for chunks in chunked]
                    )
                    outs.append(combine(merged) if combine else merged)
                elif g[0] == "replicate":
                    merged = _concat([chunks[g[1]] for chunks in chunked])
                    merged = combine(merged) if combine else merged
                    outs.extend([merged] * g[2])
                else:  # ("split", id, k): combine is None by contract
                    for grp in _split_groups(
                        [chunks[g[1]] for chunks in chunked], g[2]
                    ):
                        outs.append(_concat(grp))
                rec.task_done()
            rec.finish(outs)
            return outs

    def part_nbytes(self, part):
        return resolve_one(part).nbytes

    def run_coalesced(self, parts, fn, pre_concat=False):
        parts = resolve(list(parts))
        with _stage("run_coalesced", parts, "local", total_tasks=1) as rec:
            if not pre_concat:
                out = fn(parts)
            else:
                key = ("local",) + tuple(id(t) for t in parts)
                out = fn(_concat_cached(parts, key, keepalive=parts))
            rec.finish([out] if isinstance(out, pa.Table) else [])
            return out

    def materialize(self, part):
        return resolve_one(part)

    def head(self, part, k):
        part = resolve_one(part)
        return part.slice(0, min(k, part.num_rows))

    def put(self, table):
        return table

    def num_rows(self, part):
        return resolve_one(part).num_rows

    def sample_column(self, parts, column, k):
        return [
            vals
            for t in resolve(parts)
            for vals in [_sample_table(t, column, k)]
        ]

    def default_fanout(self) -> int:
        return min(8, (os.cpu_count() or 2) * 2)


def _sample_table(t: pa.Table, column: str, k: int) -> list:
    if t.num_rows == 0:
        return []
    series = t.column(column).to_pandas().dropna()
    if not len(series):
        return []
    return series.sample(min(k, len(series)), random_state=0).tolist()


class ClusterExecutor(Executor):
    """Runs stages on the session's ETL workers; partitions live in shm."""

    def __init__(self, cluster):
        self.cluster = cluster
        self.store: ObjectStore = cluster.master.store
        self._put_rr = itertools.count()

    # Stable partition→worker routing, locality-first: a partition ref is
    # routed to a worker on the node where its bytes already live (zero-copy
    # shm read), falling back to index round-robin. The reference does the
    # same via getPreferredLocations (RayDatasetRDD.scala:53-55).
    def _worker_for(self, index: int, ref=None) -> Optional[str]:
        workers = self.cluster.alive_workers()
        if not workers:
            return None
        if isinstance(ref, ObjectRef):
            local = sorted(
                w.worker_id for w in workers if w.node_id == ref.node_id
            )
            if local:
                return local[index % len(local)]
        ordered = sorted(w.worker_id for w in workers)
        return ordered[index % len(ordered)]

    def _stream_narrow(self, op, deps, spec_of):
        """Event-driven narrow stage: every output's task ships the
        moment its upstream partitions exist. Each scheduler pump
        batches ALL simultaneously-ready outputs into ONE submit_batch
        call, so the one-RunTaskBatch-envelope-per-worker amortization
        is preserved (the all-concrete case is exactly one batch)."""
        rec = _StageRecorder(op, [d[0] for d in deps], "cluster",
                             total_tasks=len(deps), streaming=True)

        def submit(items):
            for _i, vals in items:
                rec.task_input(vals[:1])
            specs = [spec_of(i, vals) for i, vals in items]
            return self.cluster.submit_batch(specs, meta_sink=rec.task_meta)

        stage = StreamingStage(deps, submit, on_output=rec.task_output,
                               on_close=rec.close_streaming, op=op)
        with _stage_span(op, len(deps), "cluster", streaming=True):
            outs = stage.start()
            rec.dispatched()
        return outs

    def map_partitions(self, parts, fn):
        def task(ctx, ref):
            table = ctx.get_table(ref)
            return ctx.put_table(fn(table), holder=True)

        if streaming_enabled() and parts:
            return self._stream_narrow(
                "map_partitions", [[p] for p in parts],
                lambda i, vals: TaskSpec(
                    task, (vals[0],),
                    worker_id=self._worker_for(i, vals[0]),
                ),
            )
        parts = resolve(parts)
        with _stage("map_partitions", parts, "cluster") as rec:
            # One RunTaskBatch envelope per worker (not per partition):
            # per-call RPC+pickle overhead amortizes over all of that
            # worker's partitions, and fn serializes once per envelope.
            futures = self.cluster.submit_batch([
                TaskSpec(task, (ref,), worker_id=self._worker_for(i, ref))
                for i, ref in enumerate(parts)
            ], meta_sink=rec.task_meta)
            rec.dispatched()
            outs = [f.result() for f in futures]
            rec.finish(outs)
            return outs

    def map_partitions_indexed(self, parts, fn):
        def task(ctx, ref, index):
            table = ctx.get_table(ref)
            return ctx.put_table(fn(table, index), holder=True)

        if streaming_enabled() and parts:
            return self._stream_narrow(
                "map_partitions_indexed", [[p] for p in parts],
                lambda i, vals: TaskSpec(
                    task, (vals[0], i),
                    worker_id=self._worker_for(i, vals[0]),
                ),
            )
        parts = resolve(parts)
        with _stage("map_partitions_indexed", parts, "cluster") as rec:
            futures = self.cluster.submit_batch([
                TaskSpec(task, (ref, i), worker_id=self._worker_for(i, ref))
                for i, ref in enumerate(parts)
            ], meta_sink=rec.task_meta)
            rec.dispatched()
            outs = [f.result() for f in futures]
            rec.finish(outs)
            return outs

    def part_nbytes(self, part):
        part = resolve_one(part)
        return part.size if isinstance(part, ObjectRef) else part.nbytes

    def discard(self, parts):
        for ref in parts:
            if isinstance(ref, PendingPartition):
                # Free the partition whenever its producer lands; a
                # failed producer has nothing to free.
                ref.future.add_done_callback(self._discard_done)
            elif isinstance(ref, ObjectRef):
                self.store.delete(ref)

    def _discard_done(self, fut) -> None:
        if fut.exception() is not None:
            return
        ref = fut.result()
        if isinstance(ref, ObjectRef):
            try:
                self.store.delete(ref)
            except Exception:
                pass

    def run_coalesced(self, parts, fn, pre_concat=False):
        # Coalesced runs need every input in one task: barrier here.
        parts = resolve(list(parts))
        if pre_concat:
            def task(ctx, refs):
                # _fetch_concat_cached is resolved in the WORKER's own
                # executor module (the carrier ships this closure with
                # the module's globals by reference), so the memo — and
                # its lock — live worker-side and never ship.
                return ctx.put_table(
                    fn(_fetch_concat_cached(ctx, refs)), holder=True
                )
        else:
            def task(ctx, refs):
                tables = [ctx.get_table(r) for r in refs]
                return ctx.put_table(fn(tables), holder=True)

        # Locality: run on the worker whose node holds the most input
        # bytes (one cross-node fetch per remote partition either way;
        # majority-resident placement minimizes them).
        by_node = {}
        for ref in parts:
            if isinstance(ref, ObjectRef):
                by_node[ref.node_id] = by_node.get(ref.node_id, 0) + ref.size
        worker_id = None
        if by_node:
            best = max(by_node, key=by_node.get)
            workers = sorted(
                w.worker_id
                for w in self.cluster.alive_workers()
                if w.node_id == best
            )
            if workers:
                worker_id = workers[0]
        parts = list(parts)
        with _stage("run_coalesced", parts, "cluster",
                    total_tasks=1) as rec:
            fut = self.cluster.submit_async(
                task, parts, worker_id=worker_id, meta_sink=rec.task_meta
            )
            rec.dispatched()
            out = fut.result()
            rec.finish([out])
            return out

    def map_pairs(self, parts_a, parts_b, fn):
        def task(ctx, ra, rb):
            ta = ctx.get_table(ra)
            tb = ctx.get_table(rb)
            return ctx.put_table(fn(ta, tb), holder=True)

        if streaming_enabled() and parts_a:
            return self._stream_narrow(
                "map_pairs",
                [[a, b] for a, b in zip(parts_a, parts_b)],
                lambda i, vals: TaskSpec(
                    task, (vals[0], vals[1]),
                    worker_id=self._worker_for(i, vals[0]),
                ),
            )
        parts_a = resolve(parts_a)
        parts_b = resolve(parts_b)
        with _stage("map_pairs", parts_a, "cluster") as rec:
            futures = self.cluster.submit_batch([
                TaskSpec(task, (ra, rb), worker_id=self._worker_for(i, ra))
                for i, (ra, rb) in enumerate(zip(parts_a, parts_b))
            ], meta_sink=rec.task_meta)
            rec.dispatched()
            outs = [f.result() for f in futures]
            rec.finish(outs)
            return outs

    def _free_refs(self, refs) -> None:
        for ref in refs:
            if isinstance(ref, ObjectRef):
                try:
                    self.store.delete(ref)
                except Exception:
                    pass

    def _merge_worker(self, index: int, refs):
        """Locality-scheduled merge placement: (worker_id, node_id) of
        the node already holding the most input bytes for this bucket —
        those chunks are zero-copy shm reads there, only the minority
        streams over. Workers on the winning node are spread by bucket
        index; round-robin fallback when nothing is resident."""
        by_node: dict = {}
        for r in refs:
            if isinstance(r, ObjectRef):
                # max(size, 1): empty chunks still vote for their node.
                by_node[r.node_id] = by_node.get(r.node_id, 0) + max(r.size, 1)
        workers = self.cluster.alive_workers()
        if by_node and workers:
            # Sorted iteration breaks byte ties deterministically.
            best = max(sorted(by_node), key=lambda n: by_node[n])
            local = sorted(
                w.worker_id for w in workers if w.node_id == best
            )
            if local:
                return local[index % len(local)], best
        wid = self._worker_for(index)
        node = next(
            (w.node_id for w in workers if w.worker_id == wid), None
        )
        return wid, node

    def exchange(self, parts, splitter, n_out, combine=None, replan=None):
        def split_task(ctx, ref):
            table = ctx.get_table(ref)
            return [ctx.put_table(chunk, holder=True) for chunk in splitter(table)]

        def merge_task(ctx, refs):
            tables = [ctx.get_table(r) for r in refs]
            merged = _concat(tables)
            if combine is not None:
                merged = combine(merged)
            return ctx.put_table(merged, holder=True)

        def preconcat_task(ctx, refs):
            # Eager pre-merge: concat only — ``combine`` runs exactly
            # once per bucket, in the final merge.
            return ctx.put_table(
                _concat([ctx.get_table(r) for r in refs]), holder=True
            )

        # Eager pre-merge threshold: with >= N chunks of a bucket ready
        # while splits are still running, concat them now so the final
        # merge starts from partially-reduced inputs. Off by default —
        # it trades intra-bucket row order (arrival order, not input
        # order) for overlap, so it is an explicit opt-in.
        try:
            eager_min = int(
                os.environ.get("RAYDP_TPU_EXCHANGE_EAGER_MERGE", "0") or 0
            )
        except ValueError:
            eager_min = 0

        # Wide stage: every split must exist before buckets can close —
        # resolve pendings up front (the downstream merge dispatch is
        # already streamed below).
        parts = resolve(parts)
        with _stage("exchange", parts, "cluster",
                    total_tasks=len(parts) + n_out) as rec:
            metrics.counter_add("shuffle/exchanges")
            split_futures = self.cluster.submit_batch([
                TaskSpec(split_task, (ref,),
                         worker_id=self._worker_for(i, ref))
                for i, ref in enumerate(parts)
            ], meta_sink=rec.task_meta)
            # Stream split completions (one envelope per worker resolves
            # independently) instead of gathering in submission order:
            # merge planning starts the moment the last chunk EXISTS,
            # and the eager path can pre-concat hot buckets while slow
            # splits are still running.
            from concurrent.futures import FIRST_COMPLETED, wait as _wait

            idx_of = {f: i for i, f in enumerate(split_futures)}
            chunks_by_part: List[Optional[list]] = [None] * len(parts)
            avail: List[list] = [[] for _ in range(n_out)]
            early: List[list] = [[] for _ in range(n_out)]
            pending = set(split_futures)
            while pending:
                done, pending = _wait(pending, return_when=FIRST_COMPLETED)
                for f in done:
                    row = f.result()  # raises like the old ordered gather
                    chunks_by_part[idx_of[f]] = row
                    if eager_min > 0:
                        for i, ref in enumerate(row):
                            avail[i].append(ref)
                if eager_min > 0 and pending:
                    for i in range(n_out):
                        if len(avail[i]) >= eager_min:
                            batch, avail[i] = avail[i], []
                            wid, _node = self._merge_worker(i, batch)
                            fut = self.cluster.submit_async(
                                preconcat_task, batch, worker_id=wid
                            )
                            fut.add_done_callback(
                                lambda _f, refs=batch: self._free_refs(refs)
                            )
                            early[i].append(fut)

            if eager_min > 0:
                # Arrival order within a bucket (pre-merged blocks first).
                inputs = [
                    [f.result() for f in early[i]] + avail[i]
                    for i in range(n_out)
                ]
            else:
                # Deterministic: chunk i of every input, in input order.
                inputs = [
                    [chunks[i] for chunks in chunks_by_part]
                    for i in range(n_out)
                ]

            # AQE replan: only over the deterministic layout — the eager
            # path already traded bucket order for overlap and its refs
            # are partially pre-merged, so the measured per-bucket sizes
            # would double-count. Each group of the returned plan becomes
            # one (or, for splits, k) merge task(s); every split ref is
            # still consumed by exactly one merge, so the byte counters
            # and per-merge freeing below are unchanged.
            plan = None
            if replan is not None and eager_min == 0:
                plan = replan([
                    sum(r.size for r in refs if isinstance(r, ObjectRef))
                    for refs in inputs
                ])
            if plan is None:
                groups = [("merge", [i]) for i in range(n_out)]
            else:
                groups = plan.groups

            specs, merge_inputs, repeats = [], [], []
            total_b = local_b = 0
            for g in groups:
                if g[0] == "merge":
                    # Bucket-major ref order: singleton groups reproduce
                    # the static merge exactly.
                    batches = [[r for i in g[1] for r in inputs[i]]]
                    rep = 1
                elif g[0] == "replicate":
                    batches = [inputs[g[1]]]
                    rep = g[2]
                else:  # ("split", id, k): combine is None by contract
                    batches = _split_groups(inputs[g[1]], g[2])
                    rep = 1
                for refs in batches:
                    wid, node = self._merge_worker(len(specs), refs)
                    for r in refs:
                        if isinstance(r, ObjectRef):
                            total_b += r.size
                            if node is not None and r.node_id == node:
                                local_b += r.size
                    specs.append(
                        TaskSpec(merge_task, (refs,), worker_id=wid,
                                 node_id=node)
                    )
                    merge_inputs.append(refs)
                    repeats.append(rep)
            metrics.counter_add("shuffle/bytes", total_b)
            metrics.counter_add("shuffle/local_bytes", local_b)
            _acct.add_usage(_acct.SHUFFLE_BYTES, total_b)
            merge_futures = self.cluster.submit_batch(
                specs, meta_sink=rec.task_meta
            )
            rec.dispatched()
            # Merge i consumes exactly its input refs, so they are dead
            # the moment that merge lands — free them then, instead of
            # holding the whole shuffle's intermediates until the full
            # barrier (peak shm across a shuffle drops to the still-
            # unmerged buckets).
            for f, refs in zip(merge_futures, merge_inputs):
                f.add_done_callback(
                    lambda fut, rr=refs: self._free_refs(rr)
                )
            outs = []
            for f, rep in zip(merge_futures, repeats):
                ref = f.result()
                outs.extend([ref] * rep)
            rec.finish(outs)
            return outs

    def materialize(self, part):
        return self.cluster.resolver.get_arrow_table(resolve_one(part))

    def head(self, part, k):
        part = resolve_one(part)
        if not isinstance(part, ObjectRef):
            return part.slice(0, min(k, part.num_rows))

        def probe(ctx, ref, n):
            table = ctx.get_table(ref)
            n = min(n, table.num_rows)
            # take(), not slice(): a slice pickles its PARENT buffers
            # (the whole partition would ride the reply); take copies
            # just the probe rows.
            return table.take(pa.array(range(n), type=pa.int64()))

        return self.cluster.submit_async(
            probe, part, k, worker_id=self._worker_for(0, part)
        ).result()

    def put(self, table):
        return self._put_async(table).result()

    def put_many(self, tables):
        # Scatter concurrently: ingest wall-clock is the slowest single
        # transfer, not the sum. Source frames stay concrete (refs, not
        # pendings): ingest is driver-local put work, and downstream
        # consumers — union coercion, to_object_refs, the store feed —
        # rely on source partitions being addressable refs. Streaming
        # starts at the first narrow STAGE over these refs.
        futures = [self._put_async(t) for t in tables]
        return [f.result() for f in futures]

    def _put_async(self, table):
        """Ingest a partition: scattered to a worker round-robin so initial
        placement is distributed across nodes (Spark parallelize lands
        blocks on executors, not the driver) — without this, every
        partition would start on the driver node and locality routing
        would keep all work there. Written holder-owned: base data must
        survive pool shrinks (kill_worker contract).

        The table itself travels the DATA plane (``data_args``): it is
        written once into the driver's shm store and the RunTask envelope
        carries only the ref — a co-located worker re-puts it from a
        zero-copy mmap view, a remote one streams it from the driver
        node's agent in bounded chunks. No table bytes ride the control
        plane."""
        workers = self.cluster.alive_workers()
        if not workers:
            from concurrent.futures import Future

            f = Future()
            f.set_result(self.store.put_arrow_table(table))
            return f
        ordered = sorted(w.worker_id for w in workers)
        target = ordered[next(self._put_rr) % len(ordered)]

        def ingest(ctx, t):
            return ctx.put_table(t, holder=True)

        return self.cluster.submit_async(
            ingest, worker_id=target, data_args=(table,)
        )

    def num_rows(self, part):
        part = resolve_one(part)
        return part.num_rows if isinstance(part, ObjectRef) else -1

    def default_fanout(self) -> int:
        # 2 shuffle partitions per alive worker keeps every worker busy in
        # the merge phase and scales with dynamic allocation (no hard cap).
        return max(8, 2 * len(self.cluster.alive_workers()))

    def sample_column(self, parts, column, k):
        def task(ctx, ref):
            return _sample_table(ctx.get_table(ref), column, k)

        parts = resolve(parts)
        futures = self.cluster.submit_batch([
            TaskSpec(task, (ref,), worker_id=self._worker_for(i, ref))
            for i, ref in enumerate(parts)
        ])
        return [f.result() for f in futures]
