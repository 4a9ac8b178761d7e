"""Partitioned DataFrame with lazy narrow-op fusion and eager shuffles.

The framework's replacement for the reference's embedded Spark: a bounded
but complete op surface for the five baseline ETL pipelines (reference:
examples/data_process.py filter/withColumn/UDF/drop;
tensorflow_titanic.ipynb fillna/select; pytorch_dlrm.ipynb
groupBy/count/join). Narrow ops (select/filter/withColumn/...) append
fused closures to a pending pipeline — one pass over each Arrow partition
when forced. Wide ops (groupBy/join/orderBy/repartition) flush the
pipeline and run a hash/range exchange on the executor.
"""
from __future__ import annotations

import secrets
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc

from raydp_tpu_torch.dataframe import aqe as _aqe
from raydp_tpu_torch.dataframe import expr as E
from raydp_tpu_torch.dataframe.executor import (
    Executor,
    LocalExecutor,
    _concat,
    stage_label,
)
from raydp_tpu_torch.dataframe.scheduler import (
    all_settled as _all_settled,
    chain as _chain_part,
    is_pending as _is_pending,
    resolve as _resolve_parts,
    when_settled as _when_settled,
)
from raydp_tpu_torch.dataframe.window import find_window_exprs, keys_cover
from raydp_tpu_torch.telemetry.progress import stage_store
from raydp_tpu_torch.utils.profiling import metrics

ColumnLike = Union[str, E.Expr]


def _node(
    op: str,
    annotation: str = "",
    stage_ids: Optional[List[int]] = None,
    lazy: bool = False,
) -> Dict[str, Any]:
    """One logical-plan lineage node. ``annotation`` carries the
    physical decision EXPLAIN renders next to the op (hash exchange /
    elided / coalesced / broadcast); ``stage_ids`` key into the global
    :data:`raydp_tpu_torch.telemetry.progress.stage_store` once the node has
    executed; ``lazy`` marks pending narrow ops that only run (and get
    their stage ids) at the next flush."""
    return {
        "op": op,
        "annotation": annotation,
        "stage_ids": list(stage_ids or []),
        "lazy": lazy,
    }


def _resolve_lazy(
    lineage: List[Dict[str, Any]], stage_ids: List[int]
) -> List[Dict[str, Any]]:
    """Copy ``lineage`` marking the trailing run of lazy nodes as
    executed; the recorded ``stage_ids`` attach to the LAST of them
    (the whole lazy tail fused into one executor stage)."""
    out = [dict(n) for n in lineage]
    tail = []
    for n in reversed(out):
        if not n["lazy"]:
            break
        n["lazy"] = False
        tail.append(n)
    if tail:
        tail[0]["stage_ids"] = list(tail[0]["stage_ids"]) + list(stage_ids)
    elif out and stage_ids:
        out[-1]["stage_ids"] = list(out[-1]["stage_ids"]) + list(stage_ids)
    return out


def _default_executor() -> Executor:
    """The cluster executor while a session with live workers exists,
    else a local one."""
    from raydp_tpu_torch.context import current_session

    session = current_session()
    if session is not None and session.cluster.alive_workers():
        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        return ClusterExecutor(session.cluster)
    return LocalExecutor()


class DataFrame:
    def __init__(
        self,
        parts: List[Any],
        executor: Optional[Executor] = None,
        pending: Optional[List[Callable[[pa.Table], pa.Table]]] = None,
    ):
        self._parts = parts
        self._executor = executor or _default_executor()
        self._pending = list(pending or [])
        # Keys this frame is currently hash-partitioned on (co-located
        # groups); lets chained window ops on one spec skip re-shuffles.
        self._exchange_keys: Optional[tuple] = None
        # Lazy small-data coalesce (adaptive exchange): when set, _flush
        # concatenates all partitions in ONE task and runs the pending
        # pipeline there — fusing the gather with the next stage instead
        # of paying an extra store round-trip for an eager concat.
        self._pending_gather = False
        # AQE replan marker: the partition layout was rewritten at
        # runtime (coalesced/salted buckets), so even though
        # _exchange_keys co-location still holds, bucket i is NOT
        # hash(keys) % n_out — layout-pairing optimizations (zip join,
        # one-sided shuffle-join elision) must not trust it.
        self._aqe_layout = False
        # Memoized schema probe; frames are immutable, so once probed it
        # never changes. Derived frames start unset (None).
        self._schema: Optional[pa.Schema] = None
        # Logical-plan lineage for explain()/profile(); derived frames
        # extend their parent's list (see _node).
        self._lineage: List[Dict[str, Any]] = [
            _node(f"source[{len(parts)} parts]")
        ]

    # -- plan helpers ---------------------------------------------------
    def _with(
        self,
        fn: Callable[[pa.Table], pa.Table],
        node: Optional[Dict[str, Any]] = None,
    ) -> "DataFrame":
        out = DataFrame(self._parts, self._executor, self._pending + [fn])
        out._pending_gather = self._pending_gather
        out._aqe_layout = self._aqe_layout
        out._lineage = self._lineage + [node or _node("map", lazy=True)]
        return out

    def _annotated(self, node: Dict[str, Any]) -> "DataFrame":
        """Same frame, one more lineage node (elision / noop records)."""
        out = DataFrame(self._parts, self._executor, self._pending)
        out._pending_gather = self._pending_gather
        out._aqe_layout = self._aqe_layout
        out._exchange_keys = self._exchange_keys
        out._schema = self._schema
        out._lineage = self._lineage + [node]
        return out

    def _narrow_label(self) -> str:
        ops = [n["op"] for n in self._lineage if n["lazy"]]
        if not ops:
            return "narrow"
        label = ",".join(ops[-3:])
        if len(ops) > 3:
            label = f"...,{label}"
        return label

    def _flush(self) -> "DataFrame":
        """Run the pending narrow pipeline; afterwards partitions are
        materialized results."""
        if not self._pending and not (
            self._pending_gather and len(self._parts) > 1
        ):
            return self
        pipeline = list(self._pending)

        def run(table: pa.Table) -> pa.Table:
            for fn in pipeline:
                table = fn(table)
            return table

        with stage_label(self._narrow_label()) as sids:
            if self._pending_gather and len(self._parts) > 1:
                # pre_concat: the executor memoizes the gathered table by
                # partition identity, so a repeated query over the same
                # stored partitions reuses buffers (and with them the
                # window engine's sorted-frame cache).
                parts = [
                    self._executor.run_coalesced(
                        self._parts, run, pre_concat=True
                    )
                ]
            else:
                parts = self._executor.map_partitions(self._parts, run)
        out = DataFrame(parts, self._executor)
        out._exchange_keys = self._exchange_keys  # rows did not move
        out._aqe_layout = self._aqe_layout
        out._schema = self._schema  # pipeline already reflected in probe
        out._lineage = _resolve_lazy(self._lineage, sids)
        return out

    def mapPartitions(self, fn: Callable[[pa.Table], pa.Table]) -> "DataFrame":
        """Arbitrary per-partition Arrow transform — the escape hatch the
        reference gets from mapInPandas (reference:
        python/raydp/spark/dataset.py:520-534)."""
        return self._with(fn)

    # -- narrow ops -----------------------------------------------------
    def _apply_expr_stage(
        self,
        exprs: List[E.Expr],
        fn: Callable[[pa.Table], pa.Table],
        keeps_keys: Optional[Callable[[tuple], bool]] = None,
        op: str = "project",
    ) -> "DataFrame":
        """Run a projection stage with full expression semantics: window
        expressions force a hash exchange on their partition keys (elided
        when already partitioned on them), and partition-indexed
        expressions (monotonically_increasing_id) bind the index.

        ``keeps_keys(keys)`` says whether the stage preserves the key
        columns (for exchange-elision on chained window ops)."""
        wins = [w for e in exprs for w in find_window_exprs(e)]
        keys: Optional[tuple] = None
        base = self
        annotation = ""
        if wins:
            keys = tuple(wins[0].spec.partition_keys)
            for w in wins[1:]:
                if set(w.spec.partition_keys) != set(keys):
                    raise ValueError(
                        "all window functions in one projection must share "
                        f"partition keys; got {list(keys)} and "
                        f"{w.spec.partition_keys}"
                    )
            if keys_cover(self._exchange_keys, keys):
                # Already hash-partitioned on a subset of the window keys
                # → every window partition is whole inside one physical
                # partition; the window fn fuses into the pending
                # pipeline with no shuffle.
                if len(self._parts) > 1 and not self._pending_gather:
                    metrics.counter_add("shuffle/elided")
                    annotation = (
                        "window exchange elided: co-partitioned on "
                        f"{list(self._exchange_keys)}"
                    )
                else:
                    annotation = f"window over {list(keys)}"
            else:
                base = self._exchange_by_keys(
                    list(keys), reason="window"
                )
                annotation = f"window over {list(keys)}"

        if any(E.find_nodes(e, E.MonotonicId) for e in exprs):
            df = base._flush()

            def indexed(t: pa.Table, i: int) -> pa.Table:
                E._EVAL_CTX.partition_index = i
                try:
                    return fn(t)
                finally:
                    E._EVAL_CTX.partition_index = None

            with stage_label(op) as sids:
                parts = df._executor.map_partitions_indexed(
                    df._parts, indexed
                )
            out = DataFrame(parts, df._executor)
            out._lineage = df._lineage + [
                _node(op, annotation=annotation, stage_ids=sids)
            ]
        else:
            out = base._with(
                fn, _node(op, annotation=annotation, lazy=True)
            )

        # Propagate the ACTUAL partitioning of the evaluated base (which
        # may be finer than the window keys when the exchange was elided):
        # it survives iff the stage preserves those key columns.
        actual = base._exchange_keys
        out._exchange_keys = (
            actual
            if actual is not None
            and (keeps_keys is None or keeps_keys(actual))
            else None
        )
        out._aqe_layout = base._aqe_layout and out._exchange_keys is not None
        return out

    def select(self, *columns: ColumnLike) -> "DataFrame":
        exprs = [_as_expr(c) for c in columns]
        names = [_col_name(c) for c in columns]
        dupes = {n for n in names if names.count(n) > 1}
        if dupes:
            raise ValueError(
                f"duplicate output column names in select: {sorted(dupes)}; "
                "use .alias() to disambiguate"
            )

        def fn(t: pa.Table) -> pa.Table:
            arrays = [_as_array(e.evaluate(t), t.num_rows) for e in exprs]
            return pa.table(dict(zip(names, arrays)))

        # A projection keeps key co-location only if every key survives as
        # a plain column reference under its own name.
        plain = {
            n for n, e in zip(names, exprs) if isinstance(e, E.Col)
            and e.name == n
        }
        return self._apply_expr_stage(
            exprs, fn, keeps_keys=lambda keys: set(keys) <= plain,
            op=f"select[{','.join(names[:4])}{',...' if len(names) > 4 else ''}]",
        )

    def withColumn(self, name: str, column: E.Expr) -> "DataFrame":
        e = _as_expr(column)

        def fn(t: pa.Table) -> pa.Table:
            arr = _as_array(e.evaluate(t), t.num_rows)
            if name in t.column_names:
                idx = t.column_names.index(name)
                return t.set_column(idx, name, arr)
            return t.append_column(name, arr)

        # Adding a column keeps key co-location unless it overwrites a key.
        return self._apply_expr_stage(
            [e], fn, keeps_keys=lambda keys: name not in keys,
            op=f"withColumn[{name}]",
        )

    with_column = withColumn

    def _exchange_by_keys(
        self, keys: List[str], reason: str = "exchange"
    ) -> "DataFrame":
        """Hash-exchange so rows with equal key values land on the same
        partition (the shuffle behind window functions and distinct).

        Elided entirely when the frame is already hash-partitioned on a
        subset of ``keys`` (co-partitioning planner): equal key tuples
        are then already co-located, so the flushed frame is returned
        as-is — keeping its ORIGINAL (coarser ⇒ stronger) keys."""
        kstr = ",".join(keys)
        if keys_cover(self._exchange_keys, keys):
            elided = len(self._parts) > 1 and not self._pending_gather
            if elided:
                metrics.counter_add("shuffle/elided")
            out = self._flush()
            return out._annotated(_node(
                f"exchange[{kstr}]",
                annotation=(
                    "elided: co-partitioned on "
                    f"{list(self._exchange_keys)}"
                    if elided
                    else "noop: rows already co-located"
                ),
            ))
        df = self._flush()
        n_out = max(1, len(df._parts))
        if n_out == 1:
            df._exchange_keys = tuple(keys)  # trivially co-located
            return df._annotated(
                _node(f"exchange[{kstr}]", annotation="noop: 1 partition")
            )
        # Adaptive coalesce (Spark AQE shuffle-partition coalescing):
        # below the threshold one concatenated partition trivially
        # satisfies "whole groups co-located" at a fraction of the
        # exchange's task/IPC cost. LAZY: the concat fuses into the next
        # stage's task (no intermediate store round-trip).
        total_bytes = sum(df._executor.part_nbytes(p) for p in df._parts)
        if total_bytes <= _EXCHANGE_COALESCE_BYTES:
            out = DataFrame(df._parts, df._executor)
            out._pending_gather = True
            out._exchange_keys = tuple(keys)
            out._lineage = df._lineage + [_node(
                f"exchange[{kstr}]",
                annotation=f"coalesced: {total_bytes}B gather into 1 task",
                lazy=True,
            )]
            return out

        # AQE coalesce hook: merging whole buckets preserves key
        # co-location, so _exchange_keys still holds on the output —
        # only the canonical bucket↔index pairing is lost (_aqe_layout).
        # Salting is NEVER legal here: this exchange exists to co-locate
        # equal keys, which a bucket split would break.
        dec = _aqe.Decisions()
        plans: List[Any] = []
        replan = None
        if _aqe.aqe_enabled():
            def replan(bucket_bytes: List[int]):
                plan = _aqe.plan_exchange(
                    bucket_bytes,
                    len(df._parts),
                    min_parts=max(1, df._executor.default_fanout() // 2),
                    decisions=dec,
                )
                if plan is not None:
                    plans.append(plan)
                return plan

        with stage_label(f"exchange[{kstr}]") as sids:
            parts = df._executor.exchange(
                df._parts, _bucket_splitter(list(keys), n_out), n_out,
                replan=replan,
            )
        out = DataFrame(parts, df._executor)
        out._exchange_keys = tuple(keys)
        out._aqe_layout = bool(plans)
        out._lineage = df._lineage + [_node(
            f"exchange[{kstr}]",
            annotation=(
                f"hash exchange ({reason}), {n_out} buckets" + dec.suffix()
            ),
            stage_ids=sids,
        )]
        return out

    def distinct(self, subset: Optional[List[str]] = None) -> "DataFrame":
        """Drop duplicate rows (Spark ``distinct``/``dropDuplicates``) —
        wide: exchange on the subset, dedupe per partition."""
        df = self._flush()
        keys = subset or (df.columns if df._parts else [])
        if not keys:
            return df
        exchanged = df._exchange_by_keys(list(keys))

        all_cols = list(keys)

        def dedupe(t: pa.Table) -> pa.Table:
            if t.num_rows == 0:
                return t
            try:
                if subset:
                    # Keep the FIRST row per key (Spark dropDuplicates).
                    others = [
                        c for c in t.column_names if c not in subset
                    ]
                    agged = t.group_by(
                        list(subset), use_threads=False
                    ).aggregate([(c, "first") for c in others])
                    agged = agged.rename_columns(list(subset) + others)
                    return agged.select(t.column_names)
                # Full-row distinct: group by every column, no aggregates
                # — one vectorized arrow hash pass.
                return t.group_by(
                    all_cols, use_threads=False
                ).aggregate([])
            except (pa.ArrowInvalid, pa.ArrowNotImplementedError, TypeError):
                # Non-groupable dtypes (nested lists...): pandas fallback.
                import pandas as pd  # noqa: F401

                pdf = t.to_pandas().drop_duplicates(
                    subset=subset if subset else None
                )
                return pa.Table.from_pandas(
                    pdf, preserve_index=False, schema=t.schema
                )

        out = exchanged._with(
            dedupe, _node(f"distinct[{','.join(keys)}]", lazy=True)
        )._flush()
        # Dedupe drops rows in place — the exchange's co-location holds.
        out._exchange_keys = exchanged._exchange_keys
        return out

    dropDuplicates = distinct

    def explode(self, column: str, pos: Optional[str] = None) -> "DataFrame":
        """Explode a list column into one row per element, other columns
        repeated (Spark ``explode``; ``pos`` adds a position column for
        ``posexplode`` semantics)."""

        def _has_elements(v) -> bool:
            if v is None:
                return False
            if isinstance(v, float) and np.isnan(v):
                return False
            try:
                return len(v) > 0
            except TypeError:
                return False

        def fn(t: pa.Table) -> pa.Table:
            pdf = t.to_pandas()
            # Spark explode/posexplode emits NO row for null/empty arrays.
            pdf = pdf[pdf[column].map(_has_elements)]
            if pos is not None:
                pdf = pdf.assign(
                    **{pos: pdf[column].map(lambda v: list(range(len(v))))}
                )
                pdf = pdf.explode([pos, column], ignore_index=True)
            else:
                pdf = pdf.explode(column, ignore_index=True)
            return pa.Table.from_pandas(pdf, preserve_index=False)

        return self._with(fn)

    def posexplode(
        self,
        columns: List[str],
        pos_name: str = "pos",
        value_name: str = "col",
        keep: Optional[List[str]] = None,
    ) -> "DataFrame":
        """Melt ``columns`` into ``(pos, value)`` rows — the reference's
        DLRM categorical-frequency pattern
        ``select(posexplode(array(*cols)))`` (examples/pytorch_dlrm.ipynb).
        ``keep`` optionally carries extra columns through."""
        carry = list(keep or [])

        def fn(t: pa.Table) -> pa.Table:
            n = t.num_rows
            vals = [t.column(c) for c in columns]
            target = _common_type(vals)
            arrays = {
                pos_name: pa.array(
                    np.repeat(np.arange(len(columns), dtype=np.int64), n)
                ),
                value_name: pa.concat_arrays(
                    [v.combine_chunks().cast(target) for v in vals]
                ),
            }
            for c in carry:
                arrays[c] = pa.chunked_array(
                    [t.column(c).combine_chunks()] * len(columns)
                ).combine_chunks()
            return pa.table(arrays)

        return self._with(fn)

    def withColumnRenamed(self, old: str, new: str) -> "DataFrame":
        def fn(t: pa.Table) -> pa.Table:
            return t.rename_columns(
                [new if c == old else c for c in t.column_names]
            )

        return self._with(fn)

    def filter(self, condition: E.Expr) -> "DataFrame":
        def fn(t: pa.Table) -> pa.Table:
            mask = condition.evaluate(t)
            if isinstance(mask, pa.ChunkedArray):
                mask = mask.combine_chunks()
            return t.filter(mask)

        # Window predicates (e.g. the row_number()==1 dedup idiom) need
        # the exchange too; a row subset keeps key co-location intact.
        return self._apply_expr_stage(
            [condition], fn, keeps_keys=lambda keys: True, op="filter"
        )

    where = filter

    def drop(self, *names: str) -> "DataFrame":
        def fn(t: pa.Table) -> pa.Table:
            keep = [c for c in t.column_names if c not in names]
            return t.select(keep)

        return self._with(fn)

    def dropna(self, subset: Optional[List[str]] = None) -> "DataFrame":
        def fn(t: pa.Table) -> pa.Table:
            return t.drop_null() if subset is None else t.filter(
                _valid_mask(t, subset)
            )

        return self._with(fn)

    def fillna(self, value, subset: Optional[List[str]] = None) -> "DataFrame":
        def fn(t: pa.Table) -> pa.Table:
            out = t
            cols = subset or t.column_names
            for name in cols:
                if name not in out.column_names:
                    continue
                arr = out.column(name)
                fill = value.get(name) if isinstance(value, dict) else value
                if fill is None:
                    continue
                try:
                    filled = pc.fill_null(arr, pa.scalar(fill, type=arr.type))
                except (pa.ArrowInvalid, pa.ArrowTypeError, pa.ArrowNotImplementedError):
                    continue  # incompatible fill type for this column
                out = out.set_column(
                    out.column_names.index(name), name, filled
                )
            return out

        return self._with(fn)

    def map_batches(self, fn: Callable[[pa.Table], pa.Table]) -> "DataFrame":
        """Arbitrary vectorized transform (Spark mapInPandas parity —
        reference: python/raydp/spark/dataset.py:520-534)."""
        return self._with(fn)

    def mapInPandas(self, fn) -> "DataFrame":
        def wrapped(t: pa.Table) -> pa.Table:
            import pandas as pd

            out = fn(t.to_pandas())
            return pa.Table.from_pandas(out, preserve_index=False)

        return self._with(wrapped)

    def limit(self, n: int) -> "DataFrame":
        # Narrow approximation then global trim at collect time would be
        # wrong for counts; do it eagerly — but only over the PREFIX of
        # partitions actually consumed: the pending pipeline runs on
        # exponentially widening partition batches (1, 2, 4, ...) and
        # stops the moment ``remaining`` hits 0, instead of flushing the
        # whole frame to take its first n rows.
        if n <= 0:
            return DataFrame([], self._executor)
        df = self
        if self._pending_gather and len(self._parts) > 1:
            df = self._flush()  # coalesce collapses to one partition anyway
        pipeline = list(df._pending)

        def run(table: pa.Table) -> pa.Table:
            for fn in pipeline:
                table = fn(table)
            return table

        out_parts: List[Any] = []
        leftovers: List[Any] = []  # flushed past the cut; freed below
        remaining = n
        i, batch = 0, 1
        limit_ctx = stage_label(f"limit[{n}]")
        sids = limit_ctx.__enter__()
        while i < len(df._parts) and remaining > 0:
            raw = df._parts[i:i + batch]
            i += batch
            batch = min(batch * 2, 8)
            chunk = (
                df._executor.map_partitions(raw, run) if pipeline else raw
            )
            for part in chunk:
                if remaining <= 0:
                    if pipeline:
                        leftovers.append(part)
                    continue
                rows = df._executor.num_rows(part)
                if rows < 0:
                    rows = df._executor.materialize(part).num_rows
                if rows <= remaining:
                    out_parts.append(part)
                    remaining -= rows
                else:
                    trimmed = df._executor.map_partitions(
                        [part], lambda t, r=remaining: t.slice(0, r)
                    )
                    out_parts.append(trimmed[0])
                    if pipeline:
                        leftovers.append(part)
                    remaining = 0
        limit_ctx.__exit__(None, None, None)
        if leftovers:
            # The trim task consumes its source partition in flight —
            # defer the leftover discard until the outputs settle.
            _when_settled(
                out_parts, lambda: df._executor.discard(leftovers)
            )
        out = DataFrame(out_parts, df._executor)
        out._exchange_keys = df._exchange_keys  # prefix of partitions
        out._aqe_layout = df._aqe_layout
        out._lineage = df._lineage + [
            _node(f"limit[{n}]", stage_ids=sids)
        ]
        return out

    def union(self, other: "DataFrame") -> "DataFrame":
        a, b = self._flush(), other._flush()
        out = DataFrame(
            a._parts + _coerce_parts(b, a._executor), a._executor
        )
        out._lineage = a._lineage + [
            _node(f"union[+{len(b._parts)} parts]")
        ]
        return out

    # -- wide ops -------------------------------------------------------
    def repartition(self, n: int) -> "DataFrame":
        if n <= 0:
            raise ValueError("repartition count must be positive")
        df = self._flush()

        def splitter(t: pa.Table) -> List[pa.Table]:
            if t.num_rows == 0:
                return [t] * n
            sizes = _split_sizes(t.num_rows, n)
            outs, offset = [], 0
            for size in sizes:
                outs.append(t.slice(offset, size))
                offset += size
            return outs

        with stage_label(f"repartition[{n}]") as sids:
            parts = df._executor.exchange(df._parts, splitter, n)
        out = DataFrame(parts, df._executor)
        out._lineage = df._lineage + [_node(
            f"repartition[{n}]",
            annotation="even-slice exchange",
            stage_ids=sids,
        )]
        return out

    coalesce = repartition

    def groupBy(self, *keys: str) -> "GroupedData":
        return GroupedData(self, list(keys))

    groupby = groupBy

    def join(
        self,
        other: "DataFrame",
        on: Union[str, List[str]],
        how: str = "inner",
    ) -> "DataFrame":
        keys = [on] if isinstance(on, str) else list(on)
        left, right = self._flush(), other._flush()

        # Broadcast hash join (right side small — the baseline pipelines
        # join dimension tables). Under the cluster executor the broadcast
        # rides the shm store ONCE as an ObjectRef; embedding the table in
        # the closure would re-ship it in every per-partition task payload.
        join_type = {
            "inner": "inner",
            "left": "left outer",
            "right": "right outer",
            "outer": "full outer",
            "full": "full outer",
            "left_semi": "left semi",
            "left_anti": "left anti",
        }.get(how)
        if join_type is None:
            raise ValueError(f"unsupported join type {how!r}")

        # Co-partitioned zip join: when BOTH sides are already
        # hash-partitioned on exactly these keys with equal fanout and
        # matching key dtypes (the bucket function is a pure function of
        # key order, arrow types, and n_out), bucket i of the left can
        # only match bucket i of the right — join partition pairs in
        # place, no exchange and no broadcast. Valid for every join type
        # including outer joins: unmatched rows of either side exist in
        # exactly one bucket.
        tkeys = tuple(keys)
        if (
            left._exchange_keys == tkeys
            and right._exchange_keys == tkeys
            and len(left._parts) == len(right._parts)
            and len(left._parts) > 0
            # A replanned (coalesced/salted) layout is co-located but no
            # longer the canonical hash%n_out pairing, so bucket i of
            # one side need not match bucket i of the other.
            and not left._aqe_layout
            and not right._aqe_layout
            and _key_types_match(left, right, keys)
        ):
            if len(left._parts) > 1:
                metrics.counter_add("shuffle/elided", 2)
            with stage_label(f"join[{','.join(keys)}]") as sids:
                parts = left._executor.map_pairs(
                    left._parts,
                    _coerce_parts(right, left._executor),
                    lambda lt, rt: _join_aligned(lt, rt, keys, join_type),
                )
            out = DataFrame(parts, left._executor)
            out._exchange_keys = tkeys
            out._lineage = left._lineage + [_node(
                f"join[{','.join(keys)}]",
                annotation=(
                    "zip join: both sides co-partitioned"
                    + (", 2 exchanges elided" if len(left._parts) > 1
                       else "")
                ),
                stage_ids=sids,
            )]
            return out

        # Right/full outer joins MUST shuffle: a per-partition broadcast
        # join emits each unmatched right row once per left partition
        # (every partition independently null-pads it) — wrong results,
        # not just wrong perf. Large build sides also shuffle
        # (broadcasting would materialize and re-ship them whole —
        # Spark's autoBroadcastJoinThreshold decision).
        #
        # AQE join auto-pick: size the build side from MEASUREMENT —
        # settled partitions probe ref metadata directly; still-pending
        # streaming frames fall back to the recorded output bytes of the
        # stage producing them instead of barriering the pipeline.
        dec = _aqe.Decisions()
        semantics_forced = join_type in ("right outer", "full outer")
        if _aqe.aqe_enabled():
            right_bytes, src = _aqe.measured_frame_bytes(
                right._executor, right._parts, right._lineage
            )
            if not semantics_forced:
                strategy = (
                    "shuffle" if right_bytes > _BROADCAST_JOIN_BYTES
                    else "broadcast"
                )
                dec.record(
                    "join",
                    f"{strategy} picked from {src} build side "
                    f"({right_bytes}B vs {_BROADCAST_JOIN_BYTES}B"
                    " threshold)",
                )
        else:
            right_bytes = sum(
                right._executor.part_nbytes(p) for p in right._parts
            )
        if semantics_forced or right_bytes > _BROADCAST_JOIN_BYTES:
            return _shuffle_join(
                left, right, keys, join_type, decisions=dec
            )

        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        if isinstance(left._executor, ClusterExecutor) and right._parts:
            # Build the broadcast table in ONE worker-side task (concat
            # memoized by partition identity, output holder-owned in the
            # store): the driver never materializes the build side.
            broadcast_ref = left._executor.run_coalesced(
                _coerce_parts(right, left._executor), lambda t: t,
                pre_concat=True,
            )

            def fn(t: pa.Table) -> pa.Table:
                # Resolved worker-side via the ambient resolver (the
                # broadcast table lives on the driver node; workers on
                # other nodes pull it from the driver's store agent); only
                # the tiny ObjectRef travels in the task payload.
                from raydp_tpu_torch.store.object_store import (
                    resolve_ambient_table,
                )

                rt = resolve_ambient_table(broadcast_ref)
                return _join_aligned(t, rt, keys, join_type)

        else:
            right_table = _concat(
                [right._executor.materialize(p) for p in right._parts]
            )

            def fn(t: pa.Table) -> pa.Table:
                return _join_aligned(t, right_table, keys, join_type)

        out = left._with(fn, _node(
            f"join[{','.join(keys)}]",
            annotation=(
                f"broadcast right side ({right_bytes}B)" + dec.suffix()
            ),
            lazy=True,
        ))
        # Broadcast joins don't move left rows; left's partitioning (its
        # key columns survive the join output) carries through.
        out._exchange_keys = left._exchange_keys
        return out

    def orderBy(
        self, *columns: str, ascending: Union[bool, List[bool]] = True
    ) -> "DataFrame":
        df = self._flush()
        if isinstance(ascending, bool):
            ascending = [ascending] * len(columns)
        sort_keys = [
            (c, "ascending" if asc else "descending")
            for c, asc in zip(columns, ascending)
        ]
        n_out = len(df._parts)
        # Small data: ONE multithreaded arrow sort in one task beats the
        # sample-quantile range exchange (same adaptive decision as the
        # agg/window coalesce).
        small = n_out > 1 and sum(
            df._executor.part_nbytes(p) for p in df._parts
        ) <= _EXCHANGE_COALESCE_BYTES
        label = f"orderBy[{','.join(columns)}]"
        if n_out <= 1 or small:
            def sort_one(t: pa.Table) -> pa.Table:
                return t.sort_by(sort_keys)

            if small:
                with stage_label(label) as sids:
                    part = df._executor.run_coalesced(
                        df._parts, sort_one, pre_concat=True
                    )
                out = DataFrame([part], df._executor)
                out._lineage = df._lineage + [_node(
                    label, annotation="coalesced single-task sort",
                    stage_ids=sids,
                )]
                return out
            with stage_label(label) as sids:
                parts = df._executor.map_partitions(df._parts, sort_one)
            out = DataFrame(parts, df._executor)
            out._lineage = df._lineage + [_node(
                label, annotation="per-partition sort", stage_ids=sids
            )]
            return out

        # Range exchange on sampled quantiles of the first sort column,
        # then local sort (sample sort): a few values of each
        # partition, never a whole partition, fix the ranges.
        key0 = columns[0]
        samples = [
            np.asarray(s)
            for s in df._executor.sample_column(df._parts, key0, 64)
            if len(s)
        ]
        if not samples:
            return df
        flat = np.sort(np.concatenate(samples))
        qs = np.linspace(0, 1, n_out + 1)[1:-1]
        cuts = np.quantile(flat, qs) if len(flat) else []
        descending = not ascending[0]

        def splitter(t: pa.Table) -> List[pa.Table]:
            if t.num_rows == 0:
                return [t] * n_out
            vals = t.column(key0).to_pandas().to_numpy()
            bucket = np.searchsorted(cuts, vals, side="right")
            if descending:
                bucket = (n_out - 1) - bucket
            return _split_by_bucket(t, bucket.astype(np.int64), n_out)

        def combine(t: pa.Table) -> pa.Table:
            return t.sort_by(sort_keys)

        with stage_label(label) as sids:
            parts = df._executor.exchange(
                df._parts, splitter, n_out, combine
            )
        out = DataFrame(parts, df._executor)
        out._lineage = df._lineage + [_node(
            label,
            annotation=f"range exchange (sample sort), {n_out} buckets",
            stage_ids=sids,
        )]
        return out

    sort = orderBy

    def random_split(
        self, weights: List[float], seed: Optional[int] = None
    ) -> List["DataFrame"]:
        """Split rows randomly by weight (reference:
        python/raydp/utils.py random_split via Spark randomSplit)."""
        if not weights or any(w <= 0 for w in weights):
            raise ValueError("weights must be positive")
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])
        seed = secrets.randbits(31) if seed is None else seed
        df = self._flush()

        outs = []
        for i in range(len(weights)):
            lo = 0.0 if i == 0 else bounds[i - 1]
            hi = bounds[i]

            def fn(t: pa.Table, lo=lo, hi=hi) -> pa.Table:
                # Deterministic per-table draw keyed on content hash + seed
                # so every split pass sees identical uniforms.
                rng = np.random.default_rng(seed + _table_fingerprint(t))
                u = rng.random(t.num_rows)
                return t.filter(pa.array((u >= lo) & (u < hi)))

            outs.append(df._with(fn))
        return outs

    def sample(self, fraction: float, seed: Optional[int] = None) -> "DataFrame":
        """Bernoulli row sample (Spark ``df.sample``); same
        process-stable content-keyed draw as random_split so repeated
        passes see identical uniforms."""
        if not 0.0 <= fraction <= 1.0:
            raise ValueError("fraction must be in [0, 1]")
        seed = secrets.randbits(31) if seed is None else seed
        df = self._flush()

        def fn(t: pa.Table) -> pa.Table:
            rng = np.random.default_rng(seed + _table_fingerprint(t))
            return t.filter(pa.array(rng.random(t.num_rows) < fraction))

        return df._with(fn)

    # -- actions --------------------------------------------------------
    def collect_partitions(self) -> List[pa.Table]:
        df = self._flush()
        return [df._executor.materialize(p) for p in df._parts]

    def to_arrow(self) -> pa.Table:
        return _concat(self.collect_partitions())

    def to_pandas(self):
        return self.to_arrow().to_pandas()

    toPandas = to_pandas

    def count(self) -> int:
        df = self._flush()
        total = 0
        for part in df._parts:
            rows = df._executor.num_rows(part)
            if rows < 0:
                rows = df._executor.materialize(part).num_rows
            total += rows
        return total

    def show(self, n: int = 20) -> None:
        print(self.limit(n).to_pandas().to_string())

    # -- query profiling -------------------------------------------------
    def explain(self, analyze: bool = False, quiet: bool = False) -> str:
        """Render the logical plan with physical exchange decisions
        (hash exchange / elided / coalesced / broadcast).

        ``analyze=True`` EXECUTES the plan first (EXPLAIN ANALYZE) and
        renders per-stage runtime stats under each node: rows and bytes
        in/out, wall/dispatch/queue seconds, worker attribution, and the
        partition-skew ratio. Returns the rendered text (and prints it
        unless ``quiet``)."""
        df = self._flush() if analyze else self
        if analyze:
            # Streaming stages record their StageStats when the LAST
            # task lands; resolving the partitions guarantees that has
            # happened before stats render.
            df._parts = _resolve_parts(df._parts)
        text = _render_plan(df._lineage, analyze=analyze)
        if not quiet:
            print(text)
        return text

    def profile(self) -> Dict[str, Any]:
        """Execute the plan and return its profile as data: lineage
        nodes with their attached :class:`StageStats` dicts, plus the
        rendered EXPLAIN ANALYZE text. The structured form is what the
        adaptive planner (and tests) consume."""
        df = self._flush()
        df._parts = _resolve_parts(df._parts)  # stats land on completion
        nodes = []
        for node in df._lineage:
            stats = [
                s.to_dict()
                for s in (stage_store.get(i) for i in node["stage_ids"])
                if s is not None
            ]
            nodes.append({**node, "stats": stats})
        return {
            "plan": nodes,
            "explain": _render_plan(df._lineage, analyze=True),
        }

    @property
    def stage_stats(self) -> List[Any]:
        """StageStats records for every stage this frame's lineage has
        executed so far (lazy nodes contribute after a flush)."""
        # Streaming stages record their stats when the last task lands,
        # not when the stage is dispatched — settle in-flight partitions
        # first so a post-flush read sees completed stages.
        if any(_is_pending(p) for p in self._parts):
            self._parts = _resolve_parts(self._parts)
        out = []
        for node in self._lineage:
            for sid in node["stage_ids"]:
                s = stage_store.get(sid)
                if s is not None:
                    out.append(s)
        return out

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    @property
    def schema(self) -> pa.Schema:
        # Frames are immutable, so one probe serves every access —
        # repeated .schema/.columns reads must not re-fetch partitions.
        if self._schema is None:
            self._schema = self._peek().schema
        return self._schema

    def _peek(self) -> pa.Table:
        """First rows of the first partition with pending ops applied
        (schema probe)."""
        if not self._parts:
            return pa.table({})
        probe = self._executor.head(self._parts[0], 32)
        for fn in self._pending:
            probe = fn(probe)
        return probe

    @property
    def num_partitions(self) -> int:
        return len(self._parts)

    def persist(self) -> "DataFrame":
        return self._flush()

    cache = persist

    def write_parquet(self, path: str) -> None:
        """Write one ``part-NNNNN.parquet`` file per partition, all
        partitions concurrently: worker-side under the cluster executor
        (partitions never transit the driver; workers share the
        filesystem), a thread pool locally (parquet encoding releases
        the GIL)."""
        import os

        import pyarrow.parquet as pq

        df = self._flush()
        # Part files are named by partition index: resolve pendings so
        # the write tasks ship real refs/tables in index order.
        df._parts = _resolve_parts(df._parts)
        # Workers run with their own cwd — anchor relative paths here.
        target_dir = os.path.abspath(path)
        os.makedirs(target_dir, exist_ok=True)
        names = [
            os.path.join(target_dir, f"part-{i:05d}.parquet")
            for i in range(len(df._parts))
        ]

        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        if isinstance(df._executor, ClusterExecutor):
            from raydp_tpu_torch.cluster.cluster import TaskSpec

            def write_one(ctx, ref, name):
                table = ctx.get_table(ref)
                os.makedirs(os.path.dirname(name), exist_ok=True)
                pq.write_table(table, name)
                return True

            futures = df._executor.cluster.submit_batch([
                TaskSpec(
                    write_one, (ref, name),
                    worker_id=df._executor._worker_for(i, ref),
                )
                for i, (ref, name) in enumerate(zip(df._parts, names))
            ])
            for f in futures:
                f.result()
            return
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(
            max_workers=min(8, max(1, len(df._parts)))
        ) as pool:
            list(pool.map(pq.write_table, df._parts, names))

    # -- shard handoff --------------------------------------------------
    def to_object_refs(self, owner_transfer: bool = True) -> List[Any]:
        """Materialize partitions into the session object store and return
        refs (the reference's _save_spark_df_to_object_store,
        dataset.py:198-219)."""
        df = self._flush()
        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        if isinstance(df._executor, ClusterExecutor):
            refs = _resolve_parts(list(df._parts))
            if owner_transfer:
                store = df._executor.store
                refs = [store.transfer_to_holder(r) for r in refs]
            return refs
        from raydp_tpu_torch.context import current_session

        session = current_session()
        if session is None:
            raise RuntimeError(
                "to_object_refs without a live session requires cluster "
                "execution; call raydp_tpu_torch.init() first"
            )
        store = session.cluster.master.store
        return [store.put_arrow_table(t) for t in df.collect_partitions()]

    def _to_block_parts(self, owner_transfer: bool = True):
        """Streaming twin of :meth:`to_object_refs` for the MLDataset
        handoff: partitions may still be pending ETL tasks, in which
        case the owner transfer is chained onto their resolution instead
        of barriering — the device loader can start ingesting early blocks
        while late ones are still being produced. Returns ``None`` when
        this frame is not cluster-executed (caller falls back)."""
        df = self._flush()
        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        if not isinstance(df._executor, ClusterExecutor):
            return None
        if not owner_transfer:
            return list(df._parts)
        store = df._executor.store
        return [_chain_part(p, store.transfer_to_holder) for p in df._parts]


class GroupedData:
    """``df.groupBy(keys).agg(...)`` with distributed partial aggregation."""

    _MERGEABLE = {
        "count": "sum",
        "sum": "sum",
        "min": "min",
        "max": "max",
        "sumsq": "sum",
        "first": "first",
        "last": "last",
    }

    def __init__(self, df: DataFrame, keys: List[str]):
        if not keys:
            raise ValueError("groupBy needs at least one key")
        self.df = df
        self.keys = keys

    def count(self) -> DataFrame:
        return self.agg(("*", "count"))

    def applyInPandas(self, fn: Callable, schema=None) -> DataFrame:
        """Grouped-map: hash-exchange so each physical partition holds
        whole groups, then run ``fn(group_pdf) -> pdf`` per group (the
        pyspark ``GroupedData.applyInPandas`` surface; pyspark likewise
        takes an output schema). ``schema`` (pa.Schema) fixes the output
        schema — pass it whenever ``fn`` CHANGES the columns, or
        group-less partitions would surface the input schema."""
        import pandas as pd

        keys = self.keys
        df = self.df._exchange_by_keys(keys)

        def stage(t: pa.Table) -> pa.Table:
            pdf = t.to_pandas()
            outs = [
                fn(group.reset_index(drop=True))
                for _, group in pdf.groupby(keys, sort=False, dropna=False)
            ]
            outs = [o for o in outs if o is not None and len(o)]
            if not outs:
                # Empty output must still carry the OUTPUT schema.
                if schema is not None:
                    return schema.empty_table()
                return t.slice(0, 0)
            out = pa.Table.from_pandas(
                pd.concat(outs, ignore_index=True), preserve_index=False
            )
            if schema is not None:
                out = out.select(schema.names).cast(schema)
            return out

        return df._with(
            stage,
            _node(f"applyInPandas[{','.join(keys)}]", lazy=True),
        )

    apply_in_pandas = applyInPandas

    def agg(self, *aggs: Union[Tuple[str, str], Dict[str, str]]) -> DataFrame:
        specs: List[Tuple[str, str]] = []
        for a in aggs:
            if isinstance(a, dict):
                specs.extend(a.items())
            else:
                specs.append(a)
        if not specs:
            raise ValueError("agg needs at least one aggregation")

        keys = self.keys
        # Decompose composite aggregations into mergeable partials
        # (distributed two-phase agg: per-partition partials → hash
        # exchange → merge + finalize).
        partial_specs: List[Tuple[str, str]] = []
        for col_name, op in specs:
            if op in ("mean", "avg"):
                partial_specs.append((col_name, "sum"))
                partial_specs.append((col_name, "count"))
            elif op in _STAT_OPS:  # stddev/variance need E[x], E[x²], n
                partial_specs.append((col_name, "sum"))
                partial_specs.append((col_name, "sumsq"))
                partial_specs.append((col_name, "count"))
            elif op in _DISTINCT_OPS:
                partial_specs.append((col_name, "cdistinct"))
            elif op in ("collect_list", "collect_set"):
                partial_specs.append(
                    (col_name, "list" if op == "collect_list" else "distinct")
                )
            elif op == "count":
                partial_specs.append((col_name, "count"))
            elif op in self._MERGEABLE:
                partial_specs.append((col_name, op))
            else:
                raise ValueError(f"unsupported aggregation {op!r}")
        partial_specs = list(dict.fromkeys(partial_specs))

        df = self.df._flush()
        # Bind plain locals for the shipped closures — referencing ``self``
        # would drag the executor (locks, sockets) into cloudpickle.
        mergeable = dict(self._MERGEABLE)

        def partial_fn(t: pa.Table) -> pa.Table:
            return _local_agg(t, keys, partial_specs)

        def combine(t: pa.Table) -> pa.Table:
            # No empty early-return: an empty bucket must still finalize
            # to the FINAL output schema (partial-schema empties would
            # leak into schema probes and per-partition elided aggs).
            merge_specs = []
            rename = {}
            list_partials = []  # (partial_name, final_arrow_op)
            for c, op in partial_specs:
                p = _partial_name(c, op)
                if op == "cdistinct":
                    list_partials.append((p, "count_distinct"))
                elif op == "distinct":
                    list_partials.append((p, "distinct"))
                elif op == "list":
                    list_partials.append((p, "list"))
                else:
                    merge_specs.append((p, mergeable[op]))
                    rename[f"{p}_{mergeable[op]}"] = p
            merged = _group_by(t, keys, merge_specs).aggregate(merge_specs)
            merged = merged.rename_columns(
                [rename.get(c, c) for c in merged.column_names]
            )
            # List/distinct partials are list columns; flatten them back
            # to (key, value) rows, re-aggregate, and join onto the merged
            # aggregates (arrow's hash_list can't nest lists). Note an
            # arrow join rejects list payloads, so count_distinct reduces
            # to an int before the join while collect_* joins the rebuilt
            # list via a manual index join.
            for p, final in list_partials:
                col = t.column(p).combine_chunks()
                flat = pc.list_flatten(col)
                parents = pc.list_parent_indices(col)
                # Spark's collect_list/collect_set/count_distinct all ignore
                # nulls; arrow's hash_list keeps them — drop here so an
                # all-null group falls through to the default-fill below.
                valid = pc.is_valid(flat)
                flat = flat.filter(valid)
                parents = parents.filter(valid)
                sub = pa.table(
                    {**{k: pc.take(t.column(k), parents) for k in keys},
                     p: flat}
                )
                sub_agg = sub.group_by(keys).aggregate([(p, final)])
                sub_agg = sub_agg.rename_columns(
                    [p if c == f"{p}_{final}" else c
                     for c in sub_agg.column_names]
                )
                # Arrow joins reject list payloads (and would also have to
                # run before any previously-appended list column): align
                # by key tuple in python — group counts, not rows.
                # NaN keys: two float('nan') pylist values are distinct
                # dict keys (NaN != NaN, id-based hash), while arrow's
                # hash_aggregate groups them together — normalize to a
                # sentinel so a NaN group with real values matches its
                # aggregate instead of silently taking the empty default.
                def _key_of(row):
                    return tuple(
                        "__raydp_nan__"
                        if isinstance(row[k], float) and row[k] != row[k]
                        else row[k]
                        for k in keys
                    )

                order = {
                    _key_of(row): i
                    for i, row in enumerate(
                        sub_agg.select(keys).to_pylist()
                    )
                }
                values = sub_agg.column(p).combine_chunks()
                # A group whose values are ALL null is absent from sub_agg
                # (arrow's hash_distinct/hash_list partials drop nulls), so
                # a plain order[...] lookup KeyErrors. Map missing groups to
                # an appended default: 0 for count_distinct, [] for
                # collect_list/collect_set — matching Spark's semantics.
                default = (
                    pa.array([0], type=values.type)
                    if final == "count_distinct"
                    else pa.array([[]], type=values.type)
                )
                values = pa.concat_arrays([values, default])
                missing_idx = len(order)
                idx = [
                    order.get(_key_of(row), missing_idx)
                    for row in merged.select(keys).to_pylist()
                ]
                merged = merged.append_column(
                    p, values.take(pa.array(idx, type=pa.int64()))
                )
            return _finalize_agg(merged, keys, specs)

        # -- adaptive plan (Spark AQE-style, sized from partition stats) --
        # Tier 0 (co-partitioning planner): the frame is already
        # hash-partitioned on a subset of the groupBy keys, so every
        # group lives whole inside one partition — aggregate each
        # partition independently, NO shuffle at all. Output partitions
        # keep the input's (coarser ⇒ stronger) co-location keys.
        label = f"groupBy[{','.join(keys)}].agg"
        # -- AQE skew rebalance (rule: salt) ----------------------------
        # When the measured input layout is skewed, a per-partition plan
        # (tier 0/1) serializes on the hot partition. Replace each hot
        # partition with k zero-copy row slices and commit to the
        # two-phase partial→merge plan: slices stay in partition order,
        # so order-sensitive partials (collect_list) merge identically
        # and EVERY agg spec stays bit-identical to the static plan.
        # Probe only settled partitions (ref metadata, no materialize);
        # still-streaming frames keep the static plan.
        aqe_dec = _aqe.Decisions()
        rebalance = None
        in_rows: List[int] = []
        if (
            _aqe.aqe_enabled()
            and len(df._parts) > 1
            and not df._pending_gather
            and _all_settled(df._parts)
        ):
            in_rows = [df._executor.num_rows(p) for p in df._parts]
            rebalance = _aqe.plan_rebalance(
                [df._executor.part_nbytes(p) for p in df._parts], in_rows
            )
        if rebalance is None and keys_cover(
            df._exchange_keys, keys
        ) and not df._pending_gather:
            was_elided = len(df._parts) > 1
            if was_elided:
                metrics.counter_add("shuffle/elided")
            if _direct_agg_supported(specs):
                keys_ = list(keys)
                specs_ = list(specs)

                def elided(table: pa.Table) -> pa.Table:
                    return _direct_agg(table, keys_, specs_)

            else:

                def elided(table: pa.Table) -> pa.Table:
                    return combine(_local_agg(table, keys, partial_specs))

            with stage_label(label) as sids:
                parts = df._executor.map_partitions(df._parts, elided)
            out = DataFrame(parts, df._executor)
            out._exchange_keys = df._exchange_keys
            out._lineage = df._lineage + [_node(
                label,
                annotation=(
                    "exchange elided: co-partitioned on "
                    f"{list(df._exchange_keys)}"
                    if was_elided
                    else "per-partition agg, rows already co-located"
                ),
                stage_ids=sids,
            )]
            return out
        # Tier 1: small input + ops arrow can finalize in one pass → ONE
        # task running arrow's hash aggregation (internally multithreaded).
        # A process-level exchange on data this size would spend more on
        # task orchestration + IPC than on aggregation.
        total_bytes = sum(
            df._executor.part_nbytes(p) for p in df._parts
        )
        if (
            rebalance is None
            and total_bytes <= _AGG_COALESCE_BYTES
            and _direct_agg_supported(specs)
        ):
            keys_ = list(keys)
            specs_ = list(specs)

            def direct(table: pa.Table) -> pa.Table:
                return _direct_agg(table, keys_, specs_)

            with stage_label(label) as sids:
                part = df._executor.run_coalesced(
                    df._parts, direct, pre_concat=True
                )
            out = DataFrame([part], df._executor)
            out._exchange_keys = tuple(keys)  # single partition
            out._lineage = df._lineage + [_node(
                label,
                annotation=(
                    f"coalesced: {total_bytes}B single-task agg"
                ),
                stage_ids=sids,
            )]
            return out
        # Fan-out scales with the executor's parallelism.
        n_out = max(
            1, min(len(df._parts), df._executor.default_fanout())
        )
        splitter = _bucket_splitter(list(keys), n_out)

        # Tier 2/3: map-side partial aggregation first (shrinks the data
        # to ~groups × partitions rows), THEN size the shuffle from the
        # measured partial sizes: small partials merge in one task; big
        # ones hash-exchange across the full fan-out.
        if rebalance is not None:
            aqe_dec.record(
                "salt",
                f"sliced {len(rebalance)} hot partition(s) into "
                f"{sum(rebalance.values())} partial slices"
                " (two-phase agg)",
            )
            metrics.counter_add("aqe/salted_keys", len(rebalance))
            # Expanded parts repeat a hot partition's handle k times; a
            # ranges map turns repeat j into the j-th zero-copy row
            # slice inside the partial task itself (no new executor
            # surface).
            expanded: List[Any] = []
            ranges: Dict[int, Tuple[int, int]] = {}
            for i, p in enumerate(df._parts):
                k = rebalance.get(i, 0)
                if k <= 1:
                    expanded.append(p)
                    continue
                base_rows, extra = divmod(in_rows[i], k)
                off = 0
                for j in range(k):
                    size = base_rows + (1 if j < extra else 0)
                    ranges[len(expanded)] = (off, size)
                    expanded.append(p)
                    off += size

            def sliced_partial(t: pa.Table, idx: int) -> pa.Table:
                r = ranges.get(idx)
                if r is not None:
                    t = t.slice(r[0], r[1])
                return partial_fn(t)

            with stage_label(f"{label}:partial") as sids_p:
                partials = df._executor.map_partitions_indexed(
                    expanded, sliced_partial
                )
        else:
            with stage_label(f"{label}:partial") as sids_p:
                partials = df._executor.map_partitions(
                    df._parts, partial_fn
                )
        partial_bytes = sum(
            df._executor.part_nbytes(p) for p in partials
        )
        if partial_bytes <= _COMBINE_COALESCE_BYTES or n_out == 1:

            # NOT pre_concat: the partial-agg partitions are brand-new
            # objects every run, so memoizing their concat would only
            # fill the cache with dead entries.
            def merge_all(tables: List[pa.Table]) -> pa.Table:
                from raydp_tpu_torch.dataframe.executor import _concat

                return combine(_concat(tables))

            with stage_label(f"{label}:merge") as sids_m:
                part = df._executor.run_coalesced(partials, merge_all)
            df._executor.discard(partials)
            out = DataFrame([part], df._executor)
            out._exchange_keys = tuple(keys)  # single partition
            out._lineage = df._lineage + [_node(
                label,
                annotation=(
                    f"coalesced: {partial_bytes}B of partials merged"
                    " in 1 task" + aqe_dec.suffix()
                ),
                stage_ids=sids_p + sids_m,
            )]
            return out
        # AQE coalesce hook on the partial exchange (salting is illegal
        # here: the per-bucket combine must see whole key groups).
        plans: List[Any] = []
        replan = None
        if _aqe.aqe_enabled():
            n_in = len(partials)

            def replan(bucket_bytes: List[int]):
                plan = _aqe.plan_exchange(
                    bucket_bytes,
                    n_in,
                    min_parts=max(1, df._executor.default_fanout() // 2),
                    decisions=aqe_dec,
                )
                if plan is not None:
                    plans.append(plan)
                return plan

        with stage_label(f"{label}:exchange") as sids_x:
            parts = df._executor.exchange(
                partials, splitter, n_out, combine, replan=replan
            )
        df._executor.discard(partials)
        out = DataFrame(parts, df._executor)
        # The exchange bucketed the partials by the groupBy keys; each
        # output row stays in its bucket, so the result is hash-
        # partitioned on them — downstream wide ops on these keys elide.
        out._exchange_keys = tuple(keys)
        out._aqe_layout = bool(plans)
        out._lineage = df._lineage + [_node(
            label,
            annotation=(
                f"hash exchange of partials, {n_out} buckets"
                + aqe_dec.suffix()
            ),
            stage_ids=sids_p + sids_x,
        )]
        return out


# -- helpers ---------------------------------------------------------------
def _join_aligned(
    t: pa.Table, rt: pa.Table, keys: List[str], join_type: str
) -> pa.Table:
    # Align key dtypes (e.g. string vs large_string from different
    # construction paths) — arrow joins require exact type match.
    for k in keys:
        lt_type = t.schema.field(k).type
        rt_type = rt.schema.field(k).type
        if lt_type != rt_type:
            rt = rt.set_column(
                rt.column_names.index(k), k, pc.cast(rt.column(k), lt_type)
            )
    return t.join(rt, keys=keys, join_type=join_type)


def _fmt_bytes(n: int) -> str:
    x = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(x) < 1024.0 or unit == "TiB":
            return f"{x:.1f}{unit}" if unit != "B" else f"{int(x)}B"
        x /= 1024.0
    return f"{int(n)}B"


def _render_plan(lineage: List[Dict[str, Any]], analyze: bool) -> str:
    """EXPLAIN [ANALYZE] text for a lineage list (see _node)."""
    lines = [
        "== Physical Plan ==" if analyze else "== Logical Plan =="
    ]
    exchanges = elided = coalesced = 0
    for i, node in enumerate(lineage):
        ann = node.get("annotation", "")
        if ann.startswith("hash exchange") or ann.startswith(
            "range exchange"
        ) or ann.startswith("even-slice exchange"):
            exchanges += 2 if "both sides" in ann else 1
            if "exchange elided" in ann:  # one-sided shuffle join
                elided += 1
        elif "2 exchanges elided" in ann:
            elided += 2
        elif ann.startswith("elided") or "exchange elided" in ann:
            elided += 1
        elif ann.startswith("coalesced:"):
            coalesced += 1
        prefix = "" if i == 0 else " +- "
        text = node["op"]
        if ann:
            text += f" ({ann})"
        if node.get("lazy"):
            text += " [pending]"
        lines.append(prefix + text)
        if analyze:
            for sid in node["stage_ids"]:
                s = stage_store.get(sid)
                if s is None:
                    lines.append(f"      stage {sid}: (evicted)")
                    continue
                workers = len(s.workers)
                lines.append(
                    f"      stage {s.stage_id} [{s.executor}]"
                    f" rows {s.rows_in:,} -> {s.rows_out:,}"
                    f"  bytes {_fmt_bytes(s.bytes_in)} ->"
                    f" {_fmt_bytes(s.bytes_out)}"
                    f"  wall {s.wall_s:.3f}s"
                    f" (dispatch {s.dispatch_s:.3f}s,"
                    f" queue {s.queue_s:.3f}s)"
                    f"  skew {s.skew:.2f}"
                    + (f"  workers={workers}" if workers else "")
                )
    lines.append(
        f"== Exchanges == ran: {exchanges}, elided: {elided},"
        f" coalesced: {coalesced}"
    )
    # AQE footer: marker counts per rule, rendered ONLY when a replan
    # fired so static plans (and RAYDP_TPU_AQE=0 runs) are unchanged.
    # Counting the aqe[...] markers — not a separate tally — keeps the
    # footer structurally equal to the raydp_aqe_replans_total counters.
    aqe_counts = _aqe.rule_counts(
        "\n".join(n.get("annotation", "") for n in lineage)
    )
    if aqe_counts:
        lines.append(
            "== AQE == "
            + ", ".join(
                f"{rule}: {aqe_counts[rule]}"
                for rule in _aqe.RULES
                if rule in aqe_counts
            )
        )
    return "\n".join(lines)


def _coerce_parts(df: "DataFrame", executor: Executor) -> List[Any]:
    """``df``'s partitions usable by ``executor`` — binary ops (union,
    shuffle join) may mix a local frame with a cluster one; materialize
    and re-put when the executors differ."""
    if df._executor is executor or type(df._executor) is type(executor):
        return list(df._parts)
    return [
        executor.put(df._executor.materialize(p)) for p in df._parts
    ]


def _key_types_match(a: "DataFrame", b: "DataFrame", keys: List[str]) -> bool:
    """Whether both frames carry the join keys with IDENTICAL arrow
    types. The hash-bucket function picks its algorithm from the key
    schema and hashes raw values, so co-partitioning of two frames is
    only comparable when the key dtypes match exactly."""
    try:
        sa, sb = a.schema, b.schema
        return all(sa.field(k).type == sb.field(k).type for k in keys)
    except KeyError:
        return False


def _as_expr(c: ColumnLike) -> E.Expr:
    return E.Col(c) if isinstance(c, str) else c


def _col_name(c: ColumnLike) -> str:
    return c if isinstance(c, str) else c.name


def _as_array(value, num_rows: int):
    if isinstance(value, pa.Scalar):
        return pa.nulls(num_rows, value.type) if value.as_py() is None else (
            pa.array([value.as_py()] * num_rows, type=value.type)
        )
    return value


def _valid_mask(t: pa.Table, subset: List[str]):
    mask = None
    for name in subset:
        valid = pc.is_valid(t.column(name))
        mask = valid if mask is None else pc.and_(mask, valid)
    return mask


def _split_sizes(total: int, parts: int) -> List[int]:
    base, extra = divmod(total, parts)
    return [base + (1 if i < extra else 0) for i in range(parts)]


def _table_fingerprint(t: pa.Table) -> int:
    """Cheap content fingerprint, deterministic ACROSS PROCESSES (no
    Python str hash — it's salted per process; random_split's complementary
    filters may execute in different processes and must draw identical
    uniforms)."""
    import zlib

    h = t.num_rows
    if t.num_rows and t.num_columns:
        first = str(t.column(0)[0].as_py())
        last = str(t.column(0)[t.num_rows - 1].as_py())
        h = zlib.crc32(f"{h}|{first}|{last}".encode()) & 0x7FFFFFFF
    return h


def _common_type(cols) -> pa.DataType:
    """Promotion for posexplode'd columns: equal types pass through,
    mixed numerics widen, anything else goes to string."""
    types = {c.type for c in cols}
    if len(types) == 1:
        return next(iter(types))
    if all(
        pa.types.is_integer(t) or pa.types.is_floating(t) for t in types
    ):
        if any(pa.types.is_floating(t) for t in types):
            return pa.float64()
        return pa.int64()
    return pa.string()


def _hash_bucket(t: pa.Table, keys: List[str], n: int) -> np.ndarray:
    """Per-row shuffle bucket ids.

    CONSISTENCY: partitions of one exchange hash independently in
    different processes, so the algorithm choice must depend only on the
    SCHEMA (identical across partitions), never on per-partition
    properties. Numeric key schemas take the splitmix64 partitioner
    (native kernel, or its bit-exact numpy twin when the .so is absent)
    with nulls carried as explicit validity columns; anything else uses
    the pandas hash.
    """
    from raydp_tpu_torch.native import lib as native

    fields = [t.schema.field(k).type for k in keys]
    if all(
        pa.types.is_integer(ft) or pa.types.is_floating(ft) for ft in fields
    ):
        arrays, masks = [], []
        for k in keys:
            c = t.column(k).combine_chunks()
            # Nulls: hash a typed zero plus the validity bit as an extra
            # u8 column — null-free partitions produce all-ones masks, so
            # results stay consistent whether or not nulls are present.
            masks.append(
                pc.is_valid(c).to_numpy(zero_copy_only=False).astype(np.uint8)
            )
            arrays.append(
                pc.fill_null(c, 0).to_numpy(zero_copy_only=False)
            )
        bucket = native.hash_bucket(arrays + masks, n)
        if bucket is not None:
            return bucket
    import pandas as pd

    df = t.select(keys).to_pandas()
    codes = pd.util.hash_pandas_object(df, index=False).to_numpy()
    return (codes % n).astype(np.int64)


def _split_by_bucket(t: pa.Table, bucket: np.ndarray, n: int) -> List[pa.Table]:
    """One stable sort + take, then zero-copy slices per bucket — replaces
    n full filter scans in the exchange splitters."""
    # Narrow the sort key first: numpy's stable argsort radix-sorts
    # uint8/uint16 in O(n) single-digit passes, ~16x the int64
    # comparison sort at 1.5M rows — and fan-outs never exceed 2^16.
    if n <= np.iinfo(np.uint8).max:
        bucket = bucket.astype(np.uint8)
    elif n <= np.iinfo(np.uint16).max:
        bucket = bucket.astype(np.uint16)
    order = np.argsort(bucket, kind="stable")
    taken = t.take(pa.array(order))
    counts = np.bincount(bucket, minlength=n)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    return [taken.slice(offsets[i], counts[i]) for i in range(n)]


def _bucket_splitter(keys: List[str], n_out: int, cast_to=None):
    """THE hash-exchange splitter (groupBy merge phase, key co-location,
    both sides of a shuffle join): rows route to ``hash(keys) % n_out``.
    ``cast_to`` ({key: pa type}) aligns key dtypes first — both sides of
    a join must bucket identical key VALUES identically, and
    _hash_bucket's algorithm choice depends on the schema."""

    def splitter(t: pa.Table) -> List[pa.Table]:
        if cast_to:
            for k, typ in cast_to.items():
                if t.schema.field(k).type != typ:
                    t = t.set_column(
                        t.column_names.index(k), k,
                        pc.cast(t.column(k), typ),
                    )
        if t.num_rows == 0:
            return [t] * n_out
        bucket = _hash_bucket(t, keys, n_out)
        return _split_by_bucket(t, bucket, n_out)

    return splitter


def _partial_name(col_name: str, op: str) -> str:
    return f"__{op}__{col_name}"


_ROWS_COL = "__rows__"


_STAT_OPS = ("stddev", "std", "stddev_samp", "variance", "var", "var_samp")
_DISTINCT_OPS = ("count_distinct", "countDistinct", "approx_count_distinct")


def _env_bytes(name: str, default: int) -> int:
    import os

    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


# Adaptive-shuffle thresholds (Spark AQE's advisoryPartitionSizeInBytes
# analog). Below _AGG_COALESCE_BYTES of INPUT, aggregation runs as one
# arrow pass in one task; below _COMBINE_COALESCE_BYTES of measured
# PARTIAL size, the merge phase runs in one task instead of a hash
# exchange. Arrow's hash aggregation threads internally, so the single
# task still uses every core of its host.
_AGG_COALESCE_BYTES = _env_bytes("RAYDP_TPU_AGG_COALESCE_BYTES", 128 << 20)
_COMBINE_COALESCE_BYTES = _env_bytes(
    "RAYDP_TPU_COMBINE_COALESCE_BYTES", 64 << 20
)
# 64MB matches Spark AQE's default advisory partition size: below it a
# hash exchange produces shuffle partitions smaller than Spark itself
# would advise, so one coalesced task (arrow kernels thread internally,
# and the gather-concat is memoized across repeated queries) wins.
_EXCHANGE_COALESCE_BYTES = _env_bytes(
    "RAYDP_TPU_EXCHANGE_COALESCE_BYTES", 64 << 20
)
_BROADCAST_JOIN_BYTES = _env_bytes(
    "RAYDP_TPU_BROADCAST_JOIN_BYTES", 64 << 20
)


def _shuffle_join(
    left: "DataFrame",
    right: "DataFrame",
    keys: List[str],
    join_type: str,
    decisions: Optional["_aqe.Decisions"] = None,
) -> "DataFrame":
    """Shuffle hash join: both sides exchange on the join keys with the
    SAME bucketing, then bucket i joins bucket i (Spark's
    SortMergeJoin/ShuffledHashJoin role for large×large joins; the
    broadcast join handles the dimension-table case).

    One-sided elision: when ONE side is already hash-partitioned on
    exactly these keys, only the other side exchanges — into the
    partitioned side's fanout, with its key dtypes (the bucket function
    must be identical on both sides).

    AQE (both-sides branch only — one-sided elision must reproduce the
    partitioned side's existing layout bucket-for-bucket): the probe
    (left) exchange may coalesce small buckets and, for join types where
    replicating build rows is sound, split a hot bucket across k
    sub-buckets; the build (right) exchange then runs the CONFORMED
    plan — same merges, split→replicate — so pair i of the zipped merge
    still joins identical key sets."""
    tkeys = tuple(keys)
    kstr = ",".join(keys)
    dec = decisions if decisions is not None else _aqe.Decisions()
    lparts: List[Any] = []
    rparts: List[Any] = []
    l_tmp = r_tmp = True  # whether the part lists are exchange temps
    nodes: List[Dict[str, Any]] = []
    salted = replanned = False
    if left._exchange_keys == tkeys and left._parts and (
        not left._aqe_layout
    ) and _key_types_match(
        left, right, keys
    ):
        # Left already bucketed → re-bucket only the right, to left's
        # fanout/dtypes. Left's parts are the frame's LIVE partitions —
        # never discarded here.
        n_out = len(left._parts)
        if n_out > 1:
            metrics.counter_add("shuffle/elided")
        lparts, l_tmp = list(left._parts), False
        sch = left.schema
        left_schema = {k: sch.field(k).type for k in keys}
        with stage_label(f"exchange[{kstr}]") as sids:
            rparts = left._executor.exchange(
                _coerce_parts(right, left._executor),
                _bucket_splitter(keys, n_out, cast_to=left_schema),
                n_out,
            )
        nodes.append(_node(
            f"exchange[{kstr}]",
            annotation=(
                "hash exchange (right side only; left exchange elided)"
                if n_out > 1 else "hash exchange (right side)"
            ),
            stage_ids=sids,
        ))
    elif right._exchange_keys == tkeys and right._parts and (
        not right._aqe_layout
    ) and _key_types_match(
        left, right, keys
    ):
        n_out = len(right._parts)
        if n_out > 1:
            metrics.counter_add("shuffle/elided")
        rparts, r_tmp = _coerce_parts(right, left._executor), False
        sch = right.schema
        right_schema = {k: sch.field(k).type for k in keys}
        with stage_label(f"exchange[{kstr}]") as sids:
            lparts = left._executor.exchange(
                left._parts,
                _bucket_splitter(keys, n_out, cast_to=right_schema),
                n_out,
            )
        nodes.append(_node(
            f"exchange[{kstr}]",
            annotation=(
                "hash exchange (left side only; right exchange elided)"
                if n_out > 1 else "hash exchange (left side)"
            ),
            stage_ids=sids,
        ))
    else:
        n_out = max(
            1,
            min(
                max(len(left._parts), len(right._parts)),
                left._executor.default_fanout(),
            ),
        )
        sch = left.schema  # one _peek: schema access materializes a probe
        left_schema = {k: sch.field(k).type for k in keys}
        # Probe-side split + build-side replicate conserves the join
        # result only when unmatched BUILD rows never surface (they
        # would be emitted once per sub-bucket otherwise).
        salt_ok = join_type in (
            "inner", "left outer", "left semi", "left anti"
        )
        plans: List[Any] = []
        lreplan = None
        if _aqe.aqe_enabled():
            n_in = len(left._parts)

            def lreplan(bucket_bytes: List[int]):
                plan = _aqe.plan_exchange(
                    bucket_bytes,
                    n_in,
                    allow_salt=salt_ok,
                    min_parts=max(1, left._executor.default_fanout() // 2),
                    decisions=dec,
                )
                if plan is not None:
                    plans.append(plan)
                return plan

        with stage_label(f"exchange[{kstr}]") as sids:
            lparts = left._executor.exchange(
                left._parts, _bucket_splitter(keys, n_out), n_out,
                replan=lreplan,
            )
            rreplan = None
            if plans:
                rreplan = lambda _bb: plans[0].conform_build_side()
            rparts = left._executor.exchange(
                _coerce_parts(right, left._executor),
                _bucket_splitter(keys, n_out, cast_to=left_schema),
                n_out,
                replan=rreplan,
            )
        replanned = bool(plans)
        salted = replanned and plans[0].has_splits()
        nodes.append(_node(
            f"exchange[{kstr}]",
            annotation=f"hash exchange (both sides), {n_out} buckets",
            stage_ids=sids,
        ))

    def join_pair(lt: pa.Table, rt: pa.Table) -> pa.Table:
        return _join_aligned(lt, rt, keys, join_type)

    with stage_label(f"join[{kstr}]") as jids:
        parts = left._executor.map_pairs(lparts, rparts, join_pair)
    tmp = (lparts if l_tmp else []) + (rparts if r_tmp else [])
    if tmp:
        # A replicated build bucket is the SAME object k times in
        # rparts; discard deletes by ref, so dedupe by identity or the
        # k-1 extra deletes would race/KeyError.
        tmp = list({id(p): p for p in tmp}.values())
        # Streaming join tasks fetch lparts/rparts asynchronously —
        # free the temporaries only once every output has settled.
        _when_settled(parts, lambda: left._executor.discard(tmp))
    out = DataFrame(parts, left._executor)
    # A salted (split) probe bucket spreads one key's rows across k
    # output partitions — co-location no longer holds, so downstream
    # wide ops must not elide on it.
    out._exchange_keys = None if salted else tkeys
    out._aqe_layout = replanned and not salted
    out._lineage = left._lineage + nodes + [_node(
        f"join[{kstr}]",
        annotation=f"shuffle hash join ({join_type})" + dec.suffix(),
        stage_ids=jids,
    )]
    return out


def _group_by(t: pa.Table, keys: List[str], aggs) -> "pa.TableGroupBy":
    """``t.group_by(keys)``, single-threaded where an aggregate is
    ordered: pyarrow refuses ``first``/``last`` in multithreaded
    execution (``ArrowNotImplementedError``), and an ordered aggregate
    needs rows in partition order anyway."""
    ordered = any(a[1] in ("first", "last") for a in aggs)
    return t.group_by(keys, use_threads=not ordered)


def _direct_agg_supported(specs: List[Tuple[str, str]]) -> bool:
    """Ops arrow's hash aggregation can finalize in ONE pass. collect_*
    need the flatten/re-aggregate dance (null-dropping list semantics),
    so they always take the two-phase path."""
    return all(op not in ("collect_list", "collect_set") for _, op in specs)


def _direct_agg(
    t: pa.Table, keys: List[str], specs: List[Tuple[str, str]]
) -> pa.Table:
    """Single-pass arrow aggregation producing FINAL output columns.

    Semantics match the two-phase _local_agg → combine → _finalize_agg
    pipeline (null-skipping aggregates, ddof=1 stats per Spark), minus
    its orchestration: used by the adaptive tier-1 plan on small inputs.
    """
    arrow_aggs = []
    out_names: List[str] = []
    if any(c == "*" for c, _ in specs):
        t = t.append_column(
            _ROWS_COL, pa.array(np.ones(t.num_rows, dtype=np.int64))
        )
    for col_name, op in specs:
        if col_name == "*":
            arrow_aggs.append((_ROWS_COL, "sum"))
            out_names.append("count")
        elif op in ("mean", "avg"):
            arrow_aggs.append((col_name, "mean"))
            out_names.append(f"{op}({col_name})")
        elif op in _STAT_OPS:
            kind = (
                "stddev" if op.startswith(("stddev", "std")) else "variance"
            )
            arrow_aggs.append(
                (col_name, kind, pc.VarianceOptions(ddof=1))
            )
            out_names.append(f"{op}({col_name})")
        elif op in _DISTINCT_OPS:
            arrow_aggs.append((col_name, "count_distinct"))
            out_names.append(f"{op}({col_name})")
        elif op == "count":
            arrow_aggs.append((col_name, "count"))
            out_names.append(f"count({col_name})")
        elif op in GroupedData._MERGEABLE and op != "sumsq":
            arrow_aggs.append((col_name, op))
            out_names.append(f"{op}({col_name})")
        else:
            raise ValueError(f"unsupported aggregation {op!r}")
    agged = _group_by(t, keys, arrow_aggs).aggregate(arrow_aggs)
    n_keys = len(agged.column_names) - len(arrow_aggs)
    arrays = {
        k: agged.column(i)
        for i, k in enumerate(agged.column_names[:n_keys])
    }
    for j, name in enumerate(out_names):
        col = agged.column(n_keys + j)
        if name.split("(")[0] in _DISTINCT_OPS:
            col = pc.cast(col, pa.int64())
        arrays[name] = col
    return pa.table(arrays)


def _local_agg(
    t: pa.Table, keys: List[str], specs: List[Tuple[str, str]]
) -> pa.Table:
    arrow_aggs = []
    needs_rows = any(c == "*" for c, _ in specs)
    if needs_rows:
        # count(*) counts ROWS (null keys included) — counting a key column
        # would skip nulls (Spark semantics: groupBy().count() = row count).
        t = t.append_column(
            _ROWS_COL, pa.array(np.ones(t.num_rows, dtype=np.int64))
        )
    for col_name, op in specs:
        if col_name == "*":
            arrow_aggs.append((_ROWS_COL, "sum"))
        elif op == "sumsq":
            sq_name = f"__sq_{col_name}"
            if sq_name not in t.column_names:
                x = pc.cast(t.column(col_name), pa.float64())
                t = t.append_column(sq_name, pc.multiply(x, x))
            arrow_aggs.append((sq_name, "sum"))
        else:
            arrow_op = "distinct" if op == "cdistinct" else op
            arrow_aggs.append((col_name, arrow_op))
    out = _group_by(t, keys, arrow_aggs).aggregate(arrow_aggs)
    # Positional rename: pyarrow emits key columns first, then one output
    # per aggregation IN ORDER (duplicate names possible when two partials
    # lower to the same arrow op, e.g. collect_set + count_distinct).
    n_keys = len(out.column_names) - len(arrow_aggs)
    new_names = list(out.column_names[:n_keys]) + [
        _partial_name(c, op) for c, op in specs
    ]
    return out.rename_columns(new_names)


def _finalize_agg(
    merged: pa.Table, keys: List[str], specs: List[Tuple[str, str]]
) -> pa.Table:
    arrays = {k: merged.column(k) for k in keys}
    for col_name, op in specs:
        if op in ("mean", "avg"):
            s = merged.column(_partial_name(col_name, "sum"))
            c = merged.column(_partial_name(col_name, "count"))
            arrays[f"{op}({col_name})"] = pc.divide(
                pc.cast(s, pa.float64()), pc.cast(c, pa.float64())
            )
        elif op in _STAT_OPS:
            # Sample variance from the merged moments (Spark semantics:
            # stddev/variance are ddof=1): (Σx² − (Σx)²/n) / (n − 1).
            s = pc.cast(merged.column(_partial_name(col_name, "sum")),
                        pa.float64())
            sq = pc.cast(merged.column(_partial_name(col_name, "sumsq")),
                         pa.float64())
            n = pc.cast(merged.column(_partial_name(col_name, "count")),
                        pa.float64())
            num = pc.subtract(sq, pc.divide(pc.multiply(s, s), n))
            var = pc.divide(num, pc.subtract(n, pa.scalar(1.0)))
            # float error can drive a zero variance slightly negative
            var = pc.max_element_wise(var, pa.scalar(0.0))
            if op.startswith(("stddev", "std")):
                arrays[f"{op}({col_name})"] = pc.sqrt(var)
            else:
                arrays[f"{op}({col_name})"] = var
        elif op in _DISTINCT_OPS:
            # merged column is already the per-group distinct count
            # (partition lists flattened + re-counted in combine).
            col = merged.column(_partial_name(col_name, "cdistinct"))
            arrays[f"{op}({col_name})"] = pc.cast(col, pa.int64())
        elif op in ("collect_list", "collect_set"):
            partial = "list" if op == "collect_list" else "distinct"
            arrays[f"{op}({col_name})"] = merged.column(
                _partial_name(col_name, partial)
            )
        elif op == "count":
            arrays["count" if col_name == "*" else f"count({col_name})"] = (
                merged.column(_partial_name(col_name, "count"))
            )
        else:
            arrays[f"{op}({col_name})"] = merged.column(
                _partial_name(col_name, op)
            )
    return pa.table(arrays)
