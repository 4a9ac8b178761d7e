"""DataFrame construction: files, pandas, arrow, ranges.

A frame is built on the session's cluster executor while a session from
``raydp_tpu_torch.init()`` is live (partitions scattered to the workers,
files read worker-side), else on a local one.
"""
from __future__ import annotations

import glob as _glob
import os
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.csv as pa_csv
import pyarrow.parquet as pq

import builtins

from raydp_tpu_torch.dataframe import aqe as _aqe
from raydp_tpu_torch.dataframe import expr as E
from raydp_tpu_torch.dataframe.dataframe import DataFrame, _node, _split_sizes
from raydp_tpu_torch.dataframe.executor import Executor
from raydp_tpu_torch.utils.profiling import metrics


def _executor() -> "Executor":
    from raydp_tpu_torch.dataframe.dataframe import _default_executor

    return _default_executor()


def _distribute(tables: List[pa.Table], executor: Optional[Executor] = None) -> DataFrame:
    ex = executor or _executor()
    return DataFrame(ex.put_many(tables), ex)


def _scan_distributed(split_specs, reader) -> Optional[DataFrame]:
    """Executor-side file scan: under cluster execution each WORKER reads
    its own split from shared storage (GCS/NFS mount — every node sees
    the same paths, a multi-host deployment's shape) and stores the table
    node-locally; only the split spec travels in the task. The
    reference's counterpart is Spark executors reading their own input
    splits. Returns None when there is no cluster (driver reads then)."""
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor

    ex = _executor()
    if not isinstance(ex, ClusterExecutor):
        return None

    def scan_task(ctx, spec):
        return ctx.put_table(reader(spec), holder=True)

    futures = [
        ex.cluster.submit_async(scan_task, spec) for spec in split_specs
    ]
    return DataFrame([f.result() for f in futures], ex)


def _compact(t: pa.Table) -> pa.Table:
    """Rebuild ``t`` on its own buffers via an IPC round-trip.

    ``Table.slice`` is zero-copy: the slice keeps the PARENT's buffers,
    and pickle serializes those in full — so shipping N slices of one
    table to the workers moves N× the whole table over the control
    plane, not 1× (measured: a 4.5 MB slice of a 36 MB table pickles at
    36 MB; with 8 partitions that is 288 MB of ingest traffic and the
    driver-side stall that starves worker heartbeats). The IPC writer
    truncates buffers to the slice, so one memcpy-speed round-trip makes
    the partition self-contained before it is pickled into a task."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, t.schema) as w:
        w.write_table(t)
    return pa.ipc.open_stream(sink.getvalue()).read_all()


def from_arrow(table: pa.Table, num_partitions: int = 1) -> DataFrame:
    if num_partitions <= 1:
        return _distribute([table])
    sizes = _split_sizes(table.num_rows, num_partitions)
    parts, offset = [], 0
    for size in sizes:
        parts.append(_compact(table.slice(offset, size)))
        offset += size
    return _distribute(parts)


def from_pandas(df, num_partitions: int = 1) -> DataFrame:
    return from_arrow(
        pa.Table.from_pandas(df, preserve_index=False), num_partitions
    )


def from_refs(refs: Sequence[Any]) -> DataFrame:
    """Build a DataFrame from ObjectRefs already in the session store —
    the reverse data path (C8): refs/dataset → DataFrame with schema
    preserved (reference: ray_dataset_to_spark_dataframe,
    python/raydp/spark/dataset.py:506-577, ObjectStoreReader.scala:32-55).

    Partitions under cluster execution ARE ObjectRefs, so the refs become
    the frame's partitions directly — no copy; workers resolve them
    node-locally (or via a store agent) when the next stage runs.
    """
    from raydp_tpu_torch.context import current_session
    from raydp_tpu_torch.dataframe.executor import ClusterExecutor
    from raydp_tpu_torch.store.object_store import ObjectRef

    refs = list(refs)
    if not refs:
        raise ValueError("from_refs needs at least one ref")
    bad = [r for r in refs if not isinstance(r, ObjectRef)]
    if bad:
        raise TypeError(f"from_refs takes ObjectRefs; got {type(bad[0])}")
    session = current_session()
    if session is None:
        raise RuntimeError(
            "from_refs requires a live session; call raydp_tpu_torch.init() "
            "first"
        )
    return DataFrame(refs, ClusterExecutor(session.cluster))


def from_items(rows: List[Dict[str, Any]], num_partitions: int = 1) -> DataFrame:
    return from_arrow(pa.Table.from_pylist(rows), num_partitions)


def range(n: int, num_partitions: int = 1) -> DataFrame:  # noqa: A001
    return from_arrow(pa.table({"id": np.arange(n, dtype=np.int64)}),
                      num_partitions)


def read_csv(
    path: str,
    num_partitions: Optional[int] = None,
    schema: Optional[pa.Schema] = None,
    timestamp_columns: Optional[Sequence[str]] = None,
) -> DataFrame:
    """Read CSV file(s) into a partitioned DataFrame. ``path`` may be a
    file, a glob, or a directory."""
    files = _expand(path, (".csv",))
    schema_types = (
        {name: schema.field(name).type for name in schema.names}
        if schema is not None
        else None
    )
    ts_cols = list(timestamp_columns or [])

    def _read_csv_split(path_: str) -> pa.Table:
        # The ONE place CSV convert options are built — the local
        # fallback and the worker-side scan must never diverge.
        import pyarrow as _pa
        import pyarrow.csv as _pa_csv

        conv = None
        if schema_types is not None:
            conv = _pa_csv.ConvertOptions(column_types=schema_types)
        elif ts_cols:
            conv = _pa_csv.ConvertOptions(
                column_types={c: _pa.timestamp("us") for c in ts_cols}
            )
        return _pa_csv.read_csv(path_, convert_options=conv)

    df = _scan_distributed(files, _read_csv_split)
    if df is None:
        df = _distribute([_read_csv_split(f) for f in files])
    if num_partitions is not None and num_partitions != len(files):
        df = df.repartition(num_partitions)
    return df


# -- AQE rule (d): parquet scan pushdown -------------------------------

_CMP_OPS = ("equal", "less", "less_equal", "greater", "greater_equal")


def _pred_conjuncts(e: "E.Expr") -> List["E.Expr"]:
    """Split a predicate on AND (kleene) into its conjuncts."""
    if isinstance(e, E.BinaryOp) and e.op == "and_kleene":
        return _pred_conjuncts(e.left) + _pred_conjuncts(e.right)
    return [e]


def _stat_conjuncts(preds: List["E.Expr"]) -> List[tuple]:
    """``(column, op, literal)`` triples for the Col-vs-Lit comparison
    conjuncts row-group min/max statistics can decide. ``not_equal`` is
    deliberately absent: min/max cannot prove a group all-equal without
    null accounting, and the saving is marginal."""
    out = []
    for p in preds:
        for c in _pred_conjuncts(p):
            if not (isinstance(c, E.BinaryOp) and c.op in _CMP_OPS):
                continue
            left, right = c.left, c.right
            if isinstance(left, E.Col) and isinstance(right, E.Lit):
                out.append((left.name, c.op, right.value))
            elif isinstance(left, E.Lit) and isinstance(right, E.Col):
                flipped = {
                    "less": "greater", "less_equal": "greater_equal",
                    "greater": "less", "greater_equal": "less_equal",
                    "equal": "equal",
                }[c.op]
                out.append((right.name, flipped, left.value))
    return out


def _rg_can_match(rg_meta, conjuncts: List[tuple]) -> bool:
    """Whether a row group can contribute ANY row, from footer min/max.

    Conservative: missing/odd statistics keep the group. Sound under
    null semantics — comparisons against null are null and the filter
    drops null-mask rows, so non-null min/max bound every surviving
    row."""
    stats_by_col = {}
    for j in builtins.range(rg_meta.num_columns):
        col = rg_meta.column(j)
        stats_by_col[col.path_in_schema] = col.statistics
    for name, op, value in conjuncts:
        st = stats_by_col.get(name)
        if st is None or not st.has_min_max:
            continue
        try:
            if op == "less" and not (st.min < value):
                return False
            if op == "less_equal" and not (st.min <= value):
                return False
            if op == "greater" and not (st.max > value):
                return False
            if op == "greater_equal" and not (st.max >= value):
                return False
            if op == "equal" and not (st.min <= value <= st.max):
                return False
        except TypeError:
            continue  # incomparable literal type: keep the group
    return True


class ParquetScanFrame(DataFrame):
    """Lazy parquet scan with runtime pushdown (AQE rule "scan").

    :func:`read_parquet` returns this frame while the adaptive engine
    is on: the scan does not run at construction. ``select``/``drop``
    narrow the column list, ``filter`` captures pushable predicates
    (no monotonic ids), and the first partition
    access executes the rewritten scan — reading only the surviving
    columns and, where a conjunct compares a plain column against a
    literal, only the row groups whose footer min/max statistics can
    match. Bytes avoided (skipped column chunks plus pruned row
    groups, compressed sizes from the footer) feed ``aqe/bytes_saved``
    and the decision lands as one ``aqe[scan]`` marker on the scan
    node. ``RAYDP_TPU_AQE=0`` makes :func:`read_parquet` skip this
    class entirely, so the static path stays bit-for-bit."""

    def __init__(
        self,
        files: List[str],
        columns: Optional[List[str]],
        predicates: List["E.Expr"],
        split_rg: bool,
        executor: Optional[Executor] = None,
    ):
        # The base constructor assigns _parts; the setter guard below
        # keeps that pre-init assignment from marking the scan realized.
        self._scan_ready = False
        self._realized: Optional[List[Any]] = None
        super().__init__([], executor)
        self._files = list(files)
        self._scan_columns = list(columns) if columns is not None else None
        self._predicates = list(predicates)
        self._split_rg = split_rg
        self._footer_schema: Optional[pa.Schema] = None
        self._scan_ready = True
        self._lineage = [_node(
            f"scan[parquet:{len(files)} files]",
            annotation="deferred" if _aqe.aqe_enabled() else "",
        )]

    # -- lazy partitions ------------------------------------------------
    @property
    def _parts(self) -> List[Any]:
        if not self._scan_ready:
            return self._realized or []
        if self._realized is None:
            self._realized = self._run_scan()
        return self._realized

    @_parts.setter
    def _parts(self, value: List[Any]) -> None:
        if getattr(self, "_scan_ready", False):
            self._realized = list(value)
        # else: the base constructor's empty list — stay unrealized

    def _available_columns(self) -> List[str]:
        if self._scan_columns is not None:
            return list(self._scan_columns)
        if self._footer_schema is None:
            self._footer_schema = pq.ParquetFile(
                self._files[0]
            ).schema_arrow
        return list(self._footer_schema.names)

    @property
    def schema(self) -> pa.Schema:
        # Footer metadata answers schema probes without realizing the
        # scan (predicates filter rows, never fields).
        if self._schema is None and self._realized is None:
            if self._footer_schema is None:
                self._footer_schema = pq.ParquetFile(
                    self._files[0]
                ).schema_arrow
            sch = self._footer_schema
            if self._scan_columns is not None:
                sch = pa.schema([sch.field(c) for c in self._scan_columns])
            self._schema = sch
        if self._schema is None:
            self._schema = self._peek().schema
        return self._schema

    # -- pushdown rewrites ----------------------------------------------
    def _derive(
        self,
        node: Dict[str, Any],
        columns: Optional[List[str]] = None,
        predicates: Optional[List["E.Expr"]] = None,
    ) -> "ParquetScanFrame":
        out = ParquetScanFrame(
            self._files,
            self._scan_columns if columns is None else columns,
            self._predicates if predicates is None else predicates,
            self._split_rg,
            self._executor,
        )
        # Copy node dicts: realization mutates the scan node in place,
        # and sibling derivations must not see each other's markers.
        out._lineage = [dict(n) for n in self._lineage] + [node]
        out._footer_schema = self._footer_schema
        return out

    def select(self, *columns) -> DataFrame:
        if self._realized is None:
            names, plain = [], True
            for c in columns:
                if isinstance(c, str):
                    names.append(c)
                elif isinstance(c, E.Col):
                    names.append(c.name)
                else:
                    plain = False
                    break
            avail = self._available_columns()
            if (plain and len(set(names)) == len(names)
                    and set(names) <= set(avail)):
                label = ",".join(names[:4]) + (
                    ",..." if len(names) > 4 else ""
                )
                return self._derive(
                    _node(f"select[{label}]",
                          annotation="pushed into parquet scan"),
                    columns=names,
                )
        return super().select(*columns)

    def drop(self, *names: str) -> DataFrame:
        if self._realized is None:
            keep = [c for c in self._available_columns()
                    if c not in names]
            return self._derive(
                _node(f"drop[{','.join(names)}]",
                      annotation="pushed into parquet scan"),
                columns=keep,
            )
        return super().drop(*names)

    def filter(self, condition: "E.Expr") -> DataFrame:
        if self._realized is None and self._pushable(condition):
            return self._derive(
                _node("filter", annotation="pushed into parquet scan"),
                predicates=self._predicates + [condition],
            )
        return super().filter(condition)

    where = filter

    def _pushable(self, condition: "E.Expr") -> bool:
        if E.find_nodes(condition, E.MonotonicId):
            return False  # needs the executor's partition-offset ctx
        cols = {c.name for c in E.find_nodes(condition, E.Col)}
        return cols <= set(self._available_columns())

    # -- realization ----------------------------------------------------
    def _run_scan(self) -> List[Any]:
        from raydp_tpu_torch.dataframe.executor import ClusterExecutor

        cols = self._scan_columns
        preds = list(self._predicates)
        conjuncts = _stat_conjuncts(preds)
        # Predicates evaluate inside the scan, BEFORE the pushed
        # projection narrows the table — a filter pushed ahead of a
        # select may reference columns the projection drops, so the
        # read set is the projection plus every predicate column; the
        # final select below restores the projection contract.
        pred_cols = {
            c.name for p in preds for c in E.find_nodes(p, E.Col)
        }
        read_cols = cols
        if cols is not None and not pred_cols <= set(cols):
            read_cols = cols + sorted(pred_cols - set(cols))
        specs: List[tuple] = []   # (file, rg_ids | None, read_cols)
        bytes_saved = 0
        pruned_rgs = 0
        dropped_cols: set = set()
        for f in self._files:
            md = pq.ParquetFile(f).metadata
            file_cols = [md.schema.column(j).name
                         for j in builtins.range(md.num_columns)]
            drop = (
                set(file_cols) - set(read_cols)
                if read_cols is not None else set()
            )
            dropped_cols |= drop
            keep: List[int] = []
            for rg_i in builtins.range(md.num_row_groups):
                rg = md.row_group(rg_i)
                chunk_bytes = {}
                for j in builtins.range(rg.num_columns):
                    col = rg.column(j)
                    chunk_bytes[col.path_in_schema] = (
                        col.total_compressed_size
                    )
                if conjuncts and not _rg_can_match(rg, conjuncts):
                    pruned_rgs += 1
                    bytes_saved += sum(
                        b for name, b in chunk_bytes.items()
                        if name not in drop
                    )
                    continue
                bytes_saved += sum(
                    b for name, b in chunk_bytes.items() if name in drop
                )
                keep.append(rg_i)
            if self._split_rg:
                specs.extend((f, [rg_i], read_cols) for rg_i in keep)
            elif len(keep) == md.num_row_groups:
                specs.append((f, None, read_cols))  # whole-file read
            else:
                specs.append((f, keep, read_cols))
        if not specs:
            # Everything pruned: keep one empty spec so schema survives.
            specs.append((self._files[0], [], read_cols))

        def _scan(spec) -> pa.Table:
            import pyarrow as _pa
            import pyarrow.parquet as _pq

            f_, rgs_, cols_ = spec
            pf = _pq.ParquetFile(f_)
            if rgs_ is None:
                t = pf.read(columns=cols_)
            elif not rgs_:
                sch = pf.schema_arrow
                if cols_ is not None:
                    sch = _pa.schema([sch.field(c) for c in cols_])
                t = sch.empty_table()
            else:
                t = _pa.concat_tables(
                    pf.read_row_group(r, columns=cols_) for r in rgs_
                )
            for p in preds:
                mask = p.evaluate(t)
                if isinstance(mask, _pa.ChunkedArray):
                    mask = mask.combine_chunks()
                t = t.filter(mask)
            if cols is not None:
                t = t.select(cols)  # projection order is the contract
            return t

        if isinstance(self._executor, ClusterExecutor):
            def scan_task(ctx, spec):
                return ctx.put_table(_scan(spec), holder=True)

            futures = [
                self._executor.cluster.submit_async(scan_task, spec)
                for spec in specs
            ]
            parts = [f.result() for f in futures]
        else:
            parts = [_scan(spec) for spec in specs]

        if dropped_cols or preds or pruned_rgs:
            dec = _aqe.Decisions()
            bits = []
            if dropped_cols:
                bits.append(f"{len(dropped_cols)} column(s) skipped")
            if preds:
                bits.append(f"{len(preds)} predicate(s) in-scan")
            if pruned_rgs:
                bits.append(f"{pruned_rgs} row group(s) pruned")
            dec.record("scan", ", ".join(bits) + f" ({bytes_saved}B saved)")
            metrics.counter_add("aqe/bytes_saved", bytes_saved)
            node = self._lineage[0]
            node["annotation"] = f"{len(self._files)} file(s)" + dec.suffix()
        else:
            self._lineage[0]["annotation"] = f"{len(self._files)} file(s)"
        return parts


def read_parquet(
    path: str,
    num_partitions: Optional[int] = None,
    columns: Optional[List[str]] = None,
) -> DataFrame:
    """Read parquet file(s); one partition per row group when splitting."""
    files = _expand(path, (".parquet", ".pq"))
    split_rg = num_partitions is not None and len(files) < num_partitions
    if _aqe.aqe_enabled():
        n_specs = (
            sum(pq.ParquetFile(f).metadata.num_row_groups for f in files)
            if split_rg else len(files)
        )
        if num_partitions is None or num_partitions == n_specs:
            # Deferred scan: pushdown-capable frame. When a trailing
            # repartition would be needed the static eager path below
            # keeps its exact partition layout instead.
            return ParquetScanFrame(
                files, columns, [], split_rg, _executor()
            )
    # Split specs from footer METADATA only (cheap driver-side open).
    specs: List[tuple] = []
    for f in files:
        if split_rg:
            n_rg = pq.ParquetFile(f).metadata.num_row_groups
            specs.extend((f, rg, columns) for rg in builtins.range(n_rg))
        else:
            specs.append((f, None, columns))

    def _read_parquet_split(spec) -> pa.Table:
        import pyarrow.parquet as _pq

        f_, rg_, cols_ = spec
        pf = _pq.ParquetFile(f_)
        if rg_ is None:
            return pf.read(columns=cols_)
        return pf.read_row_group(rg_, columns=cols_)

    df = _scan_distributed(specs, _read_parquet_split)
    if df is None:
        # Local fallback: one ParquetFile handle per FILE (a handle per
        # row-group spec would re-parse the footer per row group).
        tables: List[pa.Table] = []
        for f in files:
            pf = pq.ParquetFile(f)
            if split_rg:
                tables.extend(
                    pf.read_row_group(rg, columns=columns)
                    for rg in builtins.range(pf.metadata.num_row_groups)
                )
            else:
                tables.append(pf.read(columns=columns))
        df = _distribute(tables)
    if num_partitions is not None and len(specs) != num_partitions:
        df = df.repartition(num_partitions)
    return df


def _expand(path: str, extensions) -> List[str]:
    if os.path.isdir(path):
        files = sorted(
            os.path.join(path, f)
            for f in os.listdir(path)
            if f.lower().endswith(extensions)
        )
    elif any(ch in path for ch in "*?["):
        files = sorted(_glob.glob(path))
    else:
        files = [path]
    if not files:
        raise FileNotFoundError(f"no files match {path!r}")
    missing = [f for f in files if not os.path.exists(f)]
    if missing:
        raise FileNotFoundError(f"missing: {missing}")
    return files
