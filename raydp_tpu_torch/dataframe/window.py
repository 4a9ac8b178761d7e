"""Window functions (the port's copy of ``raydp_tpu/dataframe/window.py``):
``Window.partitionBy(...).orderBy(...)`` +
``row_number()/rank()/lag()/...`` — the Spark window surface the
reference's DLRM preprocessing depends on (reference:
examples/pytorch_dlrm.ipynb ``assign_id_with_window``:
``Window.partitionBy('column_id').orderBy(desc('count'))`` with
``row_number().over(w) - 1``).

Execution model: a window expression is a *wide* op — the DataFrame
hash-exchanges rows by the partition keys first so each physical
partition holds whole window groups, then every group computes locally
(pandas kernels) with results aligned back to input row order.
"""
from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Union

import numpy as np
import pyarrow as pa

from raydp_tpu_torch.dataframe.expr import Expr

__all__ = [
    "Window",
    "WindowSpec",
    "WindowExpr",
    "desc",
    "asc",
    "row_number",
    "rank",
    "dense_rank",
    "lag",
    "lead",
    "cume_count",
    "window_sum",
    "window_min",
    "window_max",
    "window_mean",
    "window_count",
    "find_window_exprs",
]


class _SortKey:
    def __init__(self, column: str, ascending: bool):
        self.column = column
        self.ascending = ascending


def desc(column: str) -> _SortKey:
    return _SortKey(column, False)


def asc(column: str) -> _SortKey:
    return _SortKey(column, True)


class WindowSpec:
    def __init__(
        self,
        partition_keys: Sequence[str],
        order_keys: Sequence[_SortKey] = (),
    ):
        if not partition_keys:
            raise ValueError("window needs at least one partition key")
        self.partition_keys = list(partition_keys)
        self.order_keys = list(order_keys)

    def orderBy(self, *cols: Union[str, _SortKey]) -> "WindowSpec":
        keys = [
            c if isinstance(c, _SortKey) else _SortKey(c, True) for c in cols
        ]
        return WindowSpec(self.partition_keys, keys)

    order_by = orderBy


class Window:
    """Entry point matching pyspark.sql.Window."""

    @staticmethod
    def partitionBy(*keys: str) -> WindowSpec:
        return WindowSpec(list(keys))

    partition_by = partitionBy


def keys_cover(existing, needed) -> bool:
    """Whether a frame hash-partitioned on ``existing`` is already
    co-located for a grouping op on ``needed`` (window partitions,
    groupBy keys, distinct subset).

    A hash exchange on K puts every row with equal K-values in one
    partition, so any grouping whose key set is a SUPERSET of K is
    automatically co-located too (each finer group lies wholly inside
    one coarse group). The co-partitioning planner uses this to elide
    shuffles; zipped joins do NOT go through here — they additionally
    need identical bucket functions (exact key order, dtypes, fanout)
    on both sides."""
    return bool(existing) and set(existing) <= set(needed)


class WindowFunction:
    """A window function awaiting ``.over(window_spec)``."""

    def __init__(self, kind: str, column: Optional[str] = None, offset: int = 1,
                 default=None):
        self.kind = kind
        self.column = column
        self.offset = offset
        self.default = default

    def over(self, spec: WindowSpec) -> "WindowExpr":
        return WindowExpr(self, spec)


def row_number() -> WindowFunction:
    return WindowFunction("row_number")


def rank() -> WindowFunction:
    return WindowFunction("rank")


def dense_rank() -> WindowFunction:
    return WindowFunction("dense_rank")


def lag(column: str, offset: int = 1, default=None) -> WindowFunction:
    return WindowFunction("lag", column, offset, default)


def lead(column: str, offset: int = 1, default=None) -> WindowFunction:
    return WindowFunction("lead", column, -offset, default)


def cume_count() -> WindowFunction:
    """Running count within the window frame (1-based, like row_number
    but named for the count-over-window idiom)."""
    return WindowFunction("row_number")


def window_sum(column: str) -> WindowFunction:
    """Sum of ``column`` over the window frame."""
    return WindowFunction("sum", column)


def window_min(column: str) -> WindowFunction:
    return WindowFunction("min", column)


def window_max(column: str) -> WindowFunction:
    return WindowFunction("max", column)


def window_mean(column: str) -> WindowFunction:
    return WindowFunction("mean", column)


def window_count(column: str) -> WindowFunction:
    """Non-null count of ``column`` over the window frame."""
    return WindowFunction("count", column)


def _np_valid(col: pa.Array) -> np.ndarray:
    import pyarrow.compute as pc

    return pc.is_valid(col).to_numpy(zero_copy_only=False)


def _adjacent_change(col: pa.Array) -> np.ndarray:
    """Boolean mask of length n: row i starts a new run of values
    (row 0 always True). Null-safe: two adjacent nulls are EQUAL."""
    import pyarrow.compute as pc

    n = len(col)
    out = np.empty(n, dtype=bool)
    if n == 0:
        return out
    out[0] = True
    if n == 1:
        return out
    a, b = col.slice(0, n - 1), col.slice(1)
    neq = pc.fill_null(pc.not_equal(b, a), True).to_numpy(
        zero_copy_only=False
    ).astype(bool)
    both_null = ~_np_valid(a) & ~_np_valid(b)
    out[1:] = np.where(both_null, False, neq)
    return out


def _int_fast_order(table: pa.Table, keys, order):
    """Fused-integer-key sort fast path.

    When every partition + order key is a null-free integer column whose
    value ranges pack into one int64 (the common case: id/bucket/count
    columns — the reference's DLRM preprocessing windows sort exactly
    such columns), ONE ``np.argsort`` over a fused key replaces arrow's
    multi-key ``sort_indices`` (~30% faster measured at 1.5M rows) and
    the group/peer boundaries fall out of the sorted fused key as plain
    integer compares — no per-key arrow adjacency passes.

    Returns ``(idx, gchange, pchange)`` or None (caller falls back to
    the general arrow sort).
    """
    pieces = []
    prod = 1
    order_prod = 1
    for i, (name, ascending) in enumerate(
        [(k, True) for k in keys]
        + [(sk.column, sk.ascending) for sk in order]
    ):
        col = table.column(name)
        if not pa.types.is_integer(col.type) or col.null_count:
            return None
        x = col.combine_chunks().to_numpy(zero_copy_only=False)
        # min/max in the column's own dtype (a premature int64 cast
        # would wrap large uint64 values), range math in Python ints.
        mn, mx = int(x.min()), int(x.max())
        rng = mx - mn + 1
        prod *= rng
        if prod > (1 << 62):
            return None  # fused key would overflow int64
        if i >= len(keys):
            order_prod *= rng
        # Normalized piece is in [0, rng) which fits int64 (rng bounded
        # by the prod check above), whatever the source dtype was.
        # Subtract in a width that cannot wrap: uint64 stays unsigned
        # (operands non-negative), everything else widens to int64 first
        # (an int32 intermediate could overflow on full-range columns).
        if x.dtype == np.uint64:
            norm = ((x - np.uint64(mn)) if ascending
                    else (np.uint64(mx) - x)).astype(np.int64)
        else:
            x64 = x.astype(np.int64, copy=False)
            norm = (x64 - mn) if ascending else (mx - x64)
        pieces.append((norm, rng))
    key = np.zeros(table.num_rows, dtype=np.int64)
    for norm, rng in pieces:
        key *= rng
        key += norm
    idx = np.argsort(key, kind="stable")
    skey = key[idx]
    pkey = skey // order_prod  # the partition-keys part of the fused key
    n = len(skey)
    gchange = np.empty(n, dtype=bool)
    pchange = np.empty(n, dtype=bool)
    if n:
        gchange[0] = pchange[0] = True
        gchange[1:] = pkey[1:] != pkey[:-1]
        pchange[1:] = skey[1:] != skey[:-1]
    return idx, gchange, pchange


class _WindowFrame:
    """Shared sorted view of one partition for one window spec.

    One sort — a fused-integer-key ``np.argsort`` when every key is a
    null-free integer (``_int_fast_order``), else one arrow multi-key
    ``sort_indices`` (multithreaded, any dtype) — serves EVERY window
    expression over the same spec within a stage: ``row_number`` +
    ``lag`` + a running sum sort once. All kernels then run as numpy /
    arrow vector ops on the sorted order and scatter back through the
    inverse permutation; no per-group python loops anywhere
    (the pandas sort-per-expression this replaces was the r2 perf gap).
    """

    def __init__(self, table: pa.Table, spec: WindowSpec):
        import pyarrow.compute as pc

        keys, order = spec.partition_keys, spec.order_keys
        n = table.num_rows
        self.n = n
        self._table = table
        self._sorted_cols = {}
        self._order = order
        self._peer_change = None
        self._peer_last_of_row = None

        fast = _int_fast_order(table, keys, order) if n else None
        if fast is not None:
            idx_np, gchange, pchange = fast
            self._idx = pa.array(idx_np)
            self.order_np = idx_np
            self._peer_change = pchange  # free by-product of the fused key
        else:
            sort_keys = [(k, "ascending") for k in keys]
            tmp = table
            for j, sk in enumerate(order):
                direction = "ascending" if sk.ascending else "descending"
                if tmp.column(sk.column).null_count == 0:
                    # Null-free key: plain sort, no indicator column.
                    sort_keys.append((sk.column, direction))
                    continue
                # Spark null ordering: nulls FIRST on ascending keys,
                # LAST on descending — PER KEY, which arrow's single
                # global null_placement can't express (sort_keys entries
                # are strictly (name, order) pairs). Encode as a
                # null-free is-null indicator column sorted ahead of the
                # key (1 first when nulls lead); the key's own nulls are
                # then already segregated by the indicator, so the
                # global placement below never reorders visible rows.
                nullcol = f"__raydp_w_null_{j}"
                tmp = tmp.append_column(
                    nullcol,
                    pc.cast(pc.is_null(tmp.column(sk.column)), pa.int8()),
                )
                sort_keys.append(
                    (nullcol, "descending" if sk.ascending else "ascending")
                )
                sort_keys.append((sk.column, direction))
            idx = pc.sort_indices(
                tmp, sort_keys=sort_keys, null_placement="at_start"
            )
            self._idx = idx
            self.order_np = idx.to_numpy()
            # Group boundaries on the sorted order.
            gchange = np.zeros(n, dtype=bool)
            if n:
                gchange[0] = True
            for k in keys:
                gchange |= _adjacent_change(self.sorted_col(k))
        self.gid = np.cumsum(gchange) - 1
        self.group_start = np.flatnonzero(gchange)
        self.start_of_row = (
            self.group_start[self.gid] if n else np.empty(0, np.int64)
        )
        counts = np.diff(np.append(self.group_start, n))
        self.size_of_row = counts[self.gid] if n else np.empty(0, np.int64)
        self.pos = np.arange(n) - self.start_of_row
        self._gchange = gchange
        inv = np.empty(n, dtype=np.int64)
        inv[self.order_np] = np.arange(n)
        self.inv = inv

    def _finish_peers(self, pchange: np.ndarray) -> None:
        self._peer_change = pchange
        pid = np.cumsum(pchange) - 1
        peer_starts = np.flatnonzero(pchange)
        peer_last = np.append(peer_starts[1:], self.n) - 1
        self._peer_last_of_row = peer_last[pid]

    def _compute_peers(self) -> None:
        """Peer runs (order-key ties) within groups — computed on first
        use: row_number/lag never need them."""
        if self._peer_change is not None:  # fast path precomputed it
            self._finish_peers(self._peer_change)
            return
        pchange = self._gchange.copy()
        for sk in self._order:
            pchange |= _adjacent_change(self.sorted_col(sk.column))
        self._finish_peers(pchange)

    @property
    def peer_change(self) -> np.ndarray:
        if self._peer_change is None:
            self._compute_peers()
        return self._peer_change

    @property
    def peer_last_of_row(self) -> np.ndarray:
        if self._peer_last_of_row is None:
            self._compute_peers()
        return self._peer_last_of_row

    def sorted_col(
        self, name: str, table: Optional[pa.Table] = None
    ) -> pa.Array:
        """Column ``name`` in frame order. ``table`` supplies columns the
        frame's source table lacks (a chained window reading a column the
        previous stage created — same rows, so the one sort still
        applies). Cached per column DATA (buffer identity), not name: the
        evolving stage tables share buffers for untouched columns."""
        src = None
        if name in self._table.column_names:
            src = self._table.column(name)
        elif table is not None and name in table.column_names:
            src = table.column(name)
        else:
            raise KeyError(f"window column {name!r} not in table")
        ckey = (name,) + tuple(
            (b.address, b.size) if b is not None else None
            for chunk in src.chunks
            for b in chunk.buffers()
        )
        ent = self._sorted_cols.get(ckey)
        if ent is None:
            # The entry retains ``src`` so the buffer addresses in the
            # key cannot be recycled by the allocator while cached (a
            # stale same-address hit would serve wrong data).
            ent = (src, src.take(self._idx).combine_chunks())
            self._sorted_cols[ckey] = ent
        return ent[1]

    def scatter(self, sorted_values) -> pa.Array:
        """Sorted-order values → original row order."""
        if not isinstance(sorted_values, (pa.Array, pa.ChunkedArray)):
            sorted_values = pa.array(sorted_values)
        return sorted_values.take(pa.array(self.inv))


# Frame cache: one sort serves every chained window on the same spec —
# including across withColumn stages, whose append_column copies share
# the key columns' immutable buffers (the cache key below). THREAD-LOCAL
# (LocalExecutor evaluates partitions on a thread pool; a global slot
# would let concurrent partitions evict each other between two chained
# exprs) and bounded FIFO so finished queries don't pin big partition
# tables for the life of the worker.
_FRAME_TLS = threading.local()
_FRAME_CACHE_MAX = 4


def _frame_cache() -> dict:
    cache = getattr(_FRAME_TLS, "cache", None)
    if cache is None:
        cache = _FRAME_TLS.cache = {}
    return cache


def _frame_data_key(table: pa.Table, cols) -> tuple:
    """Identity of the relevant column DATA: buffer addresses + lengths.
    Arrow buffers are immutable, so equal addresses (while the source
    columns are kept alive by the cache entry) mean equal data."""
    parts = [table.num_rows]
    for name in cols:
        for chunk in table.column(name).chunks:
            for buf in chunk.buffers():
                parts.append(
                    (buf.address, buf.size) if buf is not None else None
                )
    return tuple(parts)


def _get_frame(table: pa.Table, spec: WindowSpec) -> _WindowFrame:
    sig = (
        tuple(spec.partition_keys),
        tuple((k.column, k.ascending) for k in spec.order_keys),
    )
    cols = list(spec.partition_keys) + [
        k.column for k in spec.order_keys
    ]
    data_key = _frame_data_key(table, cols)
    cache = _frame_cache()
    ent = cache.get(sig)
    if ent is not None and ent[0] == data_key:
        return ent[1]
    frame = _WindowFrame(table, spec)
    # The entry holds the key columns (via frame._table) alive, so the
    # buffer addresses in data_key cannot be recycled while cached.
    cache[sig] = (data_key, frame)
    while len(cache) > _FRAME_CACHE_MAX:
        cache.pop(next(iter(cache)))
    return frame


class WindowExpr(Expr):
    """Expr node evaluated on a table that holds whole window groups.

    ``DataFrame.withColumn`` detects these (``find_window_exprs``) and
    hash-exchanges on the partition keys before evaluation.
    """

    def __init__(self, fn: WindowFunction, spec: WindowSpec):
        self.fn = fn
        self.spec = spec
        self.name = fn.kind

    def evaluate(self, table: pa.Table):
        import pyarrow.compute as pc

        keys = self.spec.partition_keys
        order = self.spec.order_keys
        needed = set(keys) | {k.column for k in order}
        if self.fn.column:
            needed.add(self.fn.column)
        missing = needed - set(table.column_names)
        if missing:
            raise KeyError(f"window columns {sorted(missing)} not in table")
        if table.num_rows == 0:
            return pa.array([], type=pa.int64())

        frame = _get_frame(table, self.spec)
        n = frame.n
        kind = self.fn.kind

        if kind == "row_number":
            return frame.scatter(pa.array(frame.pos + 1, type=pa.int64()))

        if kind in ("rank", "dense_rank"):
            if len(order) != 1:
                raise ValueError(f"{kind} needs exactly one orderBy column")
            change = frame.peer_change
            if kind == "rank":
                # Row index of the most recent peer boundary: indexes are
                # monotone, so a global running max resets at each group
                # start (always a boundary).
                last_change = np.maximum.accumulate(
                    np.where(change, np.arange(n), -1)
                )
                r = last_change - frame.start_of_row + 1
            else:
                c = np.cumsum(change)
                r = c - c[frame.start_of_row] + 1
            return frame.scatter(pa.array(r.astype(np.int64)))

        col = frame.sorted_col(self.fn.column, table)

        if kind in ("lag", "lead"):
            k = self.fn.offset  # lead stores a negative offset
            src = np.arange(n) - k
            if k >= 0:
                hole = frame.pos < k
            else:
                hole = frame.pos >= frame.size_of_row + k
            indices = pa.array(
                np.clip(src, 0, max(n - 1, 0)), type=pa.int64(), mask=hole
            )
            taken = col.take(indices)
            if self.fn.default is not None:
                # Spark's default fills only out-of-window positions,
                # never genuine nulls shifted in from real rows.
                taken = pc.if_else(
                    pa.array(hole),
                    pa.scalar(self.fn.default, type=col.type),
                    taken,
                )
            return frame.scatter(taken)

        if kind not in ("sum", "min", "max", "mean", "count"):
            raise ValueError(f"unknown window function {kind!r}")

        valid = _np_valid(col)
        # Exact integer path: a null-free integer column aggregates in
        # int64 (no 2^53 precision cliff, and sum/min/max keep their
        # integer dtype — pandas-parity). Nulls or floats take float64,
        # with valid NaN values treated as nulls exactly like pandas'
        # skipna cumulatives (a NaN must not poison the running sum).
        int_exact = (
            kind in ("sum", "min", "max")
            and pa.types.is_integer(col.type)
            and col.null_count == 0
        )
        if kind == "count":
            x = None
        elif int_exact:
            x = col.to_numpy(zero_copy_only=False).astype(np.int64)
        else:
            x = pc.fill_null(pc.cast(col, pa.float64()), 0.0).to_numpy(
                zero_copy_only=False
            )
            valid = valid & ~np.isnan(x)
        base = frame.start_of_row
        nn_cs = np.cumsum(valid.astype(np.int64))
        nn_run = nn_cs - (nn_cs[base] - valid[base])
        if order:
            # Spark frame semantics: RANGE unboundedPreceding..currentRow
            # — a running aggregate where order-key ties (peer rows) all
            # get the full peer-frame total (value at peer's LAST row).
            if kind == "sum" and int_exact:
                cs = np.cumsum(x)
                run = cs - (cs[base] - x[base])
            elif kind in ("sum", "mean"):
                xz = np.where(valid, x, 0.0)
                cs = np.cumsum(xz)
                sum_run = cs - (cs[base] - xz[base])
                run = sum_run if kind == "sum" else sum_run / np.maximum(
                    nn_run, 1
                )
                run = np.where(nn_run > 0, run, np.nan)
            elif kind == "count":
                run = nn_run
            else:  # min/max: per-group running extrema via pandas C op
                import pandas as pd

                s = pd.Series(x if int_exact else np.where(valid, x, np.nan))
                run = getattr(s.groupby(frame.gid), f"cum{kind}")().to_numpy()
            out = run[frame.peer_last_of_row]
            if kind != "count" and out.dtype.kind == "f":
                # An all-null peer group has no running value of its own;
                # carry the prior frame value forward within the group
                # (leading nulls stay null: empty frame). Integer-exact
                # runs have no NaN to fill.
                invalid = np.isnan(out)
                if invalid.any():
                    last_ok = np.maximum.accumulate(
                        np.where(~invalid, np.arange(n), -1)
                    )
                    reachable = last_ok >= frame.start_of_row
                    out = np.where(
                        reachable, out[np.maximum(last_ok, 0)], np.nan
                    )
        else:
            # Whole-partition frame: one segmented reduction, broadcast.
            st = frame.group_start
            if int_exact:
                if kind == "sum":
                    tot = np.add.reduceat(x, st)
                elif kind == "min":
                    tot = np.minimum.reduceat(x, st)
                else:
                    tot = np.maximum.reduceat(x, st)
                out = tot[frame.gid]
            else:
                if kind == "sum":
                    tot = np.add.reduceat(np.where(valid, x, 0.0), st)
                elif kind == "min":
                    tot = np.minimum.reduceat(np.where(valid, x, np.inf), st)
                elif kind == "max":
                    tot = np.maximum.reduceat(
                        np.where(valid, x, -np.inf), st
                    )
                elif kind == "mean":
                    tot = np.add.reduceat(np.where(valid, x, 0.0), st)
                else:  # count
                    tot = np.add.reduceat(valid.astype(np.float64), st)
                cnt = np.add.reduceat(valid.astype(np.float64), st)
                if kind == "mean":
                    tot = np.where(cnt > 0, tot / np.maximum(cnt, 1), np.nan)
                elif kind in ("sum", "min", "max"):
                    tot = np.where(cnt > 0, tot, np.nan)
                out = tot[frame.gid]
        if kind == "count":
            return frame.scatter(
                pa.array(out.astype(np.int64), type=pa.int64())
            )
        if out.dtype.kind == "f":
            return frame.scatter(pa.array(out, mask=np.isnan(out)))
        return frame.scatter(pa.array(out))


def find_window_exprs(expr: Expr) -> List[WindowExpr]:
    """All WindowExpr nodes in an expression tree."""
    from raydp_tpu_torch.dataframe.expr import find_nodes

    return find_nodes(expr, WindowExpr)
