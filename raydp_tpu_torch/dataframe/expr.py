"""Column-expression tree compiled to pyarrow.compute kernels.

The engine's answer to Spark SQL's ``Column``/``functions`` surface as used
by the reference's ETL examples (reference: examples/data_process.py:9-94 —
filter chains, withColumn arithmetic, abs, datetime parts, scalar UDFs,
lit). Expressions evaluate vectorized against a ``pa.Table``; scalar UDFs
fall back to numpy object loops (same semantics as Spark's Python UDFs,
which are also out-of-engine).
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


class Expr:
    """Base: evaluate(table) -> pa.ChunkedArray | pa.Array | pa.Scalar."""

    name: str = "expr"

    def evaluate(self, table: pa.Table):
        raise NotImplementedError

    def alias(self, name: str) -> "Expr":
        return Alias(self, name)

    def cast(self, dtype) -> "Expr":
        return Cast(self, dtype)

    # -- operators ------------------------------------------------------
    def _bin(self, other, op):
        return BinaryOp(op, self, _wrap(other))

    def _rbin(self, other, op):
        return BinaryOp(op, _wrap(other), self)

    def __add__(self, o):
        return self._bin(o, "add")

    def __radd__(self, o):
        return self._rbin(o, "add")

    def __sub__(self, o):
        return self._bin(o, "subtract")

    def __rsub__(self, o):
        return self._rbin(o, "subtract")

    def __mul__(self, o):
        return self._bin(o, "multiply")

    def __rmul__(self, o):
        return self._rbin(o, "multiply")

    def __truediv__(self, o):
        return self._bin(o, "divide")

    def __rtruediv__(self, o):
        return self._rbin(o, "divide")

    def __mod__(self, o):
        return self._bin(o, "mod")

    def __eq__(self, o):  # noqa: E721  (Expr equality builds an expression)
        return self._bin(o, "equal")

    def __ne__(self, o):
        return self._bin(o, "not_equal")

    def __lt__(self, o):
        return self._bin(o, "less")

    def __le__(self, o):
        return self._bin(o, "less_equal")

    def __gt__(self, o):
        return self._bin(o, "greater")

    def __ge__(self, o):
        return self._bin(o, "greater_equal")

    def __and__(self, o):
        return self._bin(o, "and_kleene")

    def __or__(self, o):
        return self._bin(o, "or_kleene")

    def __invert__(self):
        return UnaryOp("invert", self)

    def __neg__(self):
        return UnaryOp("negate", self)

    def __abs__(self):
        return UnaryOp("abs", self)

    def is_null(self) -> "Expr":
        return UnaryOp("is_null", self)

    def is_not_null(self) -> "Expr":
        return UnaryOp("is_valid", self)

    def isin(self, values: Sequence) -> "Expr":
        return IsIn(self, list(values))

    def __hash__(self):  # __eq__ is overloaded; keep Expr hashable
        return id(self)


def _wrap(value) -> Expr:
    return value if isinstance(value, Expr) else Lit(value)


class Col(Expr):
    def __init__(self, name: str):
        self.name = name

    def evaluate(self, table: pa.Table):
        if self.name not in table.column_names:
            raise KeyError(
                f"column {self.name!r} not in {table.column_names}"
            )
        return table.column(self.name)

    def __repr__(self):
        return f"col({self.name!r})"


class Lit(Expr):
    def __init__(self, value: Any):
        self.value = value
        self.name = "lit"

    def evaluate(self, table: pa.Table):
        return pa.scalar(self.value)

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expr):
    def __init__(self, child: Expr, name: str):
        self.child = child
        self.name = name

    def evaluate(self, table: pa.Table):
        return self.child.evaluate(table)


class Cast(Expr):
    def __init__(self, child: Expr, dtype):
        self.child = child
        self.dtype = _to_arrow_type(dtype)
        self.name = child.name

    def evaluate(self, table: pa.Table):
        return pc.cast(self.child.evaluate(table), self.dtype)


def _pc_mod(a, b):
    # pyarrow.compute has no modulo kernel; a - floor(a/b)*b (floored mod,
    # matches Python % for positive divisors).
    quotient = pc.floor(pc.divide(pc.cast(a, pa.float64()), pc.cast(b, pa.float64())))
    result = pc.subtract(
        pc.cast(a, pa.float64()), pc.multiply(quotient, pc.cast(b, pa.float64()))
    )
    # Keep integer type when both inputs are integers.
    a_type = a.type if hasattr(a, "type") else None
    if a_type is not None and pa.types.is_integer(a_type):
        return pc.cast(result, a_type)
    return result


_BINARY = {
    "add": pc.add,
    "subtract": pc.subtract,
    "multiply": pc.multiply,
    "divide": pc.divide,
    "mod": _pc_mod,
    "equal": pc.equal,
    "not_equal": pc.not_equal,
    "less": pc.less,
    "less_equal": pc.less_equal,
    "greater": pc.greater,
    "greater_equal": pc.greater_equal,
    "and_kleene": pc.and_kleene,
    "or_kleene": pc.or_kleene,
}


class BinaryOp(Expr):
    def __init__(self, op: str, left: Expr, right: Expr):
        self.op = op
        self.left = left
        self.right = right
        self.name = f"({left.name} {op} {right.name})"

    def evaluate(self, table: pa.Table):
        return _BINARY[self.op](
            self.left.evaluate(table), self.right.evaluate(table)
        )


_UNARY = {
    "abs": pc.abs,
    "negate": pc.negate,
    "invert": pc.invert,
    "is_null": pc.is_null,
    "is_valid": pc.is_valid,
    "sqrt": pc.sqrt,
    "exp": pc.exp,
    "ln": pc.ln,
    "floor": pc.floor,
    "ceil": pc.ceil,
    "round": pc.round,
    "lower": pc.utf8_lower,
    "upper": pc.utf8_upper,
    "length": pc.utf8_length,
}


class UnaryOp(Expr):
    def __init__(self, op: str, child: Expr):
        self.op = op
        self.child = child
        self.name = f"{op}({child.name})"

    def evaluate(self, table: pa.Table):
        return _UNARY[self.op](self.child.evaluate(table))


class IsIn(Expr):
    def __init__(self, child: Expr, values: List):
        self.child = child
        self.values = values
        self.name = f"isin({child.name})"

    def evaluate(self, table: pa.Table):
        return pc.is_in(self.child.evaluate(table), value_set=pa.array(self.values))


# -- datetime parts (Spark functions parity: dayofmonth/hour/... ----------
_DT_FUNCS = {
    "year": pc.year,
    "month": pc.month,
    "dayofmonth": pc.day,
    "hour": pc.hour,
    "minute": pc.minute,
    "second": pc.second,
    "quarter": pc.quarter,
    "weekofyear": lambda a: pc.iso_week(a),
    # Spark dayofweek: Sunday=1..Saturday=7; arrow day_of_week: Mon=0..Sun=6.
    "dayofweek": lambda a: pc.add(_pc_mod(pc.add(pc.day_of_week(a), 1), 7), 1),
}


class DtPart(Expr):
    def __init__(self, func: str, child: Expr):
        self.func = func
        self.child = child
        self.name = func

    def evaluate(self, table: pa.Table):
        arr = self.child.evaluate(table)
        if pa.types.is_string(arr.type) or pa.types.is_large_string(arr.type):
            arr = pc.strptime(arr, format="%Y-%m-%d %H:%M:%S", unit="us",
                              error_is_null=True)
        return _DT_FUNCS[self.func](arr)


class ScalarUdf(Expr):
    """Row-at-a-time Python UDF (reference: @udf("int") in
    examples/data_process.py:37-50)."""

    def __init__(self, fn: Callable, return_type, args: Sequence[Expr]):
        self.fn = fn
        self.return_type = _to_arrow_type(return_type)
        self.args = [_wrap(a) for a in args]
        self.name = getattr(fn, "__name__", "udf")

    def evaluate(self, table: pa.Table):
        cols = []
        n = table.num_rows
        for a in self.args:
            v = a.evaluate(table)
            if isinstance(v, pa.Scalar):
                cols.append(np.full(n, v.as_py(), dtype=object))
            else:
                if isinstance(v, pa.ChunkedArray):
                    v = v.combine_chunks()
                cols.append(np.asarray(v.to_pandas(), dtype=object))
        out = [self.fn(*row) for row in zip(*cols)] if cols else [
            self.fn() for _ in range(n)
        ]
        return pa.array(out, type=self.return_type)


def _to_arrow_type(dtype) -> pa.DataType:
    if isinstance(dtype, pa.DataType):
        return dtype
    mapping = {
        "int": pa.int32(),
        "int32": pa.int32(),
        "long": pa.int64(),
        "int64": pa.int64(),
        "float": pa.float32(),
        "float32": pa.float32(),
        "double": pa.float64(),
        "float64": pa.float64(),
        "string": pa.string(),
        "str": pa.string(),
        "bool": pa.bool_(),
        "boolean": pa.bool_(),
        "date": pa.date32(),
        "timestamp": pa.timestamp("us"),
    }
    if isinstance(dtype, str) and dtype in mapping:
        return mapping[dtype]
    if dtype in (int,):
        return pa.int64()
    if dtype in (float,):
        return pa.float64()
    if dtype in (str,):
        return pa.string()
    if dtype in (bool,):
        return pa.bool_()
    raise ValueError(f"unsupported type spec {dtype!r}")


# -- public helpers (Spark functions-style API) ---------------------------
def col(name: str) -> Col:
    return Col(name)


def lit(value: Any) -> Lit:
    return Lit(value)


def udf(return_type):
    """Decorator: ``@udf("int")`` then call with column names/exprs."""

    def decorate(fn: Callable):
        def call(*args):
            exprs = [Col(a) if isinstance(a, str) else _wrap(a) for a in args]
            return ScalarUdf(fn, return_type, exprs)

        call.__name__ = getattr(fn, "__name__", "udf")
        return call

    return decorate


def _dt_factory(func_name: str):
    def f(column) -> DtPart:
        e = Col(column) if isinstance(column, str) else column
        return DtPart(func_name, e)

    f.__name__ = func_name
    return f


year = _dt_factory("year")
month = _dt_factory("month")
dayofmonth = _dt_factory("dayofmonth")
hour = _dt_factory("hour")
minute = _dt_factory("minute")
second = _dt_factory("second")
quarter = _dt_factory("quarter")
weekofyear = _dt_factory("weekofyear")
dayofweek = _dt_factory("dayofweek")


def sqrt(e) -> Expr:
    return UnaryOp("sqrt", _colify(e))


def exp(e) -> Expr:
    return UnaryOp("exp", _colify(e))


def log(e) -> Expr:
    return UnaryOp("ln", _colify(e))


def floor(e) -> Expr:
    return UnaryOp("floor", _colify(e))


def ceil(e) -> Expr:
    return UnaryOp("ceil", _colify(e))


def lower(e) -> Expr:
    return UnaryOp("lower", _colify(e))


def upper(e) -> Expr:
    return UnaryOp("upper", _colify(e))


def length(e) -> Expr:
    return UnaryOp("length", _colify(e))


def when(condition: Expr, value) -> "CaseWhen":
    return CaseWhen([(condition, _wrap(value))])


class CaseWhen(Expr):
    def __init__(self, branches, otherwise_: Optional[Expr] = None):
        self.branches = branches
        self.otherwise_ = otherwise_
        self.name = "case_when"

    def when(self, condition: Expr, value) -> "CaseWhen":
        return CaseWhen(self.branches + [(condition, _wrap(value))],
                        self.otherwise_)

    def otherwise(self, value) -> "CaseWhen":
        return CaseWhen(self.branches, _wrap(value))

    def evaluate(self, table: pa.Table):
        conds = [b[0].evaluate(table) for b in self.branches]
        vals = [b[1].evaluate(table) for b in self.branches]
        cond_struct = pa.StructArray.from_arrays(
            [c.combine_chunks() if isinstance(c, pa.ChunkedArray) else c
             for c in conds],
            names=[str(i) for i in range(len(conds))],
        )
        default = (
            self.otherwise_.evaluate(table)
            if self.otherwise_ is not None
            else pa.scalar(None)
        )
        return pc.case_when(cond_struct, *vals, default)


def _colify(e) -> Expr:
    return Col(e) if isinstance(e, str) else _wrap(e)


# -- partition-indexed expressions ----------------------------------------
import threading

_EVAL_CTX = threading.local()


class MonotonicId(Expr):
    """Spark-compatible ``monotonically_increasing_id()``: unique,
    monotonically increasing within each partition —
    ``partition_index << 33 | row_position`` (no global barrier, matching
    Spark's contract of monotonic-but-not-consecutive ids; used by the
    DLRM preprocessing's ``rand_ordinal``, examples/pytorch_dlrm.ipynb).

    Needs the physical partition index, which ``DataFrame.withColumn``
    binds around evaluation (thread-local; each partition stage runs on
    one thread).
    """

    name = "monotonically_increasing_id"

    def evaluate(self, table: pa.Table):
        pidx = getattr(_EVAL_CTX, "partition_index", None)
        if pidx is None:
            raise RuntimeError(
                "monotonically_increasing_id() is only valid inside "
                "DataFrame.withColumn/select"
            )
        start = pidx << 33
        return pa.array(
            np.arange(start, start + table.num_rows, dtype=np.int64),
            type=pa.int64(),
        )


def monotonically_increasing_id() -> MonotonicId:
    return MonotonicId()


def find_nodes(expr: Expr, cls) -> List:
    """All nodes of type ``cls`` in an expression tree (walks the known
    child attributes of the Expr classes)."""
    found, seen = [], set()

    def walk(e):
        if id(e) in seen or not isinstance(e, Expr):
            return
        seen.add(id(e))
        if isinstance(e, cls):
            found.append(e)
        for attr in ("child", "left", "right", "otherwise_"):
            sub = getattr(e, attr, None)
            if isinstance(sub, Expr):
                walk(sub)
        for sub in getattr(e, "args", []) or []:
            walk(sub)
        for cond, val in getattr(e, "branches", []) or []:
            walk(cond)
            walk(val)

    walk(expr)
    return found
