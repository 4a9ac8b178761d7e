"""Partitioned Arrow DataFrame engine (the framework's Spark replacement).

The port's copy of ``raydp_tpu.dataframe``: stages run on the session's
ETL worker processes while a session from ``raydp_tpu_torch.init()`` is
live (partitions in its shared-memory object store), else on a thread
pool in this process. Public surface mirrors the PySpark idioms the
reference's pipelines use:

    from raydp_tpu_torch import dataframe as rdf
    from raydp_tpu_torch.dataframe import col, lit, udf, hour, dayofweek

    df = rdf.read_csv("taxi.csv")
    df = df.filter(col("fare_amount") > 0).withColumn("h", hour(col("ts")))
    train, test = df.random_split([0.9, 0.1], seed=42)
"""
from raydp_tpu_torch.dataframe.dataframe import DataFrame, GroupedData
from raydp_tpu_torch.dataframe.expr import (
    CaseWhen,
    Col,
    Expr,
    Lit,
    ceil,
    col,
    dayofmonth,
    dayofweek,
    exp,
    floor,
    hour,
    length,
    lit,
    log,
    lower,
    minute,
    monotonically_increasing_id,
    month,
    quarter,
    second,
    sqrt,
    udf,
    upper,
    weekofyear,
    when,
    year,
)
from raydp_tpu_torch.dataframe.io import (
    from_arrow,
    from_items,
    from_pandas,
    from_refs,
    range,
    read_csv,
    read_parquet,
)
from raydp_tpu_torch.dataframe.window import (
    Window,
    WindowSpec,
    asc,
    dense_rank,
    desc,
    lag,
    lead,
    rank,
    row_number,
    window_count,
    window_max,
    window_mean,
    window_min,
    window_sum,
)

__all__ = [
    "DataFrame", "GroupedData", "Expr", "Col", "Lit", "CaseWhen",
    "col", "lit", "udf", "when",
    "year", "month", "dayofmonth", "hour", "minute", "second",
    "quarter", "weekofyear", "dayofweek",
    "sqrt", "exp", "log", "floor", "ceil", "lower", "upper", "length",
    "monotonically_increasing_id",
    "from_arrow", "from_items", "from_pandas", "from_refs", "range",
    "read_csv", "read_parquet",
    "Window", "WindowSpec", "asc", "desc",
    "row_number", "rank", "dense_rank", "lag", "lead",
    "window_sum", "window_min", "window_max", "window_mean", "window_count",
]
