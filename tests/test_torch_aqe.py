"""The port's adaptive planner and streaming stage scheduler
(``raydp_tpu_torch/dataframe/aqe.py``, ``scheduler.py``) against the JAX
package's.

* The cases of ``tests/test_streaming.py`` on the stage scheduler and
  ``tests/test_aqe.py``'s all-pruned scan, which need neither a session
  nor ``explain`` (query profiling waits for a later slice), run against
  the port: each module is loaded again with its engine imports pointed
  at the port.
* The AQE's replan rules on both engines over the same input (the
  skewed tables and join inputs of ``tests/test_aqe.py``): a salted
  group-by, a group-by under the exchange floor, a coalesced exchange,
  a salted join (inner and left) and the parquet scan pushdowns. Each
  holds the port's output partitions (row counts, and rows sorted by
  their keys, floats within rtol 1e-9 as ``tests/test_aqe.py``) and its
  ``aqe/*`` counter deltas, the record of every decision, equal to the
  JAX engine's; the replanned output also equals the static plan's.
"""
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu.dataframe.dataframe as jax_dfmod
import raydp_tpu.dataframe.executor as jax_exmod
import raydp_tpu_torch.dataframe as torch_rdf
import raydp_tpu_torch.dataframe.dataframe as torch_dfmod
import raydp_tpu_torch.dataframe.executor as torch_exmod
from raydp_tpu.dataframe.io import _distribute as jax_distribute
from raydp_tpu.utils.profiling import metrics as jax_metrics
from raydp_tpu_torch.dataframe.io import _distribute as torch_distribute
from raydp_tpu_torch.utils.profiling import metrics as torch_metrics
from torch_port_cases import cases, load_port_module, run_case

AQE = load_port_module("test_aqe.py")
STREAMING = load_port_module("test_streaming.py")
PORT_CASES = [(AQE, c) for c in cases(AQE, [
    "test_scan_pushdown_all_rows_pruned"])] + [
    (STREAMING, c) for c in cases(STREAMING, [
        "test_streaming_stage_out_of_order_completion",
        "test_streaming_stage_window_bounds_inflight",
        "test_streaming_stage_dep_failure_propagates",
        "test_streaming_stage_on_close_after_all_outputs",
        "test_kill_switch_restores_barriered_parts"])]


@pytest.mark.parametrize("module,name,params",
                         [(m, n, p) for m, (_, n, p) in PORT_CASES],
                         ids=[i for _, (i, _, _) in PORT_CASES])
def test_reference_case_on_port(module, name, params, request):
    run_case(module, name, params, request)


# -- replan rules on both engines -------------------------------------------

ENGINES = {
    "jax": (jax_rdf, jax_dfmod, jax_exmod, jax_distribute, jax_metrics),
    "torch": (torch_rdf, torch_dfmod, torch_exmod, torch_distribute,
              torch_metrics),
}


def _aqe_counters(metrics):
    return {k: v for k, v in metrics.snapshot().get("counters", {}).items()
            if k.startswith("aqe/")}


def _deltas(before, after):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _skewed_frame(engine):
    _, _, ex, distribute, _ = ENGINES[engine]
    return distribute(list(AQE._skewed_tables()), ex.LocalExecutor())


def _join_frame(engine, how):
    rdf = ENGINES[engine][0]
    probe, build = AQE._join_inputs()
    return rdf.from_pandas(probe, num_partitions=6).join(
        rdf.from_pandas(build, num_partitions=4), on="k", how=how)


def _parquet(tmp_path):
    t = pa.table({"id": np.arange(20_000, dtype=np.int64),
                  "v": np.random.RandomState(0).rand(20_000),
                  "w": np.random.RandomState(1).rand(20_000)})
    path = str(tmp_path / "scan.parquet")
    pq.write_table(t, path, row_group_size=2000)
    return path


RULES = {
    # name: (the frame's factory, the keys rows are compared by, env)
    "groupby_salt": (lambda e, _: _skewed_frame(e).groupBy("k").agg(
        ("i", "sum"), ("i", "count"), ("f", "sum"), ("i", "collect_list")),
        ["k"], {}),
    "groupby_below_floor": (lambda e, _: _skewed_frame(e).groupBy("k").agg(
        ("i", "sum")), ["k"], {"RAYDP_TPU_AQE_MIN_EXCHANGE_MB": None}),
    "exchange_coalesce": (lambda e, _: ENGINES[e][0].from_pandas(
        pd.DataFrame({"k": np.random.RandomState(3).randint(0, 50, 5000),
                      "v": np.random.RandomState(4).randn(5000)}),
        num_partitions=8).distinct(), ["k", "v"], {}),
    "join_salt_inner": (lambda e, _: _join_frame(e, "inner"),
                        ["k", "v", "dim"], {}),
    "join_salt_left": (lambda e, _: _join_frame(e, "left"),
                       ["k", "v", "dim"], {}),
    "scan_pushdown": (lambda e, path: ENGINES[e][0].read_parquet(path)
                      .select("id", "v").filter(
                          ENGINES[e][0].col("id") < 5000), None, {}),
    "scan_filter_projected_away": (
        lambda e, path: ENGINES[e][0].read_parquet(path).filter(
            ENGINES[e][0].col("id") < 3000).select("v"), None, {}),
}


def _sorted(table, keys):
    frame = table.to_pandas()
    if keys:
        frame = frame.sort_values(keys, kind="stable", na_position="last")
    return frame.reset_index(drop=True)


def _same_rows(a, b, keys):
    da, db = _sorted(a, keys), _sorted(b, keys)
    assert list(da.columns) == list(db.columns)
    for name in da.columns:
        if pd.api.types.is_float_dtype(da[name]):
            np.testing.assert_allclose(da[name], db[name], rtol=1e-9,
                                       equal_nan=True)
        elif da[name].dtype == object and len(da) and isinstance(
                da[name].iloc[0], np.ndarray):
            assert [list(v) for v in da[name]] == [list(v) for v in db[name]]
        else:
            assert da[name].equals(db[name]), name


@pytest.mark.parametrize("rule", sorted(RULES))
def test_replan_rules_agree(rule, tmp_path, monkeypatch):
    build, keys, env = RULES[rule]
    monkeypatch.setenv("RAYDP_TPU_AQE_MIN_EXCHANGE_MB", "0.0001")
    for name, value in env.items():
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    for _, mod, ex, _, _ in ENGINES.values():
        monkeypatch.setattr(mod, "_EXCHANGE_COALESCE_BYTES", 0)
        if rule.startswith("join"):
            monkeypatch.setattr(mod, "_BROADCAST_JOIN_BYTES", 0)
            # the salt rule needs sub-buckets: a fanout of 8 on any host
            monkeypatch.setattr(ex.LocalExecutor, "default_fanout",
                                lambda self: 8)
    path = _parquet(tmp_path) if rule.startswith("scan") else None

    results = {}
    for engine in ("jax", "torch"):
        metrics = ENGINES[engine][4]
        monkeypatch.setenv("RAYDP_TPU_AQE", "0")
        static = build(engine, path).to_arrow()
        monkeypatch.setenv("RAYDP_TPU_AQE", "1")
        before = _aqe_counters(metrics)
        out = build(engine, path)
        parts = out.collect_partitions()
        results[engine] = (parts, _deltas(before, _aqe_counters(metrics)),
                           out._exchange_keys, out._aqe_layout)
        _same_rows(torch_exmod._concat(parts) if engine == "torch"
                   else jax_exmod._concat(parts), static, keys)
    (jparts, jdelta, jkeys, jlayout), (tparts, tdelta, tkeys, tlayout) = (
        results["jax"], results["torch"])
    assert tdelta == jdelta
    assert (tkeys, tlayout) == (jkeys, jlayout)
    assert [p.num_rows for p in tparts] == [p.num_rows for p in jparts]
    for a, b in zip(tparts, jparts):
        assert a.schema == b.schema
        _same_rows(a, b, keys)
    if rule in ("groupby_salt", "join_salt_inner", "join_salt_left"):
        assert tdelta.get("aqe/replans/salt", 0) >= 1
    elif rule == "exchange_coalesce":
        assert tdelta.get("aqe/replans/coalesce", 0) >= 1
    elif rule.startswith("scan"):
        assert tdelta.get("aqe/replans/scan", 0) == 1
    else:
        assert not any(k.startswith("aqe/replans/") for k in tdelta)
