"""The port's query profiling (``DataFrame.explain``/``profile``/
``stage_stats``, ``telemetry/progress.py``, ``aqe.rule_counts`` and
``Cluster.progress_report``) against the JAX package's.

* The cases of ``tests/test_query_profiling.py`` (its new Prometheus
  families on the port's exposition too; not its XLA compile-error
  case), and the ``explain`` cases of ``tests/test_aqe.py``,
  run against the port: each module is loaded again with its engine
  imports pointed at the port. Their cluster cases run on one port
  session of 2 workers, last in this file (a live session routes every
  frame of the port to its workers); the profiling case there also
  holds ``progress_report`` converged.
* The same cases run through both engines with every ``explain`` text
  captured: the texts must be equal after masking stage ids and
  timings (stage ids are process-wide counters, times differ run to
  run), and so must the ``aqe[<rule>]`` counts of ``rule_counts``.
* ``profile()`` of the same pipelines: each stage's op, rows and
  partitions in and out and output layout equal between the engines.
* The kill switch ``RAYDP_TPU_STAGE_STATS=0`` on both engines, and the
  explain footer against the ``shuffle/elided`` counter on the port.
"""
import re

import numpy as np
import pandas as pd
import pytest

import raydp_tpu.dataframe as jax_rdf
import raydp_tpu.dataframe.dataframe as jax_dfmod
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
import raydp_tpu_torch.dataframe.dataframe as torch_dfmod
import test_aqe as jax_aqe_cases
import test_query_profiling as jax_qp_cases
from raydp_tpu.telemetry.progress import stage_store as jax_store
from raydp_tpu_torch.dataframe import aqe as torch_aqe
from raydp_tpu_torch.store import shm
from raydp_tpu_torch.telemetry.progress import stage_store as torch_store
from raydp_tpu_torch.utils.profiling import metrics as torch_metrics
from torch_port_cases import cases, load_port_module, run_case

QP_LOCAL = ("test_explain_analyze_dlrm_one_exchange",
            "test_explain_logical_plan_is_lazy",
            "test_narrow_stage_rows_in_equals_rows_out",
            "test_stage_stats_skew_reflects_zipf_keys",
            "test_new_prometheus_families_render",
            "test_stage_stats_kill_switch")
QP_CLUSTER = ("test_progress_and_analyze_on_cluster",)
AQE_LOCAL = ("test_groupby_salt_parity", "test_groupby_salt_skips_below_floor",
             "test_exchange_coalesce_parity", "test_join_salt_parity",
             "test_join_strategy_measured_annotation",
             "test_scan_pushdown_parity",
             "test_scan_pushdown_filter_col_projected_away",
             "test_kill_switch_static_bit_for_bit",
             "test_annotation_counter_parity")
AQE_CLUSTER = ("test_cluster_zipfian_join_salt_reduces_skew",
               "test_cluster_groupby_salt_parity")

PORT_QP = load_port_module("test_query_profiling.py",
                           only=QP_LOCAL + QP_CLUSTER + (
                               "_kv_frame", "_dlrm_pipeline", "_footer"))
PORT_AQE = load_port_module("test_aqe.py")
MODULES = {"qp": (PORT_QP, jax_qp_cases), "aqe": (PORT_AQE, jax_aqe_cases)}
LOCAL_CASES = [("qp", c) for c in cases(PORT_QP, QP_LOCAL)] + [
    ("aqe", c) for c in cases(PORT_AQE, AQE_LOCAL)]
CLUSTER_CASES = [("qp", c) for c in cases(PORT_QP, QP_CLUSTER)] + [
    ("aqe", c) for c in cases(PORT_AQE, AQE_CLUSTER)]


@pytest.fixture()
def zero_coalesce(monkeypatch):
    """The reference's fixture, applied to both engines: small tables
    take real multi-partition exchanges."""
    for mod in (torch_dfmod, jax_dfmod):
        monkeypatch.setattr(mod, "_EXCHANGE_COALESCE_BYTES", 0)
        monkeypatch.setattr(mod, "_AGG_COALESCE_BYTES", 0)
        monkeypatch.setattr(mod, "_COMBINE_COALESCE_BYTES", 0)


def _mask(text: str) -> str:
    text = re.sub(r"stage \d+", "stage N", text)
    return re.sub(r"wall \d+\.\d+s \(dispatch \d+\.\d+s, queue \d+\.\d+s\)",
                  "wall T", text)


def _captured(dfmod, monkeypatch):
    """Record every text ``DataFrame.explain`` returns."""
    texts = []
    original = dfmod.DataFrame.explain

    def explain(self, *args, **kwargs):
        text = original(self, *args, **kwargs)
        texts.append(text)
        return text

    monkeypatch.setattr(dfmod.DataFrame, "explain", explain)
    return texts


@pytest.mark.parametrize("kind,name,params",
                         [(k, n, p) for k, (_, n, p) in LOCAL_CASES],
                         ids=[f"{k}-{i}" for k, (i, _, _) in LOCAL_CASES])
def test_reference_case_on_port_and_plans_agree(kind, name, params, request,
                                                monkeypatch, zero_coalesce):
    port, ref = MODULES[kind]
    fixtures = {"zero_coalesce": None}
    with monkeypatch.context() as m:
        got = _captured(torch_dfmod, m)
        run_case(port, name, params, request, fixtures=fixtures)
    with monkeypatch.context() as m:
        want = _captured(jax_dfmod, m)
        run_case(ref, name, params, request, fixtures=fixtures)
    assert [_mask(t) for t in got] == [_mask(t) for t in want]
    for g, w in zip(got, want):
        assert torch_aqe.rule_counts(g) == jax_aqe_cases._aqe.rule_counts(w)


def _kv(rdf, n=20_000, parts=4, seed=7, keys=16):
    rng = np.random.RandomState(seed)
    return rdf.from_pandas(
        pd.DataFrame({"k": rng.randint(0, keys, n), "v": rng.rand(n)}),
        num_partitions=parts)


def _zipf(rdf):
    rng = np.random.RandomState(3)
    return rdf.from_pandas(pd.DataFrame({
        "k": np.minimum(rng.zipf(1.5, 20_000), 64) - 1,
        "v": rng.rand(20_000)}), num_partitions=4)


def _window_groupby(rdf):
    w = rdf.Window.partitionBy("k").orderBy("v")
    return (_kv(rdf).withColumn("rn", rdf.row_number().over(w))
            .groupBy("k").agg({"v": "max"}))


def _narrow(rdf):
    return (_kv(rdf, n=5000, parts=3).withColumn("v2", rdf.col("v") * 2)
            .select("k", "v2"))


def _skewed_window(rdf):
    w = rdf.Window.partitionBy("k").orderBy("v")
    return _zipf(rdf).withColumn("rn", rdf.row_number().over(w))


def _dedup_join(rdf):
    left = _kv(rdf, n=6000, parts=4).distinct(["k"])
    right = _kv(rdf, n=3000, parts=2, seed=9).groupBy("k").count()
    return left.join(right, on="k").orderBy("k")


PROFILED = {"window_groupby": _window_groupby, "narrow": _narrow,
            "skewed_window": _skewed_window, "dedup_join": _dedup_join}


def _stage_rows(profile):
    return [(node["op"], node["annotation"],
             [(s["op"], s["executor"], s["rows_in"], s["rows_out"],
               s["parts_in"], s["parts_out"], s["part_rows"], s["skew"])
              for s in node["stats"]])
            for node in profile["plan"]]


@pytest.mark.parametrize("pipeline", sorted(PROFILED))
def test_profile_rows_per_stage_agree(pipeline, zero_coalesce):
    got = PROFILED[pipeline](torch_rdf).profile()
    want = PROFILED[pipeline](jax_rdf).profile()
    assert _stage_rows(got) == _stage_rows(want)
    assert _mask(got["explain"]) == _mask(want["explain"])
    assert any(node["stats"] for node in got["plan"])
    for node in got["plan"]:
        for s in node["stats"]:
            assert s["skew"] >= 1.0 and s["wall_s"] >= 0.0
            assert sum(r for r in s["part_rows"] if r > 0) == s["rows_out"]


@pytest.mark.parametrize("pipeline", sorted(PROFILED))
def test_stage_stats_kill_switch_both_engines(pipeline, zero_coalesce,
                                              monkeypatch):
    monkeypatch.setenv("RAYDP_TPU_STAGE_STATS", "0")
    for rdf, store in ((torch_rdf, torch_store), (jax_rdf, jax_store)):
        last = store.last_id()
        df = PROFILED[pipeline](rdf)._flush()
        assert df.stage_stats == []
        assert store.last_id() == last
        assert "== Physical Plan ==" in df.explain(analyze=True, quiet=True)


def test_explain_footer_matches_elided_counter(zero_coalesce):
    """``tests/test_query_profiling.py``'s elision case on the port's
    engine: the footer, the ``shuffle/elided`` counter and the port's
    ``raydp_shuffles_elided_total`` family agree."""
    from raydp_tpu_torch.telemetry.export import render_prometheus

    def elided():
        return torch_metrics.snapshot().get("counters", {}).get(
            "shuffle/elided", 0.0)

    before = elided()
    text = _window_groupby(torch_rdf).explain(analyze=True, quiet=True)
    ran, skipped, _ = PORT_QP._footer(text)
    assert (ran, skipped) == (1, 1)
    assert elided() - before == skipped
    prom = render_prometheus({"driver": torch_metrics.snapshot()})
    m = re.search(r'raydp_shuffles_elided_total\{[^}]*\} (\d+(\.\d+)?)', prom)
    assert m and float(m.group(1)) >= skipped


def test_stage_store_snapshot_and_shards(tmp_path, monkeypatch,
                                         zero_coalesce):
    """The store's ``recent``/``snapshot``, and the JSONL shard a stats
    directory receives, as the JAX package writes them."""
    import json

    from raydp_tpu_torch.telemetry import progress as P

    monkeypatch.setenv("RAYDP_TPU_STATS_DIR", str(tmp_path))
    store = P.StageStatsStore(keep=4)
    ids = [store.record(P.StageStats(stage_id=0, op=f"op{i}",
                                     executor="local", rows_out=i,
                                     part_rows=[i, 2 * i]))
           for i in range(6)]
    assert ids == list(range(1, 7))
    assert [s.op for s in store.recent(2)] == ["op4", "op5"]
    snap = store.snapshot()
    assert [s["stage_id"] for s in snap["stages"]] == [3, 4, 5, 6]
    assert snap["totals"]["rows_out"] == 2 + 3 + 4 + 5
    assert snap["stages"][-1]["skew"] == round(10 / 7.5, 4)
    shard = tmp_path / f"stats-{P.os.getpid()}.jsonl"
    lines = [json.loads(x) for x in shard.read_text().splitlines()]
    assert [x["op"] for x in lines] == [f"op{i}" for i in range(6)]
    store.clear()
    assert store.recent() == []


# -- on a port session (last: a live session routes every frame) ------------

@pytest.fixture(scope="module")
def port_session():
    s = raydp_tpu_torch.init(app_name="port-profiling", num_workers=2,
                             memory_per_worker="256MB")
    namespace = s.cluster.namespace
    yield s
    raydp_tpu_torch.stop()
    assert shm.list_segments(f"rdp-{namespace}-") == []


@pytest.mark.parametrize("kind,name,params",
                         [(k, n, p) for k, (_, n, p) in CLUSTER_CASES],
                         ids=[f"{k}-{i}" for k, (i, _, _) in CLUSTER_CASES])
def test_reference_cluster_case_on_port(kind, name, params, request,
                                        port_session, zero_coalesce):
    run_case(MODULES[kind][0], name, params, request,
             fixtures={"session": port_session, "zero_coalesce": None})


def test_progress_report_through_the_master(port_session, zero_coalesce):
    """The AppMaster's ``ProgressReport`` handler serves what
    ``Cluster.progress_report`` reads, with recent stage stats."""
    from raydp_tpu_torch.cluster.rpc import RpcClient

    last = torch_store.last_id()
    _window_groupby(torch_rdf).explain(analyze=True, quiet=True)
    client = RpcClient(port_session.cluster.master.address,
                       "raydp.AppMaster")
    try:
        report = client.call("ProgressReport", {})["report"]
    finally:
        client.close()
    mine = [st for st in report["recent"] if st["stage_id"] > last]
    assert mine and all(st["done"] >= st["total"] for st in mine)
    assert not [st for st in report["active"] if st["stage_id"] > last]
    recent = [s for s in report["recent_stage_stats"]
              if s["stage_id"] > last]
    assert recent and all(s["executor"] == "cluster" and s["workers"]
                          for s in recent)
