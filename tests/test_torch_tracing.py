"""The port's trace plane (``raydp_tpu_torch/telemetry``: propagation,
the RPC riders, the dropped-span counter, the Chrome trace and
``analyze``) against ``tests/test_tracing.py``.

* Every case of ``tests/test_tracing.py`` runs against the port
  (``test_reference_case_on_port``), its ``raydp_tpu.telemetry`` and
  ``raydp_tpu.cluster`` imports pointed at the port: the RPC case runs
  over the port's standard-library RPC.
* Its two-worker fit fits a ``JAXEstimator``: it is rewritten here with
  the port's ``Estimator`` and an MLP on the CPU
  (``test_two_worker_fit_produces_single_distributed_trace``), on a port
  session, the same rows and the same assertions.
"""
import json
import os
import time

import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu_torch
from raydp_tpu_torch.telemetry import analyze, chrome_trace, recorder
from raydp_tpu_torch.train import Estimator
from torch_port_cases import cases, load_port_module, run_case, time_limit

EXCLUDED = ("test_two_worker_fit_produces_single_distributed_trace",)
PORT_REFERENCE = load_port_module("test_tracing.py")
REFERENCE_NAMES = tuple(n for n in dir(PORT_REFERENCE)
                        if n.startswith("test_") and n not in EXCLUDED)
LIMIT_S = 120


@pytest.mark.parametrize("name,params",
                         [c[1:] for c in cases(PORT_REFERENCE,
                                               REFERENCE_NAMES)],
                         ids=[c[0] for c in cases(PORT_REFERENCE,
                                                  REFERENCE_NAMES)])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def _worker_steps(ctx):
    """Three ``train/step`` spans in a worker, flushed before the task's
    reply (this module goes to the workers by value)."""
    import time as _t

    from raydp_tpu_torch.telemetry import flush_spans
    from raydp_tpu_torch.telemetry import span as _span

    for i in range(3):
        with _span("train/step", step=i):
            _t.sleep(0.005)
    flush_spans()
    return "stepped"


def test_two_worker_fit_produces_single_distributed_trace(tmp_path,
                                                          monkeypatch):
    """``tests/test_tracing.py``'s acceptance case on the port: a
    two-worker run under ``RAYDP_TPU_TELEMETRY_DIR`` yields one merged
    Chrome trace whose driver, master and worker spans share the
    session's trace_id, and ``analyze`` reports a critical path and a
    per-rank skew table."""
    monkeypatch.setenv("RAYDP_TPU_TELEMETRY_DIR", str(tmp_path))
    recorder.clear()
    with time_limit(LIMIT_S):
        s = raydp_tpu_torch.init(app_name="tracing-acceptance",
                                 num_workers=2)
        try:
            workers = sorted(w.worker_id for w in s.cluster.alive_workers())
            assert len(workers) == 2
            for wid in workers:
                assert s.cluster.submit(_worker_steps, worker_id=wid,
                                        timeout=30.0) == "stepped"
            rng = np.random.default_rng(0)
            df = pd.DataFrame(rng.random((128, 4)), columns=list("abcd"))
            df["y"] = df.a * 2 + df.b
            torch.manual_seed(0)
            est = Estimator(
                model=raydp_tpu_torch.MLP(4, hidden=(16,), out_dim=1,
                                          device="cpu"),
                loss="mse", num_epochs=1, batch_size=64,
                feature_columns=list("abcd"), label_column="y",
                epoch_mode="stream", device="cpu")
            est.fit_on_df(df)

            live = s.cluster.trace_report()
            assert live is not None and live["num_spans"] > 0

            def _tasks_flushed():
                recs = chrome_trace.load_span_records(str(tmp_path))
                ids = {r["attrs"].get("worker_id") for r in recs
                       if r["name"] == "worker/task"}
                return ids >= set(workers)

            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline and not _tasks_flushed():
                time.sleep(0.5)
        finally:
            raydp_tpu_torch.stop()

    records = chrome_trace.load_span_records(str(tmp_path))
    roots = [r for r in records if r["name"] == "cluster/job"]
    assert len(roots) == 1
    trace_id = roots[0]["trace_id"]
    pids = {r["pid"] for r in records}
    assert len(pids) >= 3
    for pid in pids:
        assert any(r["trace_id"] == trace_id
                   for r in records if r["pid"] == pid), pid
    tasks = [r for r in records if r["name"] == "worker/task"]
    assert {t["attrs"]["worker_id"] for t in tasks} >= set(workers)
    assert all(t["trace_id"] == trace_id for t in tasks)
    worker_pids = pids - {roots[0]["pid"]}
    worker_steps = [r for r in records if r["name"] == "train/step"
                    and r["pid"] in worker_pids]
    assert len(worker_steps) >= 6
    assert all(r["trace_id"] == trace_id for r in worker_steps)
    fits = [r for r in records if r["name"] == "train/fit"]
    assert fits and all(r["trace_id"] == trace_id for r in fits)

    out = chrome_trace.write_chrome_trace(str(tmp_path))
    with open(out, encoding="utf-8") as f:
        trace = json.load(f)
    spans_x = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    assert {e["pid"] for e in spans_x} == pids
    in_job = [e for e in spans_x if e["args"].get("trace_id") == trace_id]
    assert len(in_job) / len(spans_x) > 0.9

    report = analyze.analyze_records(records)
    assert report["trace_id"] == trace_id
    assert report["critical_path"]
    assert report["critical_path"][0]["name"] == "cluster/job"
    ranks = report["step_skew"]["ranks"]
    assert sum(label.startswith("worker") for label in ranks) >= 2
    text = analyze.format_report(report)
    assert "critical path:" in text
    assert "per-rank step skew:" in text
    assert "slowest:" in text
