"""The port's telemetry plane (``raydp_tpu_torch/telemetry``: spans,
shipping, the Prometheus exposition, the span shards) against
``tests/test_telemetry.py``.

* Every case of ``tests/test_telemetry.py`` runs against the port
  (``test_reference_case_on_port``), loaded by ``tests/torch_port_cases.py``
  with its ``raydp_tpu.telemetry`` imports pointed at
  ``raydp_tpu_torch.telemetry``; its two-worker case runs on a port
  session, the worker functions going to the workers by value.
* Two cases are not taken as they stand. The estimator case fits a
  ``JAXEstimator``: it is rewritten here with the port's ``Estimator``
  and an MLP on the CPU (``test_estimator_writes_nested_span_log``), the
  same rows and the same assertions. ``test_telemetry_tests_run_in_tier1``
  scans the JAX package's test files and fails on the reference's own
  slow markers (a fault of the reference, ROADMAP Queue C); its port
  counterpart holds that no ``tests/test_torch_*.py`` naming
  ``raydp_tpu_torch.telemetry`` is slow-marked.
"""
import json
import os
import re

import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu_torch
from raydp_tpu_torch.telemetry import recorder
from raydp_tpu_torch.train import Estimator
from torch_port_cases import cases, load_port_module, run_case, time_limit

EXCLUDED = ("test_estimator_writes_nested_span_log",
            "test_telemetry_tests_run_in_tier1")
PORT_REFERENCE = load_port_module("test_telemetry.py")
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


def test_estimator_writes_nested_span_log(tmp_path, monkeypatch):
    """``tests/test_telemetry.py``'s estimator case on the port's
    ``Estimator``: an epoch flushes a ``spans-<pid>.jsonl`` shard where
    step spans nest under their epoch span and chunk spans closed before
    being consumed."""
    monkeypatch.setenv("RAYDP_TPU_TELEMETRY_DIR", str(tmp_path))
    recorder.clear()

    rng = np.random.default_rng(0)
    df = pd.DataFrame(rng.random((256, 4)), columns=list("abcd"))
    df["y"] = df.a * 2 + df.b
    torch.manual_seed(0)
    est = Estimator(
        model=raydp_tpu_torch.MLP(4, hidden=(16,), out_dim=1, device="cpu"),
        loss="mse", num_epochs=2, batch_size=64,
        feature_columns=list("abcd"), label_column="y",
        epoch_mode="stream", device="cpu")
    est.fit_on_df(df)

    log = tmp_path / f"spans-{os.getpid()}.jsonl"
    assert log.exists()
    records = [json.loads(line) for line in log.read_text().splitlines()]
    epochs = [r for r in records if r["name"] == "train/epoch"]
    steps = [r for r in records if r["name"] == "train/step"]
    assert len(epochs) == 2
    assert len(steps) == 8  # 256 rows / 64 batch × 2 epochs
    epoch_ids = {e["span_id"]: e for e in epochs}
    for s in steps:
        assert s["parent_id"] in epoch_ids
        parent = epoch_ids[s["parent_id"]]
        assert s["attrs"]["epoch"] == parent["attrs"]["epoch"]
        assert s["trace_id"] == parent["trace_id"]
        assert s["seq"] > parent["seq"]
        assert s["duration_s"] >= 0
    chunks = [r for r in records if r["name"] == "ingest/chunk"]
    assert chunks
    step_ids = {s["span_id"] for s in steps}
    assert all(c["parent_id"] not in step_ids for c in chunks)
    # The fit root closes after the last epoch's flush and is flushed
    # again: every epoch parents under it.
    fits = [r for r in records if r["name"] == "train/fit"]
    assert len(fits) == 1
    assert all(e["parent_id"] == fits[0]["span_id"] for e in epochs)


def test_port_telemetry_tests_run_in_tier1():
    """Every ``tests/test_torch_*.py`` naming the port's telemetry runs
    under the tier-1 gate (``-m 'not slow'``): no slow markers there."""
    tests_dir = os.path.dirname(os.path.abspath(__file__))
    offenders = []
    for fname in sorted(os.listdir(tests_dir)):
        if not (fname.startswith("test_torch_") and fname.endswith(".py")):
            continue
        with open(os.path.join(tests_dir, fname), encoding="utf-8") as f:
            text = f.read()
        if "raydp_tpu_torch.telemetry" not in text:
            continue
        if re.search(r"pytest\.mark\.slow|pytestmark\s*=.*slow", text):
            offenders.append(fname)
    assert not offenders, offenders


_CLIENT_REPORTS = """
import json, sys
import raydp_tpu_torch
s = raydp_tpu_torch.connect(sys.argv[1])
c = s.cluster
view = c.metrics_snapshot()
print(json.dumps({
    "usage": c.usage_report(),
    "events": c.events_report(),
    "health": c.health_report(),
    "workers": {w: v.get("counters", {}).get("worker/tasks")
                for w, v in view["workers"].items()},
    "prometheus": "raydp_job_task_seconds_total" in c.prometheus_metrics(),
}, sort_keys=True, default=str))
raydp_tpu_torch.stop()
"""


def test_second_driver_reports_equal_in_process(tmp_path, monkeypatch):
    """A second driver (``connect`` from a subprocess) reads the same
    usage, events, health and merged metrics as the session's own
    driver, once the workers' beats have landed."""
    import subprocess
    import sys
    import time

    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.telemetry import accounting

    monkeypatch.setenv("RAYDP_TPU_TELEMETRY_DIR", str(tmp_path))
    with time_limit(LIMIT_S):
        s = raydp_tpu_torch.init(app_name="reports-parity", num_workers=2)
        try:
            pdf = pd.DataFrame({"k": np.arange(2000) % 7,
                                "v": np.arange(2000, dtype=np.float64)})
            # An explicit job: an earlier test may have left this
            # process a default job of another name.
            etl_job = accounting.mint_job("etl")
            with accounting.job_scope(etl_job):
                out = (rdf.from_pandas(pdf, num_partitions=4)
                       .groupBy("k").agg({"v": "sum"}).to_pandas())
            assert len(out) == 7
            cl = s.cluster
            workers = sorted(w.worker_id for w in cl.alive_workers())

            def settled():
                view = cl.metrics_snapshot()
                return (all("counters" in view["workers"].get(w, {})
                            for w in workers), cl.usage_report())

            prev = None
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                shipped, usage = settled()
                if shipped and usage == prev:
                    break
                prev = usage
                time.sleep(2.5)  # a worker beat is 2 s
            proc = subprocess.run(
                [sys.executable, "-c", _CLIENT_REPORTS, cl.master.address],
                capture_output=True, text=True, timeout=90,
                cwd=os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__))))
            assert proc.returncode == 0, proc.stderr
            remote = json.loads(proc.stdout.strip().splitlines()[-1])
            view = cl.metrics_snapshot()
            local = json.loads(json.dumps({
                "usage": cl.usage_report(),
                "events": cl.events_report(),
                "health": cl.health_report(),
                "workers": {w: v.get("counters", {}).get("worker/tasks")
                            for w, v in view["workers"].items()},
                "prometheus": ("raydp_job_task_seconds_total"
                               in cl.prometheus_metrics()),
            }, sort_keys=True, default=str))
        finally:
            raydp_tpu_torch.stop()
    assert remote["usage"] == local["usage"]
    assert local["usage"]["jobs"][etl_job.job_id]["usage"][
        "task_seconds"] > 0
    assert remote["events"] == local["events"]
    assert remote["workers"] == local["workers"]
    assert remote["prometheus"] and local["prometheus"]
    for key in ("healthy", "stalled_workers", "dead_workers"):
        assert remote["health"][key] == local["health"][key]
    assert sorted(remote["health"]["workers"]) == sorted(
        local["health"]["workers"])
