"""The port's observability control plane (``raydp_tpu_torch/telemetry``:
``timeseries``, ``slo``, ``dashboard``; ``Cluster.dashboard_report``, the
master's ``DashboardReport``, ``/debug/dashboard``) against
``tests/test_slo.py``.

* Its cases run against the port, loaded by ``tests/torch_port_cases.py``
  with every ``raydp_tpu`` name pointed at the port (the module is in
  ``WHOLE_PACKAGE``: its client-mode case connects from a subprocess
  whose script names the package in a string). The session fixture is
  a 2-worker port session; each case starts from a reset registry, as
  the reference's autouse fixture gives it.
* ``test_injected_latency_fault_breach_and_recovery`` builds a
  ``ReplicaGroup`` of a nested model function on the default device. The
  port's group ships its model by reference and needs ``device="cpu"``
  without a card, so the case is mirrored here with
  ``tests/test_torch_serve_models.sum_model`` on the CPU: the same
  fault clause, engine, windows and assertions.
"""
import time

import pytest

from raydp_tpu_torch.serve import ReplicaGroup
from raydp_tpu_torch.telemetry import events as events_mod
from raydp_tpu_torch.telemetry import render_prometheus
from raydp_tpu_torch.telemetry.slo import (
    SloConfig,
    SloEngine,
    default_objectives,
)
from raydp_tpu_torch.telemetry.timeseries import (
    TimeSeriesConfig,
    TimeSeriesSampler,
)
from raydp_tpu_torch.utils.profiling import metrics
from test_torch_serve_models import sum_model
from torch_port_cases import cases, load_port_module, run_case, time_limit

MIRRORED = ("test_injected_latency_fault_breach_and_recovery",)
PORT_REFERENCE = load_port_module("test_slo.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE)
    if n.startswith("test_") and n not in MIRRORED])
LIMIT_S = 180


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) + len(MIRRORED) == 18


def test_injected_latency_fault_breach_and_recovery(monkeypatch):
    """A replica stalled 0.8 s by a ``latency`` clause breaches the
    ``serve_p99`` objective with a triage naming the series, recovers
    once the rolling p99 is diluted, and the episode reaches the MTTR
    report and the ``raydp_slo_*`` families. The process's event ring
    starts empty, as it does where the reference runs this case: the
    harness cases before it (the dashboard CLI's) leave an SLO episode
    of their own there."""
    events_mod._ring.clear()
    monkeypatch.setenv("RAYDP_TPU_FAULT_PLAN",
                       "latency:nth=0,delay=0.8,replica=0")
    sampler = TimeSeriesSampler(config=TimeSeriesConfig(
        interval_s=0.05, capacity=512, max_series=512))
    eng = SloEngine(
        store=sampler.store,
        config=SloConfig(interval_s=0.05, short_window_s=1.0,
                         long_window_s=6.0, budget=0.2, burn_threshold=1.0,
                         recovery_evals=2),
        objectives=[o for o in default_objectives()
                    if o.name == "serve_p99"])
    group = ReplicaGroup(replicas=1, model_fn=sum_model, label="slo-smoke",
                         max_batch=1, slo_ms=10_000, restart_backoff_s=0.1,
                         device="cpu")
    with time_limit(LIMIT_S), group.start():
        group.predict([1, 2, 3])
        breach = None
        deadline = time.time() + 20
        while time.time() < deadline and breach is None:
            sampler.sample()
            for tr in eng.evaluate():
                if tr["kind"] == "breach":
                    breach = tr
            time.sleep(0.05)
        assert breach is not None, "no breach within deadline"
        attrs = breach["event"]["attrs"]
        assert attrs["objective"] == "serve_p99"
        assert any(row["series"] == "serve/latency/p99_s"
                   for row in attrs["top_series"])
        assert isinstance(attrs["correlated"], list)

        for i in range(150):
            group.predict([i, i])
        recovered = None
        deadline = time.time() + 30
        while time.time() < deadline and recovered is None:
            sampler.sample()
            for tr in eng.evaluate():
                if tr["kind"] == "recovered":
                    recovered = tr
            time.sleep(0.05)
        assert recovered is not None, "no recovery within deadline"
        assert recovered["mttr_s"] > 0

    report = events_mod.mttr_report(events_mod.local_events())
    episodes = [ep for job in report.values()
                for ep in job.get("episodes", [])
                if ep.get("start_kind") == "slo/breach"
                and ep.get("end_kind") == "slo/recovered"]
    assert episodes, report
    assert episodes[0]["repair_s"] == pytest.approx(recovered["mttr_s"],
                                                    abs=0.01)
    text = render_prometheus(
        {"workers": {}, "aggregate": {}, "driver": metrics.snapshot()})
    assert 'raydp_slo_breaches_total{objective="serve_p99"' in text
    assert 'raydp_slo_status{objective="serve_p99"' in text
    assert 'raydp_slo_burn_rate{objective="serve_p99"' in text
    # The group's lifecycle is on the timeline too.
    names = {e["name"] for e in events_mod.local_events()}
    assert {"serve/start", "serve/replica_up", "serve/stop"} <= names
