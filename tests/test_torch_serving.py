"""The port's serving plane against the JAX package's: continuous
batching, HTTP degradation, the fault-plan clauses and a group's
construction, all in process.

Mirrors tests/test_serving.py on the port's copies, save the busy-cluster
429 (the arbiter) and the traceparent echo (telemetry), which wait for
the port's control and telemetry planes; the 504 test keeps its
request-id half. The tests that run replica processes (batching,
``serve_kill``, ``latency``, the SIGTERM drain) are in
tests/test_torch_serve_group.py: a small file, which pytest-xdist's
``loadfile`` schedule (largest files first) runs late, away from
tests/test_serving.py, whose replica start-up races under load.
"""
import json
import urllib.error
import urllib.request

import pytest
import torch

from raydp_tpu.serve import ReplicaGroup as JaxReplicaGroup
from raydp_tpu_torch.fault.plan import FaultPlanError, parse_plan
from raydp_tpu_torch.serve import (
    QueueFullError,
    ReplicaGroup,
    RequestCancelled,
    RequestQueue,
    ServeError,
    ServeFrontend,
    ServeRequest,
)
from raydp_tpu_torch.utils.profiling import metrics
from test_torch_serve_models import sum_model


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


# ---------------------------------------------------------------------
# RequestQueue: buckets, shedding, continuous assembly, at-most-once
# ---------------------------------------------------------------------


def test_bucket_selection():
    q = RequestQueue(buckets=[4, 16])
    assert q.bucket_for(1) == 4
    assert q.bucket_for(4) == 4
    assert q.bucket_for(5) == 16
    # the last bucket absorbs oversize requests
    assert q.bucket_for(100) == 16


def test_queue_overflow_sheds_with_eta():
    q = RequestQueue(max_depth=2, slo_ms=10, max_batch=4)
    q.submit(ServeRequest([1]))
    q.submit(ServeRequest([2]))
    with pytest.raises(QueueFullError) as ei:
        q.submit(ServeRequest([3]))
    assert ei.value.queue_depth == 2
    assert ei.value.eta_s is not None and ei.value.eta_s > 0
    snap = metrics.snapshot()["counters"]
    assert snap["serve/rejected"] == 1
    assert snap["serve/requests"] == 2


def test_batch_assembly_groups_by_bucket():
    q = RequestQueue(max_depth=16, slo_ms=30, max_batch=4,
                     buckets=[4, 16])
    short = [ServeRequest([1, 2]) for _ in range(3)]
    long = ServeRequest(list(range(10)))
    for r in short:
        q.submit(r)
    q.submit(long)
    first = q.next_batch(wait_timeout=0.5)
    assert [r.request_id for r in first] == [r.request_id for r in short]
    assert all(r.attempts == 1 for r in first)
    second = q.next_batch(wait_timeout=0.5)
    assert [r.request_id for r in second] == [long.request_id]


def test_complete_is_at_most_once():
    q = RequestQueue(max_depth=4)
    req = ServeRequest([1])
    assert q.complete(req, result=1.0) is True
    assert q.complete(req, result=2.0) is False
    assert req.wait() == 1.0
    snap = metrics.snapshot()["counters"]
    assert snap["serve/dup_replies"] == 1
    assert snap["serve/replies"] == 1


def test_requeue_goes_to_front_in_order():
    q = RequestQueue(max_depth=16, slo_ms=1, max_batch=1)
    newer = ServeRequest([9])
    q.submit(newer)
    a, b = ServeRequest([1]), ServeRequest([2])
    assert q.requeue([a, b]) == 2
    order = [q.next_batch(0.2)[0].request_id for _ in range(3)]
    assert order == [a.request_id, b.request_id, newer.request_id]
    assert metrics.snapshot()["counters"]["serve/requeued"] == 2


def test_requeue_cancels_expired_and_skips_replied():
    q = RequestQueue(max_depth=16)
    expired = ServeRequest([1], timeout_s=0.0)
    answered = ServeRequest([2])
    q.complete(answered, result="done")
    assert q.requeue([expired, answered]) == 0
    assert q.depth() == 0
    with pytest.raises(RequestCancelled, match="expired during failover"):
        expired.wait()


def test_close_cancels_pending():
    q = RequestQueue(max_depth=4)
    req = ServeRequest([1])
    q.submit(req)
    q.close()
    with pytest.raises(RequestCancelled):
        req.wait()
    with pytest.raises(QueueFullError):
        q.submit(ServeRequest([2]))


# ---------------------------------------------------------------------
# Fault-plan grammar: serve_kill and latency clauses
# ---------------------------------------------------------------------


def test_parse_serve_kill_clause():
    (c,) = parse_plan("serve_kill:replica=1,request=5,code=7")
    assert (c.kind, c.replica, c.request, c.code) == ("serve_kill", 1, 5, 7)
    assert c.matches_replica(1)
    assert not c.matches_replica(0)
    assert not c.matches_replica(None)


def test_parse_latency_clause():
    (c,) = parse_plan("latency:nth=3,delay=0.25")
    assert (c.kind, c.nth, c.delay) == ("latency", 3, 0.25)
    # no replica target: matches every replica
    assert c.matches_replica(0) and c.matches_replica(None)


@pytest.mark.parametrize("plan", [
    "serve_kill:replica=0",            # missing request=
    "latency:nth=3",                   # missing delay=
    "serve_kill:replica=0,request=x",  # non-numeric
    "latency:nth=1,delay=0.1,rank=0",  # key not allowed for kind
])
def test_bad_serve_clauses_rejected(plan):
    with pytest.raises(FaultPlanError):
        parse_plan(plan)


# ---------------------------------------------------------------------
# ServeFrontend degradation paths (stub groups, no subprocesses)
# ---------------------------------------------------------------------


class _ShedGroup:
    def __init__(self, exc):
        self._exc = exc

    def submit(self, payload, timeout_s=None, request_id=None):
        raise self._exc

    def stats(self):
        return {"stub": True}


class _EchoGroup:
    def submit(self, payload, timeout_s=None, request_id=None):
        req = ServeRequest(payload, timeout_s=timeout_s,
                           request_id=request_id)
        req.attempts = 1
        req.result = sum(payload)
        req.replied = True
        req.done.set()
        return req

    def stats(self):
        return {"replicas_alive": 1}


def test_frontend_queue_full_is_429_with_retry_after():
    fe = ServeFrontend(_ShedGroup(
        QueueFullError("serving queue full", queue_depth=7, eta_s=2.3)
    ))
    status, payload, headers = fe.handle_predict({"inputs": [1]})
    assert status == 429
    assert payload["queue_depth"] == 7
    assert headers["Retry-After"] == "3"  # ceil(2.3)


def test_frontend_shed_without_eta_defaults_to_one_second():
    fe = ServeFrontend(_ShedGroup(QueueFullError("closed")))
    status, _, headers = fe.handle_predict({"inputs": [1]})
    assert status == 429
    assert headers["Retry-After"] == "1"


def test_frontend_missing_inputs_is_400():
    status, payload, _ = ServeFrontend(_EchoGroup()).handle_predict({})
    assert status == 400


def test_frontend_deadline_expiry_is_504():
    class _Stuck:
        def submit(self, payload, timeout_s=None, request_id=None):
            return ServeRequest(payload, timeout_s=0.05)

        def stats(self):
            return {}

    status, payload, _ = ServeFrontend(_Stuck()).handle_predict(
        {"inputs": [1]}
    )
    assert status == 504


def test_frontend_http_roundtrip():
    fe = ServeFrontend(_EchoGroup()).start()
    try:
        base = f"http://127.0.0.1:{fe.port}"
        req = urllib.request.Request(
            f"{base}/predict",
            data=json.dumps({"inputs": [1, 2, 3]}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=5) as resp:
            body = json.loads(resp.read())
        assert body["result"] == 6
        assert body["id"]
        with urllib.request.urlopen(f"{base}/serve/stats", timeout=5) as r:
            assert json.loads(r.read())["replicas_alive"] == 1
        with urllib.request.urlopen(f"{base}/livez", timeout=5) as r:
            assert json.loads(r.read())["alive"] is True
    finally:
        fe.close()


def test_frontend_http_429_carries_retry_after_header():
    fe = ServeFrontend(_ShedGroup(
        QueueFullError("full", queue_depth=5, eta_s=4.0)
    )).start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{fe.port}/predict",
            data=json.dumps({"inputs": [1]}).encode(),
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=5)
        assert ei.value.code == 429
        assert ei.value.headers["Retry-After"] == "4"
        assert json.loads(ei.value.read())["queue_depth"] == 5
    finally:
        fe.close()


# ---------------------------------------------------------------------
# Group construction (no replica starts; the process tests are in
# test_torch_serve_group.py)
# ---------------------------------------------------------------------


def test_stats_has_jax_group_key_set():
    for mode in ("batch", "decode"):
        ours = ReplicaGroup(replicas=1, label="t-keys", mode=mode).stats()
        theirs = JaxReplicaGroup(replicas=1, label="t-keys",
                                 mode=mode).stats()
        assert set(ours) == set(theirs)
        assert set(ours["phases"]) == set(theirs["phases"])
        for name in ours["phases"]:
            assert set(ours["phases"][name]) == set(theirs["phases"][name])
        if mode == "decode":
            assert set(ours["decode"]) == set(theirs["decode"])
            assert set(ours["decode"]["retired"]) == \
                set(theirs["decode"]["retired"])
        else:
            assert ours["decode"] is theirs["decode"] is None


def test_unpicklable_model_fn_raises_at_start():
    group = ReplicaGroup(replicas=1, label="t-lambda", device="cpu",
                         model_fn=lambda payloads, bucket: payloads)
    with pytest.raises(ServeError, match="cannot be pickled"):
        group.start()
    assert group._slots == [] and group._server is None


def test_cuda_group_raises_at_start_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    group = ReplicaGroup(replicas=1, label="t-nocard", model_fn=sum_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        group.start()
    assert group._slots == []


# ---------------------------------------------------------------------
# correlation headers, phase provenance, cold-start null guards
# ---------------------------------------------------------------------


class _PhasedGroup:
    """Echo stub whose replies carry a phase decomposition."""

    def submit(self, payload, timeout_s=None, request_id=None):
        req = ServeRequest(payload, timeout_s=timeout_s,
                           request_id=request_id)
        req.attempts = 1
        req.result = sum(payload)
        req.phases = {"queue_wait": 0.01, "linger": 0.002,
                      "execute": 0.03, "reply": 0.008,
                      "padding_waste": 0.004, "total": 0.05}
        req.replied = True
        req.done.set()
        return req

    def stats(self):
        return {"replicas_alive": 1}


def test_predict_response_carries_request_id_and_phases():
    fe = ServeFrontend(_PhasedGroup())
    status, payload, headers = fe.handle_predict(
        {"inputs": [1, 2], "id": "req-abc"}
    )
    assert status == 200
    assert headers["X-RayDP-Request-Id"] == "req-abc"
    assert payload["id"] == "req-abc"
    phases = payload["phases"]
    four = (phases["queue_wait"] + phases["linger"]
            + phases["execute"] + phases["reply"])
    assert four == pytest.approx(phases["total"])


def test_predict_504_carries_request_id():
    class _Stuck:
        def submit(self, payload, timeout_s=None, request_id=None):
            return ServeRequest(payload, timeout_s=0.05,
                                request_id=request_id)

        def stats(self):
            return {}

    status, payload, headers = ServeFrontend(_Stuck()).handle_predict(
        {"inputs": [1], "id": "slow-1"}
    )
    assert status == 504
    assert headers["X-RayDP-Request-Id"] == "slow-1"
    assert payload["id"] == "slow-1"


def test_predict_429_echoes_client_supplied_id():
    fe = ServeFrontend(_ShedGroup(QueueFullError("full", 5, 1.0)))
    _, _, headers = fe.handle_predict({"inputs": [1], "id": "mine"})
    assert headers["X-RayDP-Request-Id"] == "mine"
    assert headers["Retry-After"] == "1"


def test_cold_group_stats_are_null_not_nan():
    group = ReplicaGroup(replicas=1, model_fn=sum_model, label="t-cold")
    stats = group.stats()  # zero replies ever: nulls, no KeyError
    assert stats["latency_p50_s"] is None
    assert stats["latency_p99_s"] is None
    assert stats["per_replica"] == {}
    for phase in ("queue_wait", "linger", "execute", "reply"):
        assert stats["phases"][phase]["mean_s"] is None
        assert stats["phases"][phase]["p99_s"] is None
    # the whole document survives JSON (no NaN/Inf leaks)
    json.dumps(stats, allow_nan=False)


def test_cold_serve_stats_http_is_200():
    group = ReplicaGroup(replicas=1, model_fn=sum_model,
                         label="t-cold-http")
    fe = ServeFrontend(group).start()
    try:
        with urllib.request.urlopen(
            f"http://127.0.0.1:{fe.port}/serve/stats", timeout=5
        ) as resp:
            doc = json.loads(resp.read())
        assert doc["latency_p99_s"] is None
        assert doc["replies"] == 0
    finally:
        fe.close()


def test_cold_queue_eta_is_positive_before_any_reply():
    q = RequestQueue(max_depth=1, slo_ms=25, max_batch=4)
    # EWMA is SLO-seeded: the very first shed carries a usable ETA
    assert q.shed_eta_s() > 0
    q.submit(ServeRequest([1]))
    with pytest.raises(QueueFullError) as ei:
        q.submit(ServeRequest([2]))
    assert ei.value.eta_s is not None and ei.value.eta_s > 0
    from raydp_tpu_torch.serve.frontend import retry_after_s
    assert retry_after_s(ei.value) >= 1
