"""The port's replica groups end to end: real replica processes on the
CPU, against the JAX package's serving tests and its ``default_model``.

The process half of the mirror of tests/test_serving.py (the in-process
half is tests/test_torch_serving.py): batching through two replicas,
``serve_kill`` failover with zero drops, the ``latency`` clause, the
SIGTERM drain, plus ``default_model`` parity with the JAX package,
``Ping`` and ``stop()`` reaping every replica, and a replica refusing to
run on a device it does not have. Every group test first waits, with a
deadline, until every replica has registered, so no assertion races a
replica's start-up, and the SIGTERM test signals a registered replica.
"""
import functools
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from raydp_tpu.serve.replica_main import default_model as jax_default_model
from raydp_tpu_torch.cluster.rpc import RpcServer
from raydp_tpu_torch.serve import ReplicaGroup
from raydp_tpu_torch.serve.replica_main import (
    ENV_DEVICE,
    ENV_REPLICA,
    ENV_SERVE_DRIVER_ADDR,
    SERVE_DRIVER_SERVICE,
)
from raydp_tpu_torch.utils.profiling import metrics
from test_torch_serve_models import sum_model, sum_on_device

REGISTER_DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


def _wait_registered(group, deadline_s=REGISTER_DEADLINE_S):
    """Block until every replica of ``group`` has registered; fail the
    test after ``deadline_s``."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if group.stats()["replicas_alive"] == group.replicas:
            return
        time.sleep(0.05)
    pytest.fail(f"replicas did not register within {deadline_s}s: "
                f"{group.stats()}")


def _group(**kw):
    kw.setdefault("model_fn", sum_model)
    kw.setdefault("restart_backoff_s", 0.1)
    group = ReplicaGroup(device="cpu", **kw).start()
    try:
        _wait_registered(group)
    except BaseException:
        group.stop()
        raise
    return group


def _submit_and_wait_all(group, n, length=3):
    reqs = [group.submit([i] * length) for i in range(n)]
    return [r.wait(timeout=60.0) for r in reqs]


def test_group_end_to_end_batches_and_stats():
    with _group(replicas=2, label="t-serve", max_batch=4,
                slo_ms=25) as group:
        results = _submit_and_wait_all(group, 24)
        assert results == [float(i * 3) for i in range(24)]
        stats = group.stats()
        assert stats["replicas_alive"] == 2
        assert stats["accepted"] == 24
        assert stats["replies"] == 24
        assert stats["errors"] == 0
        assert stats["batch_fill"] > 0
        assert stats["latency_p50_s"] > 0
        assert set(stats["per_replica"]) == {"0", "1"}


def test_serve_kill_failover_drops_nothing(monkeypatch):
    monkeypatch.setenv(
        "RAYDP_TPU_FAULT_PLAN", "serve_kill:replica=0,request=3"
    )
    with _group(replicas=2, label="t-kill", max_batch=4, slo_ms=25,
                max_restarts=3) as group:
        results = _submit_and_wait_all(group, 40)
        # zero drops: every accepted request got exactly one reply
        assert results == [float(i * 3) for i in range(40)]
        # the kill really happened and the in-flight batch was retried
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            stats = group.stats()
            if stats["restarts"] >= 1 and stats["replicas_alive"] == 2:
                break
            time.sleep(0.2)
        assert stats["restarts"] >= 1, stats
        assert stats["requeued"] >= 1, stats
        assert stats["dup_replies"] == 0, stats
        # self-healed: the killed lineage respawned within its budget
        assert stats["replicas_alive"] == 2, stats
        assert stats["dead_lineages"] == 0, stats
        assert stats["replies"] == 40, stats


def test_latency_clause_stalls_request(monkeypatch):
    monkeypatch.setenv(
        "RAYDP_TPU_FAULT_PLAN", "latency:nth=0,delay=0.6,replica=0"
    )
    with _group(replicas=1, label="t-lat", max_batch=1,
                slo_ms=10) as group:
        t0 = time.monotonic()
        assert group.predict([1, 1]) == 2.0
        assert time.monotonic() - t0 >= 0.5
        # the clause fires once; later requests are fast again
        t1 = time.monotonic()
        assert group.predict([2, 2]) == 4.0
        assert time.monotonic() - t1 < 0.5


def test_sigterm_drains_in_flight_batch():
    with _group(replicas=2, label="t-drain", max_batch=4, slo_ms=25,
                model_fn=functools.partial(sum_model, delay_s=0.3)) as group:
        reqs = [group.submit([i]) for i in range(12)]
        # wait until a replica is actually mid-batch, then SIGTERM it
        slot = group._slots[0]
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            snap = metrics.snapshot()["counters"]
            if snap.get("serve/batches", 0) >= 1:
                break
            time.sleep(0.02)
        victim = slot.proc
        os.kill(victim.pid, signal.SIGTERM)
        # every request still gets its reply: the in-flight batch
        # finishes inside the drain window, refused batches requeue
        results = [r.wait(timeout=60.0) for r in reqs]
        assert results == [float(i) for i in range(12)]
        # the drained process exited cleanly (status 0), not killed
        assert victim.wait(timeout=30.0) == 0
        snap = metrics.snapshot()["counters"]
        assert snap.get("serve/errors", 0) == 0
        assert snap["serve/replies"] == 12


def test_group_results_equal_jax_default_model():
    """No model shipped: both packages' replicas run their
    ``default_model``; the port's group gives the JAX function's answers
    on the same payloads and buckets, truncation of oversize requests
    included."""
    lengths = [1, 3, 4, 5, 9, 16, 17, 30]
    payloads = [[(7 * i + j) % 11 for j in range(n)]
                for i, n in enumerate(lengths)]
    with _group(replicas=1, label="t-default", model_fn=None,
                buckets=[4, 16], max_batch=4, slo_ms=5) as group:
        got = [r.wait(timeout=60.0)
               for r in [group.submit(p) for p in payloads]]
        want = [jax_default_model([p], group.queue.bucket_for(len(p)))[0]
                for p in payloads]
    assert got == want
    assert got[-1] == float(sum(payloads[-1][:16]))  # truncated to 16


def test_ping_then_stop_reaps_every_replica_process():
    """The group's device runs the model (over the ``device`` the model
    function binds itself), ``ping()`` reports it from every replica, and
    ``stop()`` reaps every replica process."""
    model_fn = functools.partial(sum_on_device, device="cuda")
    group = _group(replicas=2, label="t-stop", max_batch=2, slo_ms=5,
                   model_fn=model_fn)
    try:
        assert group.predict([1, 2]) == {"sum": 3.0, "device": "cpu"}
        procs = [slot.proc for slot in group._slots]
        assert all(p.poll() is None for p in procs)
        pongs = group.ping(timeout=10.0)
        assert [p["replica"] for p in pongs] == [0, 1]
        for pong in pongs:
            assert pong["pong"] is True
            assert pong["device"] == "cpu" and pong["cuda_bytes"] == 0
            assert pong["launches"] == {
                "flash_fwd": 0, "flash_bwd_delta": 0, "flash_bwd_dq": 0,
                "flash_bwd_dkv": 0}
    finally:
        group.stop()
    assert [p.poll() for p in procs] == [0, 0]
    assert not any(slot.thread.is_alive() for slot in group._slots)
    group.stop()  # idempotent


def test_replica_asked_for_cuda_without_a_card_never_registers(tmp_path):
    """The replica resolves its device before registering: asked for
    ``cuda`` without a card it exits with the reason, and the driver
    never hears from it."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    registered = []
    driver = RpcServer(SERVE_DRIVER_SERVICE, {
        "RegisterReplica": lambda req: registered.append(req) or {},
        "Ping": lambda req: {"pong": True},
    })
    env = dict(os.environ, **{
        ENV_REPLICA: "0", ENV_DEVICE: "cuda",
        ENV_SERVE_DRIVER_ADDR: driver.address,
        "PYTHONPATH": os.pathsep.join(p or os.getcwd() for p in sys.path),
    })
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "raydp_tpu_torch.serve.replica_main"],
            env=env, capture_output=True, text=True, timeout=120,
        )
    finally:
        driver.stop()
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert registered == []
