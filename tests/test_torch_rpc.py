"""The port's standard-library RPC layer: round trips, remote errors,
deadlines, dead peers, the rpc_drop/rpc_delay fault clauses, and a slow
handler that must not hold up a concurrent Ping.

The client stamps the caller's trace context and job into each request
(``traceparent``, ``job``) where there are any, as the JAX package's
does; the echo handler returns the request without those riders, so the
round trips hold whatever an earlier test left in this process."""
import socket
import threading
import time

import pytest

from raydp_tpu_torch import fault
from raydp_tpu_torch.cluster.rpc import (
    FaultInjectedRpcError,
    RpcClient,
    RpcError,
    RpcServer,
    RpcTimeout,
    RpcUnavailable,
)
from raydp_tpu_torch.telemetry.accounting import JOB_KEY
from raydp_tpu_torch.telemetry.propagation import TRACEPARENT_KEY

SERVICE = "t.Svc"


def _echo(req):
    return {"echo": {k: v for k, v in req.items()
                     if k not in (TRACEPARENT_KEY, JOB_KEY)}}


def _slow(req):
    time.sleep(req.get("s", 1.0))
    return {"slept": req.get("s", 1.0)}


def _boom(req):
    raise ValueError(f"bad input {req.get('x')}")


@pytest.fixture
def server():
    srv = RpcServer(SERVICE, {
        "Echo": _echo,
        "Ping": lambda req: {"pong": True},
        "Slow": _slow,
        "Boom": _boom,
    })
    yield srv
    srv.stop(grace=0.0)


@pytest.fixture
def client(server):
    c = RpcClient(server.address, SERVICE, timeout=10.0)
    yield c
    c.close()


@pytest.fixture
def plan(monkeypatch):
    """Set a fault plan for this test only."""
    def _set(text):
        monkeypatch.setenv("RAYDP_TPU_FAULT_PLAN", text)
        fault.reset_for_tests()
    yield _set
    monkeypatch.delenv("RAYDP_TPU_FAULT_PLAN", raising=False)
    fault.reset_for_tests()


def test_round_trip(server, client):
    req = {"ids": [1, 2, 3], "nested": {"x": 1.5, "y": None}, "s": "é"}
    assert client.call("Echo", req) == {"echo": req}
    assert client.call("Echo") == {"echo": {}}
    assert server.address == f"127.0.0.1:{server.port}"
    assert server.port > 0


def test_handler_error_surfaces_as_rpc_error(client):
    with pytest.raises(RpcError, match="ValueError: bad input 7") as ei:
        client.call("Boom", {"x": 7})
    assert "Traceback" in str(ei.value)
    assert client.try_call("Boom", {"x": 7}) is None
    # the connection survives a remote error
    assert client.call("Ping") == {"pong": True}


def test_unknown_method_and_service_are_errors(server, client):
    with pytest.raises(RpcError, match="unknown method"):
        client.call("Nope")
    other = RpcClient(server.address, "t.Other")
    try:
        with pytest.raises(RpcError, match="unknown method t.Other.Ping"):
            other.call("Ping")
    finally:
        other.close()


def test_timeout_raises_and_the_client_recovers(client):
    t0 = time.monotonic()
    with pytest.raises(RpcTimeout):
        client.call("Slow", {"s": 1.0}, timeout=0.2)
    assert time.monotonic() - t0 < 0.9
    assert isinstance(RpcTimeout("x"), RpcUnavailable)
    # the timed-out connection is dropped: the late reply is never read
    assert client.call("Echo", {"n": 1}) == {"echo": {"n": 1}}


def test_call_to_a_stopped_server_raises(server, client):
    assert client.call("Ping") == {"pong": True}
    server.stop(grace=0.0)
    with pytest.raises(RpcUnavailable):
        client.call("Ping", timeout=2.0)
    assert client.try_call("Ping", timeout=2.0) is None
    fresh = RpcClient(server.address, SERVICE)
    try:
        with pytest.raises(RpcUnavailable, match="cannot reach"):
            fresh.call("Ping", timeout=2.0)
        assert fresh.wait_ready(timeout=0.3) is False
    finally:
        fresh.close()


def test_peer_dying_mid_call_raises():
    """A peer that reads the request and dies without replying."""
    listener = socket.create_server(("127.0.0.1", 0))
    port = listener.getsockname()[1]

    def die_after_reading():
        conn, _ = listener.accept()
        conn.recv(1 << 16)
        conn.close()

    t = threading.Thread(target=die_after_reading, daemon=True)
    t.start()
    c = RpcClient(f"127.0.0.1:{port}", SERVICE)
    try:
        with pytest.raises(RpcUnavailable, match="closed by peer"):
            c.call("Ping", timeout=5.0)
    finally:
        c.close()
        listener.close()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_rpc_drop_clause_drops_one_call(plan, client):
    plan("rpc_drop:method=Echo,nth=1")
    assert client.call("Echo", {"n": 0}) == {"echo": {"n": 0}}
    with pytest.raises(FaultInjectedRpcError, match="dropped rpc t.Svc.Echo"):
        client.call("Echo", {"n": 1})
    assert client.try_call("Echo", {"n": 2}) == {"echo": {"n": 2}}
    # other methods count separately and are never dropped
    assert client.call("Ping") == {"pong": True}


def test_rpc_delay_clause_delays_one_call(plan, client):
    plan("rpc_delay:method=t.Svc.Ping,nth=0,delay=0.4")
    t0 = time.monotonic()
    assert client.call("Ping") == {"pong": True}
    assert time.monotonic() - t0 >= 0.35
    t1 = time.monotonic()
    assert client.call("Ping") == {"pong": True}
    assert time.monotonic() - t1 < 0.35


def test_slow_handler_does_not_block_a_concurrent_ping(server, client):
    other = RpcClient(server.address, SERVICE)
    slow_reply = []
    slow = threading.Thread(
        target=lambda: slow_reply.append(client.call("Slow", {"s": 1.5})),
        daemon=True,
    )
    slow.start()
    time.sleep(0.2)  # the slow call is in its handler
    try:
        for stub in (client, other):  # same client and another one
            t0 = time.monotonic()
            assert stub.call("Ping", timeout=1.0) == {"pong": True}
            assert time.monotonic() - t0 < 0.5
    finally:
        other.close()
    slow.join(timeout=10.0)
    assert not slow.is_alive()
    assert slow_reply == [{"slept": 1.5}]


def test_concurrent_calls_get_their_own_replies(client):
    """Many threads share one client: every reply answers its own call."""
    errors = []

    def worker(w):
        for i in range(40):
            req = {"w": w, "i": i}
            try:
                if client.call("Echo", req) != {"echo": req}:
                    errors.append((w, i))
            except Exception as exc:  # noqa: BLE001 - collected, asserted
                errors.append(exc)

    threads = [threading.Thread(target=worker, args=(w,), daemon=True)
               for w in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30.0)
    assert not any(t.is_alive() for t in threads)
    assert errors == []


def test_wait_ready_and_stop_grace(server):
    c = RpcClient(server.address, SERVICE)
    try:
        assert c.wait_ready(timeout=2.0) is True
        done = []
        t = threading.Thread(
            target=lambda: done.append(c.call("Slow", {"s": 0.3})),
            daemon=True,
        )
        t.start()
        time.sleep(0.1)
        server.stop(grace=2.0)  # the running handler finishes and replies
        t.join(timeout=5.0)
        assert done == [{"slept": 0.3}]
    finally:
        c.close()


def test_stop_waits_only_for_running_handlers():
    """Calls still queued for a worker when ``stop()`` runs are
    cancelled and counted out: ``stop()`` waits for the one running
    handler, not for its whole grace."""
    srv = RpcServer(SERVICE, {"Slow": _slow}, max_workers=1)
    clients = [RpcClient(srv.address, SERVICE, timeout=10.0)
               for _ in range(4)]
    replies = []
    threads = [threading.Thread(
        target=lambda c=c: replies.append(c.try_call("Slow", {"s": 0.5})),
        daemon=True) for c in clients]
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 10.0
        while srv._inflight < len(clients):  # one running, three queued
            assert time.monotonic() < deadline, srv._inflight
            time.sleep(0.01)
        t0 = time.monotonic()
        srv.stop(grace=10.0)
        took = time.monotonic() - t0
        for t in threads:
            t.join(timeout=10.0)
    finally:
        for c in clients:
            c.close()
    assert took < 5.0, took
    assert srv._inflight == 0
    assert sorted(replies, key=str) == [None, None, None, {"slept": 0.5}]
