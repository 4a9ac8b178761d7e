"""Minimal RPC layer on the standard library: named dict→dict methods.

The counterpart of ``raydp_tpu/cluster/rpc.py`` with the same surface,
``RpcServer(service, {method: fn(dict) -> dict})`` and
``RpcClient(address, service, timeout)``, on another transport: the
reference rides gRPC with cloudpickle payloads, and the machines the
port runs on need not have either. Here a call is one TCP round trip on
``127.0.0.1`` (port 0: the OS picks), carrying length-prefixed
``pickle`` frames:

* request ``(call_id, "Service.Method", request_dict)``;
* reply ``(call_id, {"ok": True, "value": ...})`` or
  ``(call_id, {"ok": False, "error": ..., "traceback": ...})``.

The server reads each connection on a thread of its own and runs the
handlers on a thread pool, so one slow handler (a model's
``ExecuteBatch``) blocks neither ``Ping`` nor ``RegisterReplica``. The
client keeps a small pool of connections, each carrying one call at a
time, so calls from several threads run side by side; a connection
whose call failed or timed out is closed, never reused, so a late reply
cannot be read as another call's.

A call that times out, or whose peer is gone, raises
:class:`RpcUnavailable` (:class:`RpcTimeout` for the deadline); a
handler that raised surfaces as :class:`RpcError` with the remote
traceback. The ``rpc_delay``/``rpc_drop`` fault-plan clauses fire
before each send (:func:`raydp_tpu_torch.fault.on_rpc`).

``pickle`` runs whatever a frame names when it is loaded, so a server
binds the loopback interface by default and talks only to its own
processes. The reference's telemetry riders (traceparent, job
attribution, watchdog brackets, flight-recorder records) arrive with the
port's telemetry plane.
"""
from __future__ import annotations

import itertools
import pickle
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

from raydp_tpu_torch import fault as _fault

_HEADER = struct.Struct("!Q")
# The reference's gRPC message limit.
MAX_FRAME_BYTES = 512 * 1024 * 1024


class RpcError(RuntimeError):
    """Remote handler raised; message carries the remote traceback."""


class RpcUnavailable(ConnectionError):
    """The call did not complete: the peer refused or dropped the
    connection, or the deadline passed. Nothing was returned."""


class RpcTimeout(RpcUnavailable):
    """The call's deadline passed before its reply arrived."""


class FaultInjectedRpcError(RpcUnavailable):
    """An ``rpc_drop`` fault-plan clause dropped this call before it was
    sent; every transport-error path treats it as a peer that is gone."""

    def __init__(self, method: str):
        super().__init__(f"fault plan dropped rpc {method}")


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(_HEADER.pack(len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("rpc deadline passed")
            sock.settimeout(remaining)
        k = sock.recv_into(view[got:])
        if k == 0:
            raise ConnectionError("connection closed by peer")
        got += k
    return bytes(buf)


def _recv_frame(sock: socket.socket, deadline: Optional[float] = None):
    (n,) = _HEADER.unpack(_recv_exact(sock, _HEADER.size, deadline))
    if n > MAX_FRAME_BYTES:
        raise ConnectionError(f"rpc frame of {n} bytes exceeds the limit")
    return pickle.loads(_recv_exact(sock, n, deadline))


def _close(sock: socket.socket) -> None:
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    sock.close()


class RpcServer:
    """Hosts a service: a dict of ``{method_name: fn(dict) -> dict}``."""

    def __init__(
        self,
        service_name: str,
        handlers: Dict[str, Callable[[dict], dict]],
        host: str = "127.0.0.1",
        port: int = 0,
        max_workers: int = 16,
    ):
        self._service = service_name
        self._handlers = dict(handlers)
        self._listener = socket.create_server((host, port))
        self.host = host
        self.port = self._listener.getsockname()[1]
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix=f"rpc-{service_name}"
        )
        self._mu = threading.Lock()
        self._conns: set = set()
        self._inflight = 0
        self._idle = threading.Condition(self._mu)
        self._stopped = False
        threading.Thread(
            target=self._accept_loop, daemon=True,
            name=f"rpc-accept-{service_name}",
        ).start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._mu:
                if self._stopped:
                    conn.close()
                    return
                self._conns.add(conn)
            threading.Thread(
                target=self._read_loop, args=(conn,), daemon=True,
                name=f"rpc-conn-{self._service}",
            ).start()

    def _read_loop(self, conn: socket.socket) -> None:
        write_mu = threading.Lock()
        try:
            while True:
                call_id, method, request = _recv_frame(conn)
                with self._mu:
                    if self._stopped:
                        return
                    # Submitted under the lock stop() takes to set
                    # _stopped, so never to a pool already shut down.
                    # Counted until the handler ends, or until stop()
                    # cancels it before it starts.
                    self._inflight += 1
                    fut = self._pool.submit(
                        self._run, conn, write_mu, call_id, method, request
                    )
                fut.add_done_callback(self._on_cancel)
        except (OSError, EOFError, pickle.UnpicklingError, ValueError):
            pass  # peer closed, or the server is stopping
        finally:
            with self._mu:
                self._conns.discard(conn)
            _close(conn)

    def _run(self, conn, write_mu, call_id, method, request) -> None:
        try:
            service, _, name = method.rpartition(".")
            fn = self._handlers.get(name) if service == self._service else None
            if fn is None:
                reply = {"ok": False, "error": f"unknown method {method}",
                         "traceback": ""}
            else:
                try:
                    reply = {"ok": True, "value": fn(request)}
                except Exception as exc:  # ship the error to the caller
                    reply = {"ok": False,
                             "error": f"{type(exc).__name__}: {exc}",
                             "traceback": traceback.format_exc()}
            try:
                payload = pickle.dumps((call_id, reply),
                                       protocol=pickle.HIGHEST_PROTOCOL)
            except Exception as exc:
                payload = pickle.dumps((call_id, {
                    "ok": False, "traceback": "",
                    "error": f"reply of {method} cannot be pickled: {exc}"}))
            with write_mu:
                try:
                    _send_frame(conn, payload)
                except OSError:
                    pass  # the caller is gone; nothing to deliver to
        finally:
            self._handler_done()

    def _on_cancel(self, fut) -> None:
        if fut.cancelled():
            self._handler_done()

    def _handler_done(self) -> None:
        with self._mu:
            self._inflight -= 1
            self._idle.notify_all()

    def stop(self, grace: Optional[float] = 0.5) -> None:
        """Stop accepting, let running handlers finish for up to
        ``grace`` seconds, then close every connection."""
        with self._mu:
            if self._stopped:
                return
            self._stopped = True
        _close(self._listener)
        self._pool.shutdown(wait=False, cancel_futures=True)
        deadline = time.monotonic() + (grace or 0.0)
        with self._mu:
            while self._inflight > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._idle.wait(remaining)
            conns = list(self._conns)
        for conn in conns:
            _close(conn)


class RpcClient:
    """Calls methods on an RpcServer: ``client.call("Method", {...})``."""

    def __init__(self, address: str, service_name: str, timeout: float = 30.0):
        self.address = address
        host, _, port = address.rpartition(":")
        self._endpoint = (host, int(port))
        self._service = service_name
        self._timeout = timeout
        self._mu = threading.Lock()
        self._idle: List[socket.socket] = []
        self._ids = itertools.count()

    def _connection(self, timeout: Optional[float]) -> socket.socket:
        with self._mu:
            if self._idle:
                return self._idle.pop()
        try:
            sock = socket.create_connection(self._endpoint, timeout=timeout)
        except OSError as exc:
            raise RpcUnavailable(
                f"cannot reach {self._service} at {self.address}: {exc}"
            ) from None
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return sock

    def call(self, method: str, request: Optional[dict] = None,
             timeout: Optional[float] = None):
        qualified = f"{self._service}.{method}"
        eff_timeout = timeout if timeout is not None else self._timeout
        call_id = next(self._ids)
        payload = pickle.dumps((call_id, qualified, request or {}),
                               protocol=pickle.HIGHEST_PROTOCOL)
        # Fault-plan hook: an rpc_delay clause sleeps here; an rpc_drop
        # clause turns the send into an unavailable peer.
        if _fault.active() and _fault.on_rpc(qualified) == "drop":
            raise FaultInjectedRpcError(qualified)
        deadline = (time.monotonic() + eff_timeout
                    if eff_timeout is not None else None)
        sock = self._connection(eff_timeout)
        try:
            sock.settimeout(eff_timeout)
            _send_frame(sock, payload)
            reply_id, reply = _recv_frame(sock, deadline)
        except socket.timeout:
            _close(sock)
            raise RpcTimeout(
                f"{qualified} at {self.address}: no reply within "
                f"{eff_timeout}s"
            ) from None
        except (OSError, EOFError, pickle.UnpicklingError) as exc:
            _close(sock)
            raise RpcUnavailable(
                f"{qualified} at {self.address} failed: "
                f"{type(exc).__name__}: {exc}"
            ) from None
        if reply_id != call_id:
            _close(sock)
            raise RpcUnavailable(
                f"{qualified}: reply {reply_id} answers another call"
            )
        with self._mu:
            self._idle.append(sock)
        if not reply.get("ok"):
            raise RpcError(
                f"remote {qualified} failed: {reply.get('error')}\n"
                f"{reply.get('traceback', '')}"
            )
        return reply.get("value")

    def try_call(self, method: str, request: Optional[dict] = None,
                 timeout: Optional[float] = None):
        """Like call() but returns None when the call failed (peer gone,
        deadline passed, or the handler raised)."""
        try:
            return self.call(method, request, timeout)
        except (RpcUnavailable, RpcError):
            return None

    def wait_ready(self, timeout: float = 10.0) -> bool:
        """True once a connection to the server opens within
        ``timeout`` seconds."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                sock = self._connection(max(0.05, deadline - time.monotonic()))
            except RpcUnavailable:
                if time.monotonic() >= deadline:
                    return False
                time.sleep(0.05)
                continue
            with self._mu:
                self._idle.append(sock)
            return True

    def close(self) -> None:
        with self._mu:
            idle, self._idle = self._idle, []
        for sock in idle:
            _close(sock)
