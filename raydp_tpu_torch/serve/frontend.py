"""HTTP frontend for the serving plane: ``/predict``, ``/generate`` and ``/serve/stats``.

The counterpart of ``raydp_tpu/serve/frontend.py``: a stdlib
``ThreadingHTTPServer`` on a daemon thread, one POST route per request
kind that blocks the handler thread on the request's reply event, and
one GET route exposing :meth:`ReplicaGroup.stats`.

Graceful degradation is the contract: a full queue
(:class:`~raydp_tpu_torch.serve.batching.QueueFullError`) becomes **429**
with a ``Retry-After`` header derived from the shed ETA; a request that
misses its deadline becomes **504**. Anything accepted gets exactly one
reply. Every admitted request's response carries its id in
``X-RayDP-Request-Id``. The reference's busy-cluster 429 and its
``traceparent`` echo arrive with the port's control and telemetry planes.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional
from urllib.parse import urlsplit

from raydp_tpu_torch.serve.batching import QueueFullError, RequestCancelled

logger = logging.getLogger(__name__)

SERVE_PORT_ENV = "RAYDP_TPU_SERVE_PORT"


def retry_after_s(exc: Exception) -> int:
    """``Retry-After`` seconds from a shed error's ETA (ceil, >= 1)."""
    eta = getattr(exc, "eta_s", None)
    if eta is None or eta <= 0:
        return 1
    return max(1, int(math.ceil(eta)))


class ServeFrontend:
    """HTTP facade over anything with ``submit(payload, timeout_s,
    request_id)`` and ``stats()``: normally a
    :class:`~raydp_tpu_torch.serve.group.ReplicaGroup`; tests substitute
    stubs to drive the degradation paths deterministically."""

    def __init__(self, group: Any):
        self.group = group
        self._server = None
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._close_mu = threading.Lock()
        self.port = 0

    # -- request handling (transport-independent, unit-testable) --------

    def handle_predict(self, body: Dict[str, Any]) -> tuple:
        """Process one /predict body; returns ``(status, payload,
        headers)``. Every admitted request's response carries
        ``X-RayDP-Request-Id``; 200 bodies carry the per-phase latency
        decomposition."""
        if "inputs" not in body:
            return 400, {"error": "body must carry 'inputs'"}, {}
        t0 = time.monotonic()
        try:
            req = self.group.submit(
                body["inputs"],
                timeout_s=body.get("timeout_s"),
                request_id=body.get("id"),
            )
        except QueueFullError as exc:
            shed_headers = {"Retry-After": str(retry_after_s(exc))}
            if body.get("id"):
                shed_headers["X-RayDP-Request-Id"] = str(body["id"])
            return (
                429,
                {
                    "error": str(exc),
                    "queue_depth": exc.queue_depth,
                    "eta_s": exc.eta_s,
                },
                shed_headers,
            )
        corr = {"X-RayDP-Request-Id": req.request_id}
        try:
            result = req.wait()
        except RequestCancelled as exc:
            logger.info("serve request %s timed out after %d attempts",
                        req.request_id, req.attempts)
            return 504, {"error": str(exc), "id": req.request_id}, corr
        except Exception as exc:  # replica-side model failure
            return 500, {"error": str(exc), "id": req.request_id}, corr
        phases = req.phases
        return (
            200,
            {
                "id": req.request_id,
                "result": result,
                "latency_s": round(time.monotonic() - t0, 6),
                "attempts": req.attempts,
                "phases": (
                    {k: round(v, 6) for k, v in phases.items()}
                    if phases else None
                ),
            },
            corr,
        )

    def handle_generate(self, body: Dict[str, Any]) -> tuple:
        """Process one /generate body (decode-mode groups): ``prompt``
        is a token list, optional ``max_new``/``eos``/``timeout_s``.
        Same degradation contract as /predict; 200 bodies add the
        token stream and its TTFT."""
        prompt = body.get("prompt")
        if not isinstance(prompt, (list, tuple)) or not prompt:
            return 400, {"error": "body must carry a non-empty 'prompt' "
                                  "token list"}, {}
        submit = getattr(self.group, "submit_generate", None)
        if submit is None:
            return 400, {"error": "group does not support generate "
                                  "(mode='decode' required)"}, {}
        t0 = time.monotonic()
        try:
            req = submit(
                prompt,
                max_new=int(body.get("max_new") or 32),
                eos=body.get("eos"),
                timeout_s=body.get("timeout_s"),
                request_id=body.get("id"),
            )
        except QueueFullError as exc:
            return (
                429,
                {
                    "error": str(exc),
                    "queue_depth": exc.queue_depth,
                    "eta_s": exc.eta_s,
                },
                {"Retry-After": str(retry_after_s(exc))},
            )
        corr = {"X-RayDP-Request-Id": req.request_id}
        try:
            result = req.wait()
        except RequestCancelled as exc:
            return 504, {"error": str(exc), "id": req.request_id}, corr
        except Exception as exc:
            return 500, {"error": str(exc), "id": req.request_id}, corr
        phases = req.phases
        ttft = req.ttft_s()
        return (
            200,
            {
                "id": req.request_id,
                "tokens": result.get("tokens"),
                "n": result.get("n"),
                "finish_reason": result.get("finish_reason"),
                "ttft_s": round(ttft, 6) if ttft is not None else None,
                "latency_s": round(time.monotonic() - t0, 6),
                "attempts": req.attempts,
                "phases": (
                    {k: round(v, 6) for k, v in phases.items()}
                    if phases else None
                ),
            },
            corr,
        )

    # -- HTTP plumbing ---------------------------------------------------

    def start(self, port: Optional[int] = None,
              host: str = "127.0.0.1") -> "ServeFrontend":
        if port is None:
            raw = os.environ.get(SERVE_PORT_ENV, "0")
            try:
                port = int(raw)
            except ValueError:
                port = 0
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def _reply(self, code: int, body: bytes, ctype: str,
                       headers: Optional[Dict[str, str]] = None) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_json(self, code: int, payload: Dict[str, Any],
                            headers: Optional[Dict[str, str]] = None
                            ) -> None:
                self._reply(
                    code,
                    json.dumps(payload, default=str).encode("utf-8"),
                    "application/json",
                    headers,
                )

            def do_POST(self):  # noqa: N802 - http.server API
                route = urlsplit(self.path).path
                if route not in ("/predict", "/generate"):
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                    body = json.loads(
                        self.rfile.read(length).decode("utf-8") or "{}"
                    )
                except (ValueError, UnicodeDecodeError):
                    self._reply_json(400, {"error": "invalid JSON body"})
                    return
                handle = (frontend.handle_generate
                          if route == "/generate"
                          else frontend.handle_predict)
                try:
                    code, payload, headers = handle(body)
                    self._reply_json(code, payload, headers)
                except Exception as exc:
                    try:
                        self._reply_json(500, {"error": str(exc)})
                    except Exception:
                        pass

            def do_GET(self):  # noqa: N802 - http.server API
                path = urlsplit(self.path).path
                try:
                    if path == "/serve/stats":
                        self._reply_json(200, frontend.group.stats())
                    elif path == "/livez":
                        self._reply_json(200, {"alive": True})
                    else:
                        self.send_error(404)
                except Exception as exc:
                    try:
                        self.send_error(500, str(exc))
                    except Exception:
                        pass

            def log_message(self, *args):  # silence per-request noise
                pass

        class Server(ThreadingHTTPServer):
            # A connect burst must land in the serving queue's 429
            # path, not die at the socket: the stdlib listen backlog
            # of 5 resets connections the queue could have shed.
            request_queue_size = 128

        self._server = Server((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="raydp-serve-http", daemon=True,
        )
        self._thread.start()
        logger.info("serving frontend on %s:%d (/predict /serve/stats)",
                    host, self.port)
        return self

    def close(self) -> None:
        with self._close_mu:
            if self._closed or self._server is None:
                return
            self._closed = True
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
