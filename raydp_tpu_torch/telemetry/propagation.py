"""Cross-process and cross-thread trace-context propagation.

The port's copy of ``raydp_tpu/telemetry/propagation.py``; it leaves nothing
of it to a later slice.

A trace crosses three kinds of boundaries in this framework, and each
has one carrier:

* **Process spawn** — the driver puts its job context in the
  ``RAYDP_TPU_TRACEPARENT`` environment variable of every worker it
  launches; worker mains call :func:`adopt_env_context` at startup so
  every span they ever record parents under the job trace.
* **RPC** — :class:`~raydp_tpu_torch.cluster.rpc.RpcClient` stamps the
  caller's :func:`current_context` into the request dict as a
  ``traceparent`` entry, and :class:`~raydp_tpu_torch.cluster.rpc.RpcServer`
  runs the handler inside :func:`propagated` with the extracted
  context. Handlers that defer work to other threads (the SPMD runner)
  forward the still-present ``traceparent`` key themselves.
* **Thread hand-off** — producer/consumer pairs inside one process
  (the loader's prefetch thread) capture :func:`current_context` on the
  submitting thread and wrap the worker thread's body in
  ``with propagated(ctx):``.

The wire format is deliberately minimal: ``"<trace_id>;<span_id>"``.
Span ids contain ``-``, so ``;`` is the separator. Parsing is tolerant
— anything malformed yields ``None``, and a ``None`` context is always
a safe no-op to propagate.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

from raydp_tpu_torch.telemetry.spans import TraceContext, recorder as _recorder

__all__ = [
    "TRACEPARENT_ENV",
    "TraceContext",
    "current_context",
    "propagated",
    "set_process_context",
    "process_context",
    "mint_context",
    "to_traceparent",
    "from_traceparent",
    "inject",
    "extract",
    "env_for_child",
    "context_from_env",
    "adopt_env_context",
]

TRACEPARENT_ENV = "RAYDP_TPU_TRACEPARENT"

#: Key carried in RPC request dicts (and SPMD run-queue items).
TRACEPARENT_KEY = "traceparent"


def current_context() -> Optional[TraceContext]:
    """The context a new span on this thread would parent under."""
    return _recorder.current_context()


def propagated(ctx: Optional[TraceContext]):
    """``with propagated(ctx):`` — spans recorded in the block (on this
    thread, with no enclosing open span) parent under ``ctx``."""
    return _recorder.propagated(ctx)


def set_process_context(ctx: Optional[TraceContext]) -> None:
    _recorder.set_process_context(ctx)


def process_context() -> Optional[TraceContext]:
    return _recorder.process_context()


def mint_context(name: str = "trace/root", **attrs: Any) -> TraceContext:
    """Record a root annotation span and return its context.

    The driver calls this once per job; the returned context is what
    every other process/thread of the job parents under, and the
    recorded event is the root node the analyzer hangs the merged trace
    tree from."""
    return _recorder.event(name, **attrs).context()


# -- wire format --------------------------------------------------------


def to_traceparent(ctx: Optional[TraceContext]) -> Optional[str]:
    if ctx is None:
        return None
    return f"{ctx.trace_id};{ctx.span_id}"


def from_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    if not header or not isinstance(header, str):
        return None
    trace_id, sep, span_id = header.partition(";")
    if not sep or not trace_id or not span_id:
        return None
    return TraceContext(trace_id, span_id)


def inject(request: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Return ``request`` with the caller's context stamped in as
    ``traceparent``. Copies rather than mutates (retry loops reuse
    payload dicts); an explicit caller-provided traceparent wins."""
    if request is None or not isinstance(request, dict):
        return request
    if TRACEPARENT_KEY in request:
        return request
    header = to_traceparent(current_context())
    if header is None:
        return request
    return {**request, TRACEPARENT_KEY: header}


def extract(request: Any) -> Optional[TraceContext]:
    if not isinstance(request, Mapping):
        return None
    return from_traceparent(request.get(TRACEPARENT_KEY))


# -- process spawn ------------------------------------------------------


def env_for_child(ctx: Optional[TraceContext] = None) -> Dict[str, str]:
    """Environment entries that hand ``ctx`` (default: the caller's
    current context) to a child process. Empty when there is nothing to
    propagate, so it is always safe to splat into a launch env."""
    header = to_traceparent(ctx if ctx is not None else current_context())
    return {TRACEPARENT_ENV: header} if header else {}


def context_from_env(
    environ: Optional[Mapping[str, str]] = None,
) -> Optional[TraceContext]:
    env = os.environ if environ is None else environ
    return from_traceparent(env.get(TRACEPARENT_ENV))


def adopt_env_context() -> Optional[TraceContext]:
    """Install the spawning process's context (if any) as this process's
    default parent. Worker mains call this first thing."""
    ctx = context_from_env()
    if ctx is not None:
        set_process_context(ctx)
    return ctx
