"""Structured spans: timed, nested regions of framework work.

The port's copy of ``raydp_tpu/telemetry/spans.py``; it leaves nothing
of it to a later slice.

The tracing half of the telemetry plane (the metrics half lives in
:mod:`raydp_tpu_torch.utils.profiling` and ships via heartbeats — see
:mod:`raydp_tpu_torch.telemetry.shipping`). A :class:`Span` records one unit
of work with ids, a parent link, and both wall-clock and monotonic
timestamps; finished spans land in an in-process ring buffer that
:func:`raydp_tpu_torch.telemetry.export.flush_spans` drains to an append-only
JSONL log.

Parent links come from two sources, consulted in order:

1. the per-thread stack — a span started while another span is open on
   the same thread becomes its child (estimator step spans nest under
   the epoch span);
2. an *ambient* :class:`TraceContext` — when the thread's stack is
   empty, the thread-local context installed by
   :meth:`SpanRecorder.propagated` wins, then the process-level context
   installed by :meth:`SpanRecorder.set_process_context`. This is how
   spans on loader producer threads, RPC handler threads, and freshly
   spawned worker processes join the driver's job trace instead of
   starting fresh ones (see :mod:`raydp_tpu_torch.telemetry.propagation`).

Hot-path cost: one ``perf_counter`` pair, a dict, and a locked deque
append per span. Instrumented paths put spans at chunk/step/stage
granularity, never per row.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Span",
    "SpanRecorder",
    "TraceContext",
    "recorder",
    "span",
    "event",
]

# Ring capacity: big enough to hold a full small training run's spans,
# bounded so an unflushed long job cannot grow without limit.
_CAPACITY = int(os.environ.get("RAYDP_TPU_SPAN_BUFFER", "4096"))


@dataclass(frozen=True)
class TraceContext:
    """A point in a trace another span can parent under.

    Defined here (not in :mod:`~raydp_tpu_torch.telemetry.propagation`) so the
    recorder can consume it without an import cycle."""

    trace_id: str
    span_id: str


@dataclass
class Span:
    """One timed region. ``end_mono`` is None while the span is open."""

    name: str
    span_id: str
    trace_id: str
    parent_id: Optional[str]
    seq: int  # process-wide start order (monotonic, gap-free per process)
    start_wall: float  # time.time() at start — for cross-process alignment
    start_mono: float  # perf_counter at start — for exact durations
    attrs: Dict[str, Any] = field(default_factory=dict)
    end_mono: Optional[float] = None
    status: str = "ok"  # ok | error
    kind: str = "span"  # span | event (zero-duration point annotation)
    tid: int = 0  # recording thread — one Perfetto track per thread

    @property
    def duration_s(self) -> Optional[float]:
        if self.end_mono is None:
            return None
        return self.end_mono - self.start_mono

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "span_id": self.span_id,
            "trace_id": self.trace_id,
            "parent_id": self.parent_id,
            "seq": self.seq,
            "start_wall": self.start_wall,
            "start_mono": self.start_mono,
            "duration_s": self.duration_s,
            "status": self.status,
            "kind": self.kind,
            "attrs": self.attrs,
            "pid": os.getpid(),
            "tid": self.tid,
        }


class SpanRecorder:
    """Per-process span factory + bounded ring buffer of finished spans."""

    def __init__(self, capacity: int = _CAPACITY):
        self._buf: "deque[Span]" = deque(maxlen=capacity)
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._seq = itertools.count(1)
        self._dropped = 0
        self._process_ctx: Optional[TraceContext] = None
        # Random salt on top of the pid: two hosts (or a pid recycled
        # across worker restarts) must never mint colliding span ids,
        # since parent links cross process boundaries via traceparent.
        self._id_prefix = f"{os.getpid():x}.{os.urandom(2).hex()}"

    # -- id scheme ------------------------------------------------------
    def _next_id(self, seq: int) -> str:
        return f"{self._id_prefix}-{seq:x}"

    def _stack(self) -> List[Span]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = []
            self._tls.stack = st
        return st

    # -- ambient context ------------------------------------------------
    def _ambient(self) -> Optional[TraceContext]:
        ctx = getattr(self._tls, "ambient", None)
        return ctx if ctx is not None else self._process_ctx

    def current_context(self) -> Optional[TraceContext]:
        """Where a new span on this thread would attach: the innermost
        open span, else the thread's propagated context, else the
        process context. None means a new span starts a fresh trace."""
        stack = self._stack()
        if stack:
            return stack[-1].context()
        return self._ambient()

    @contextlib.contextmanager
    def propagated(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Install ``ctx`` as this thread's ambient trace context for the
        duration of the block. ``None`` clears any thread-level override
        (the process context still applies). Used by RPC handler threads
        and loader producer threads to parent under a context captured
        elsewhere."""
        prev = getattr(self._tls, "ambient", None)
        self._tls.ambient = ctx
        try:
            yield
        finally:
            self._tls.ambient = prev

    def set_process_context(self, ctx: Optional[TraceContext]) -> None:
        """Default parent for every span recorded with no open span and
        no thread override — how a worker process adopts the driver's
        job trace for its whole lifetime."""
        self._process_ctx = ctx

    def process_context(self) -> Optional[TraceContext]:
        return self._process_ctx

    # -- lifecycle ------------------------------------------------------
    def start(self, name: str, **attrs: Any) -> Span:
        """Open a span; the current thread's innermost open span (or the
        ambient context) becomes its parent. Pair with :meth:`finish`."""
        stack = self._stack()
        parent = stack[-1].context() if stack else self._ambient()
        seq = next(self._seq)
        span_id = self._next_id(seq)
        sp = Span(
            name=name,
            span_id=span_id,
            trace_id=parent.trace_id if parent else span_id,
            parent_id=parent.span_id if parent else None,
            seq=seq,
            start_wall=time.time(),
            start_mono=time.perf_counter(),
            attrs=attrs,
            tid=threading.get_ident(),
        )
        stack.append(sp)
        return sp

    def finish(self, sp: Span) -> None:
        if sp.end_mono is not None:
            return
        sp.end_mono = time.perf_counter()
        stack = self._stack()
        # Remove exactly this span (identity match): an out-of-order
        # finish must not orphan unrelated siblings above it.
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] is sp:
                del stack[i]
                break
        self._append(sp)

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[Span]:
        sp = self.start(name, **attrs)
        try:
            yield sp
        except BaseException:
            sp.status = "error"
            raise
        finally:
            self.finish(sp)

    def event(self, name: str, **attrs: Any) -> Span:
        """Zero-duration point annotation (worker registered, worker
        dead, …), parented like a span."""
        stack = self._stack()
        parent = stack[-1].context() if stack else self._ambient()
        seq = next(self._seq)
        span_id = self._next_id(seq)
        now = time.perf_counter()
        sp = Span(
            name=name,
            span_id=span_id,
            trace_id=parent.trace_id if parent else span_id,
            parent_id=parent.span_id if parent else None,
            seq=seq,
            start_wall=time.time(),
            start_mono=now,
            attrs=attrs,
            end_mono=now,
            kind="event",
            tid=threading.get_ident(),
        )
        self._append(sp)
        return sp

    # -- buffer access --------------------------------------------------
    def _append(self, sp: Span) -> None:
        evicted = False
        with self._mu:
            if self._buf.maxlen is not None and len(self._buf) == self._buf.maxlen:
                evicted = True
                self._dropped += 1
            self._buf.append(sp)
        if evicted:
            # Count outside the recorder lock; the metrics counter ships
            # on heartbeats (raydp_spans_dropped_total per worker), so
            # ring evictions are never silent.
            try:
                from raydp_tpu_torch.utils.profiling import metrics

                metrics.counter_add("spans/dropped")
            except Exception:  # pragma: no cover - accounting best-effort
                pass

    @property
    def dropped(self) -> int:
        """Spans evicted from the ring before a flush drained them."""
        with self._mu:
            return self._dropped

    def drain(self) -> List[Span]:
        """Remove and return all finished spans (oldest first)."""
        with self._mu:
            out = list(self._buf)
            self._buf.clear()
        return out

    def spans(self) -> List[Span]:
        """Finished spans without clearing (tests, dashboards)."""
        with self._mu:
            return list(self._buf)

    def clear(self) -> None:
        with self._mu:
            self._buf.clear()


#: Process-wide recorder — the instrumented hot paths all record here.
recorder = SpanRecorder()
span = recorder.span
event = recorder.event
