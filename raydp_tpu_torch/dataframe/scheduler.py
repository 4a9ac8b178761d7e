"""Event-driven partition-level stage scheduler (streaming execution).

The barriered executor runs a plan stage-at-a-time: submit every
partition's task, ``result()`` them all, hand the full output list to
the next stage. One slow partition therefore stalls EVERY downstream
partition, and the training ingest edge cannot start until the last
ETL partition lands (the canonical accelerator host-input bottleneck,
arXiv:2011.03641).

This module gives *every* narrow stage streaming dispatch:

* :class:`PendingPartition` — a partition that does not exist yet: a
  ``concurrent.futures.Future`` resolving to a ``pa.Table``. Stages
  return these immediately instead of barriering; consumers that need bytes call :func:`resolve`.
* :class:`StreamingStage` — per-partition dependency tracking with a
  bounded in-flight window: each output's task is dispatched the moment
  its upstream partitions exist (completion callbacks, no ``wait``-all),
  and at most ``RAYDP_TPU_PIPELINE_WINDOW`` tasks of one stage are in
  flight at a time.

Wide stages (exchange) and size/row/materialize probes stay barriers:
they need every input (or true partition metadata the adaptive planner
must not see as zero), so the executor resolves pendings at those choke
points — DataFrame-level callers never see a half-built partition.

Lock discipline: the scheduler lock only ever guards
list/counter mutation. Dependency resolution, task submission, future
completion, and stage-stats finalization all run OUTSIDE the lock —
collect-under-lock, dispatch-outside-lock.

Kill switch: ``RAYDP_TPU_STREAMING=0`` restores barriered stage-at-a-
time semantics everywhere (stages resolve before returning).

Every dispatched task is bracketed for the overlap counter
(:mod:`raydp_tpu_torch.telemetry.overlap`), as in the reference.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future
from typing import Any, Callable, List, Optional, Sequence, Tuple

from raydp_tpu_torch.telemetry import overlap as _overlap

STREAMING_ENV = "RAYDP_TPU_STREAMING"
WINDOW_ENV = "RAYDP_TPU_PIPELINE_WINDOW"


def streaming_enabled() -> bool:
    """Read the kill switch LIVE (not cached at import): the bench and
    tests toggle it between runs inside one process."""
    return os.environ.get(STREAMING_ENV, "1").strip().lower() not in (
        "0", "false", "no", "off"
    )


def pipeline_window() -> int:
    """Max in-flight tasks per streaming stage; 0 = unbounded."""
    try:
        return max(0, int(os.environ.get(WINDOW_ENV, "0") or 0))
    except ValueError:
        return 0


class PendingPartition:
    """A partition still being produced: resolves to a ``pa.Table``.
    Identity-hashable (lives in plain partition lists)."""

    __slots__ = ("future", "index", "op")

    def __init__(self, future: Future, index: int = 0, op: str = ""):
        self.future = future
        self.index = index
        self.op = op

    def done(self) -> bool:
        return self.future.done()

    def result(self, timeout: Optional[float] = None):
        return self.future.result(timeout)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "done" if self.future.done() else "pending"
        return f"<PendingPartition #{self.index} {self.op or 'stage'} {state}>"


def is_pending(part: Any) -> bool:
    return isinstance(part, PendingPartition)


def resolve_one(part: Any):
    """Barrier for ONE partition: block until it exists (no-op for
    concrete partitions). Raises the producing task's exception."""
    if isinstance(part, PendingPartition):
        return part.result()
    return part


def resolve(parts: Sequence[Any]) -> List[Any]:
    """Barrier choke point: materialize every pending partition, in
    order — the streaming analog of the old ``[f.result() ...]``."""
    return [resolve_one(p) for p in parts]


def all_settled(parts: Sequence[Any]) -> bool:
    """Whether every partition is already concrete (or its producing
    task has landed). The AQE's probe guard: replanning from live
    partition sizes is only free when nothing is in flight — probing a
    pending partition would resolve it and barrier the streaming
    pipeline, so skew probes skip frames that are still streaming and
    fall back to recorded stage stats instead."""
    return not any(
        isinstance(p, PendingPartition) and not p.future.done()
        for p in parts
    )


def when_settled(parts: Sequence[Any], callback: Callable[[], None]) -> None:
    """Run ``callback`` once every partition in ``parts`` has settled
    (resolved or failed); immediately when none is pending. Used to
    defer freeing of temporary inputs until the in-flight tasks that
    consume them have landed — discarding at dispatch time would race
    the tasks' fetches."""
    pend = [p.future for p in parts if isinstance(p, PendingPartition)]
    if not pend:
        callback()
        return
    mu = threading.Lock()
    remaining = [len(pend)]

    def _done(_f: Future) -> None:
        with mu:
            remaining[0] -= 1
            last = remaining[0] == 0
        if last:
            callback()

    for f in pend:
        f.add_done_callback(_done)


def chain(part: Any, fn: Callable[[Any], Any]):
    """Apply ``fn`` to a partition WITHOUT barriering: concrete parts
    transform now, pending ones transform upon resolution (the result
    is a new :class:`PendingPartition`). Used to ride owner-transfer
    onto streaming block handoffs."""
    if not isinstance(part, PendingPartition):
        return fn(part)
    out: Future = Future()

    def _done(f: Future) -> None:
        exc = f.exception()
        if exc is not None:
            out.set_exception(exc)
            return
        try:
            out.set_result(fn(f.result()))
        except BaseException as e:  # noqa: BLE001 - marshalled to waiter
            out.set_exception(e)

    part.future.add_done_callback(_done)
    return PendingPartition(out, part.index, part.op)


class StreamingStage:
    """Dependency-tracked, windowed dispatch of one narrow stage.

    ``deps[i]`` lists output ``i``'s upstream partitions (possibly
    pending). ``submit(items)`` receives ``[(i, resolved_deps), ...]``
    for outputs whose dependencies all exist and must return one task
    future per item; the scheduler wires completion callbacks so each
    output :class:`PendingPartition` resolves the moment its task lands.

    ``on_output(i, value)`` fires per completed task (stage-stats
    output accounting) and ``on_close()`` exactly once after the last
    output finalizes — BEFORE that final output future is set, so "all
    outputs resolved" implies "stage stats recorded".
    """

    def __init__(
        self,
        deps: Sequence[Sequence[Any]],
        submit: Callable[[List[Tuple[int, List[Any]]]], Sequence[Future]],
        on_output: Optional[Callable[[int, Any], None]] = None,
        on_close: Optional[Callable[[], None]] = None,
        window: Optional[int] = None,
        op: str = "",
    ):
        self.op = op
        self._deps = [list(d) for d in deps]
        self._submit = submit
        self._on_output = on_output
        self._on_close = on_close
        self._window = pipeline_window() if window is None else max(0, window)
        n = len(self._deps)
        self._mu = threading.Lock()
        self._missing: List[int] = [0] * n
        self._failed: List[Optional[BaseException]] = [None] * n
        self._ready: List[int] = []
        self._inflight = 0
        self._open = n  # outputs not yet finalized
        self._futures: List[Future] = [Future() for _ in range(n)]
        self.outputs: List[PendingPartition] = [
            PendingPartition(f, i, op) for i, f in enumerate(self._futures)
        ]

    def start(self) -> List[PendingPartition]:
        """Register dependency callbacks and dispatch everything already
        runnable; returns the output pendings immediately."""
        pend: dict = {}  # id(future) -> (future, [output indices])
        pre_failed: List[Tuple[int, BaseException]] = []
        for i, dl in enumerate(self._deps):
            miss = 0
            for d in dl:
                if not isinstance(d, PendingPartition):
                    continue
                if d.future.done():
                    exc = d.future.exception()
                    if exc is not None and self._failed[i] is None:
                        self._failed[i] = exc
                else:
                    miss += 1
                    pend.setdefault(id(d.future), (d.future, []))[1].append(i)
            self._missing[i] = miss
            if self._failed[i] is not None:
                pre_failed.append((i, self._failed[i]))
            elif miss == 0:
                self._ready.append(i)
        for fut, idxs in pend.values():
            fut.add_done_callback(
                lambda f, idxs=idxs: self._dep_done(f, idxs)
            )
        for i, exc in pre_failed:
            self._finalize(i, error=exc)
        self._pump()
        return self.outputs

    # -- internals ------------------------------------------------------
    def _dep_done(self, fut: Future, idxs: List[int]) -> None:
        exc = fut.exception()
        fail: List[int] = []
        with self._mu:
            newly_ready: List[int] = []
            for i in idxs:
                if self._failed[i] is not None:
                    continue
                if exc is not None:
                    self._failed[i] = exc
                    fail.append(i)
                    continue
                self._missing[i] -= 1
                if self._missing[i] == 0:
                    newly_ready.append(i)
            self._ready.extend(newly_ready)
        for i in fail:
            self._finalize(i, error=exc)
        self._pump()

    def _pump(self) -> None:
        """Dispatch ready outputs up to the window. Reentrant-safe:
        concurrent pumps take disjoint batches off the ready list."""
        while True:
            with self._mu:
                cap = len(self._ready)
                if self._window > 0:
                    cap = min(cap, self._window - self._inflight)
                if cap <= 0:
                    return
                batch = self._ready[:cap]
                del self._ready[:cap]
                self._inflight += len(batch)
            items = [
                (i, [resolve_one(d) for d in self._deps[i]]) for i in batch
            ]
            # ETL tasks in flight, for the overlap counter's ETL side.
            for _ in batch:
                _overlap.tracker.etl_begin()
            try:
                futures = self._submit(items)
            except BaseException as exc:  # noqa: BLE001 - fan to outputs
                with self._mu:
                    self._inflight -= len(batch)
                for _ in batch:
                    _overlap.tracker.etl_end()
                for i, _vals in items:
                    self._finalize(i, error=exc)
                continue
            for (i, _vals), f in zip(items, futures):
                f.add_done_callback(
                    lambda fut, i=i: self._task_done(i, fut)
                )

    def _task_done(self, i: int, fut: Future) -> None:
        _overlap.tracker.etl_end()
        with self._mu:
            self._inflight -= 1
        exc = fut.exception()
        if exc is not None:
            self._finalize(i, error=exc)
        else:
            value = fut.result()  # already done; returns immediately
            if self._on_output is not None:
                try:
                    self._on_output(i, value)
                except Exception:
                    pass  # stats must never fail the stage
            self._finalize(i, value=value)
        self._pump()

    def _finalize(self, i: int, value: Any = None,
                  error: Optional[BaseException] = None) -> None:
        with self._mu:
            self._open -= 1
            last = self._open == 0
        if last and self._on_close is not None:
            # Close BEFORE setting the final future: a consumer that has
            # resolved every output may immediately read stage stats.
            try:
                self._on_close()
            except Exception:
                pass
        f = self._futures[i]
        if error is not None:
            f.set_exception(error)
        else:
            f.set_result(value)
