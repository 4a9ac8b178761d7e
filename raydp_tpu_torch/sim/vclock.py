"""Virtual clock: a discrete-event heap behind the clock seam.

One thread, one heap. Every actor in a simulation (arrival feeder,
replica dispatchers, autoscaler ticks, invariant monitors, gang jobs)
is a callback scheduled at a virtual timestamp; time advances only by
popping the next due callback. The control-plane code under test is
unmodified — it blocks exactly where it always blocked
(``Condition.wait`` in the arbiter's admission loop, the batching
linger, the autoscaler's spawn backoff), but those blocks route
through :mod:`raydp_tpu_torch.utils.clock` and land here, where "waiting"
means *pumping other actors' events until the wakeup condition or the
timeout's virtual deadline*.

The cooperative-nesting trick that makes blocking calls work on one
thread: a virtual wait releases the caller's lock, runs **one** due
event (which may itself block, nesting another pump), reacquires, and
returns — a spurious wakeup, which every ``Condition.wait`` caller
already tolerates by re-checking its predicate in a loop. Nested
pumps always pop from the single shared heap, so events execute in
global virtual-time order regardless of which actor's wait is doing
the pumping. Recursion depth is bounded by the number of
*concurrently blocked* actors, not by event count; scenario runners
raise the interpreter recursion limit accordingly.

Determinism: ties in virtual time break by insertion sequence, there
is no real-time or randomness anywhere in the loop, and the seeded
schedule generators feed it — the same trace replays to the same
timeline, bit for bit.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Any, Callable, List, Optional, Tuple

from raydp_tpu_torch.utils import clock as _clock

__all__ = ["SimClock", "SimDeadlockError", "SimWallBudgetError"]

# Real wall clock for the runaway guard, reached through the seam's
# default implementation (never time.monotonic() directly).
_REAL_CLOCK = _clock.Clock()

# How often (in processed events) the wall-budget guard samples the
# real clock; cheap enough to leave always-on.
_WALL_CHECK_EVERY = 65536


class SimDeadlockError(RuntimeError):
    """A virtual wait with no timeout and no pending events: every
    actor is blocked and nothing can ever wake them. The virtual
    analogue of a hung process — always a scenario bug."""


class SimWallBudgetError(RuntimeError):
    """The simulation exceeded its real wall-clock budget
    (``max_wall_s``) — the runaway guard for accidentally-huge
    scenarios in CI."""


class _SimTimer:
    """``cancel()``-able handle returned by :meth:`SimClock.call_later`
    — the virtual stand-in for ``threading.Timer``."""

    __slots__ = ("_fn", "_args", "cancelled")

    def __init__(self, fn: Callable[..., None], args: Tuple[Any, ...]):
        self._fn = fn
        self._args = args
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True

    def _fire(self) -> None:
        if not self.cancelled:
            self._fn(*self._args)


class SimClock(_clock.Clock):
    """Event-heap virtual clock implementing the
    :class:`raydp_tpu_torch.utils.clock.Clock` seam."""

    def __init__(self, start: float = 0.0,
                 max_wall_s: float = 0.0):
        self._now = float(start)
        self._heap: List[Tuple[float, int, Callable[..., None], tuple]] = []
        self._seq = itertools.count()
        self.max_wall_s = float(max_wall_s)
        self._wall_start: Optional[float] = None
        #: Total events popped — the denominator of the bench's
        #: events/sec throughput number.
        self.events_processed = 0

    # -- Clock seam ------------------------------------------------------

    def monotonic(self) -> float:
        return self._now

    def sleep(self, seconds: float) -> None:
        """Advance virtual time by ``seconds``, running every event due
        in between (other actors keep making progress while this one
        sleeps — exactly what a real ``time.sleep`` allows)."""
        target = self._now + max(0.0, seconds)
        while self._now < target:
            self.pump_one(target)

    def wait_on(self, cond: "threading.Condition",
                timeout: Optional[float] = None) -> bool:
        """Virtual ``Condition.wait``: release the caller's lock, run
        one due event (possibly advancing to the timeout's deadline),
        reacquire, return. Always a legal spurious wakeup — the caller
        re-checks its predicate and calls back in if still unmet."""
        limit = None if timeout is None else self._now + max(0.0, timeout)
        cond.release()
        try:
            self.pump_one(limit)
        finally:
            cond.acquire()
        return True

    def wait_event(self, event: "threading.Event",
                   timeout: Optional[float] = None) -> bool:
        limit = None if timeout is None else self._now + max(0.0, timeout)
        while not event.is_set():
            if limit is not None and self._now >= limit:
                break
            self.pump_one(limit)
        return event.is_set()

    def call_later(self, delay: float, fn: Callable[..., None],
                   *args: Any) -> _SimTimer:
        handle = _SimTimer(fn, args)
        self.at(self._now + max(0.0, delay), handle._fire)
        return handle

    def defer(self, fn: Callable[[], None],
              name: str = "raydp-clock-defer") -> None:
        """A one-shot daemon thread becomes an immediate virtual event:
        it runs at the current timestamp, off the caller's stack, when
        the nearest pump reaches it."""
        self.at(self._now, fn)

    # -- scheduling ------------------------------------------------------

    def at(self, t: float, fn: Callable[..., None], *args: Any) -> None:
        """Schedule ``fn(*args)`` at virtual time ``t`` (clamped to
        now — the past is immutable). Same-time events run in
        scheduling order."""
        heapq.heappush(
            self._heap, (max(float(t), self._now), next(self._seq), fn, args)
        )

    def after(self, delay: float, fn: Callable[..., None],
              *args: Any) -> None:
        self.at(self._now + max(0.0, delay), fn, *args)

    def pending(self) -> int:
        return len(self._heap)

    # -- the pump --------------------------------------------------------

    def pump_one(self, limit: Optional[float]) -> bool:
        """Run the next due event if it falls at or before ``limit``
        (advancing ``now`` to its timestamp); otherwise advance
        straight to ``limit``. Returns True when an event ran.

        ``limit=None`` means "wait forever": an empty heap then raises
        :class:`SimDeadlockError` instead of spinning."""
        if self._heap and (limit is None or self._heap[0][0] <= limit):
            t, _, fn, args = heapq.heappop(self._heap)
            if t > self._now:
                self._now = t
            self.events_processed += 1
            if self.max_wall_s > 0 and \
                    self.events_processed % _WALL_CHECK_EVERY == 0:
                self._check_wall()
            fn(*args)
            return True
        if limit is None:
            raise SimDeadlockError(
                f"virtual wait with an empty event heap at t={self._now:.3f}"
                " — every actor is blocked and nothing can wake them"
            )
        if limit > self._now:
            self._now = limit
        return False

    def run(self, until: Optional[float] = None) -> None:
        """Drain the heap: run every event due at or before ``until``
        (every event at all when ``None``), then advance to ``until``."""
        if self._wall_start is None:
            self._wall_start = _REAL_CLOCK.monotonic()
        while self._heap and (until is None or self._heap[0][0] <= until):
            self.pump_one(until)
        if until is not None and until > self._now:
            self._now = until

    def _check_wall(self) -> None:
        if self._wall_start is None:
            self._wall_start = _REAL_CLOCK.monotonic()
            return
        spent = _REAL_CLOCK.monotonic() - self._wall_start
        if spent > self.max_wall_s:
            raise SimWallBudgetError(
                f"simulation exceeded its wall budget: {spent:.1f}s spent "
                f"(max_wall_s={self.max_wall_s}), "
                f"{self.events_processed} events processed, "
                f"virtual t={self._now:.1f}s"
            )
