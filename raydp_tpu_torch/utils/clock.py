"""Injectable clock: the seam a test or a simulator drives.

The counterpart of ``raydp_tpu/utils/clock.py``. The serve plane's
time-dependent decisions (continuous-batching lingers, request
deadlines, the ``latency`` fault clause) read time and block through
this module instead of ``time``/``threading`` directly. The default
:class:`Clock` delegates straight to those primitives; a test installs a
virtual clock to drive the request queue deterministically.

Contract for seam users:

* read time via :func:`monotonic`, never ``time.monotonic()``;
* block on a condition via :func:`wait_on` (spurious wakeups allowed:
  callers re-check their predicate in a loop);
* block on an event via :func:`wait_event`;
* delay a callback via :func:`call_later` (returns a Timer-shaped
  handle with ``cancel()``);
* run a callback off the current call stack via :func:`defer`.

Installation is process-global and not reentrant: :func:`install`
while a non-default clock is active raises; :func:`uninstall` in a
``finally`` is part of the contract.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional

__all__ = [
    "Clock",
    "install",
    "uninstall",
    "installed",
    "is_virtual",
    "monotonic",
    "sleep",
    "wait_on",
    "wait_event",
    "call_later",
    "defer",
]


class Clock:
    """Real-time default implementation and the interface virtual
    clocks subclass. Each method maps 1:1 onto the primitive it
    replaced at the call sites."""

    def monotonic(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)

    def wait_on(self, cond: "threading.Condition",
                timeout: Optional[float] = None) -> bool:
        """``cond.wait(timeout)`` — caller holds the condition's lock
        and loops on its predicate (spurious wakeups allowed)."""
        return cond.wait(timeout=timeout)

    def wait_event(self, event: "threading.Event",
                   timeout: Optional[float] = None) -> bool:
        """``event.wait(timeout)`` — True when the event is set."""
        return event.wait(timeout=timeout)

    def call_later(self, delay: float, fn: Callable[..., None],
                   *args: Any) -> Any:
        """Schedule ``fn(*args)`` after ``delay`` seconds; returns a
        handle with ``cancel()`` (a daemon ``threading.Timer`` here)."""
        timer = threading.Timer(delay, fn, args=args)
        timer.daemon = True
        timer.start()
        return timer

    def defer(self, fn: Callable[[], None],
              name: str = "raydp-clock-defer") -> None:
        """Run ``fn`` off the current call stack (a one-shot daemon
        thread here; an immediate event on a virtual clock)."""
        threading.Thread(target=fn, daemon=True, name=name).start()


_real = Clock()
_installed: Clock = _real
_mu = threading.Lock()


def install(clock: Clock) -> None:
    """Make ``clock`` the process clock. Raises when a non-default
    clock is already installed (no nesting — a leaked install is a
    bug, not a feature)."""
    global _installed
    with _mu:
        if _installed is not _real:
            raise RuntimeError(
                "a virtual clock is already installed; uninstall() the "
                "previous one first (sim harnesses must uninstall in a "
                "finally block)"
            )
        _installed = clock


def uninstall() -> None:
    """Restore the real-time clock (idempotent)."""
    global _installed
    with _mu:
        _installed = _real


def installed() -> Clock:
    return _installed


def is_virtual() -> bool:
    """True while a non-default clock is installed — the cheap guard
    real-time-only paths (daemon loops, HTTP servers) check before
    assuming wall time."""
    return _installed is not _real


# -- module-level delegates (what the seamed call sites invoke) ---------


def monotonic() -> float:
    return _installed.monotonic()


def sleep(seconds: float) -> None:
    _installed.sleep(seconds)


def wait_on(cond: "threading.Condition",
            timeout: Optional[float] = None) -> bool:
    return _installed.wait_on(cond, timeout)


def wait_event(event: "threading.Event",
               timeout: Optional[float] = None) -> bool:
    return _installed.wait_event(event, timeout)


def call_later(delay: float, fn: Callable[..., None], *args: Any) -> Any:
    return _installed.call_later(delay, fn, *args)


def defer(fn: Callable[[], None], name: str = "raydp-clock-defer") -> None:
    _installed.defer(fn, name)
