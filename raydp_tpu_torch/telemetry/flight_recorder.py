"""Crash flight recorder: bounded event ring + postmortem bundles.

The port's copy of ``raydp_tpu/telemetry/flight_recorder.py``.

In a rank the SIGTERM drain (:func:`raydp_tpu_torch.fault.install_sigterm_drain`)
is installed after this recorder and chains to it: the rank drains to
an emergency checkpoint first, then hands the signal on here (a bundle,
then death by the signal).

Every process keeps a small ring of structured **flight events** —
state transitions, RPC send/recv, step boundaries, loader progress,
warnings/errors — cheap enough to leave on unconditionally (a deque
append under a lock). When the process dies badly, the ring is the
black box: :func:`dump_bundle` writes a single JSON **postmortem
bundle** containing the last-N events, an all-thread stack dump
(``sys._current_frames()``), the local metrics snapshot, and the
ambient trace context, so "what was it doing when it died" survives
the process.

:func:`install` arms the dump triggers:

* unhandled exceptions (``sys.excepthook`` + ``threading.excepthook``,
  both chained to the previous hooks);
* fatal signals — ``faulthandler.enable()`` against a
  ``crash-<pid>.txt`` sidecar for SIGSEGV/SIGABRT-class deaths that
  never reach Python, plus a SIGTERM handler (``signals=True`` only)
  that dumps a bundle and then re-raises the default disposition so a
  ``kubectl delete`` / launcher kill still terminates the process.
  The handler runs on the main thread, possibly interrupting a frame
  that holds the ring or metrics locks, so the whole SIGTERM path is
  **lock-free**: the ring is snapshotted with a try-acquire (CPython
  deque ops are atomic, the lock only makes snapshots consistent) and
  the metrics snapshot — whose registry lock we cannot try-acquire —
  is skipped;
* watchdog escalation (:mod:`~raydp_tpu_torch.telemetry.watchdog` calls
  :func:`dump_bundle` on a new stall episode, rate-limited per
  component).

Bundles land in ``RAYDP_TPU_POSTMORTEM_DIR`` (default:
``<telemetry_dir>/postmortem``; disabled when neither is set) as
``postmortem-<pid>-<seq>.json``; the directory is capped at
``RAYDP_TPU_POSTMORTEM_KEEP`` bundles (default 20, oldest deleted
first) so a long-running pod cannot fill its node disk. ``python -m
raydp_tpu_torch.telemetry.flight_recorder [DIR]`` prints the newest bundle's
reason and event tail — scripts/verify.sh ships it on CI failures.
"""
from __future__ import annotations

import collections
import faulthandler
import itertools
import json
import os
import signal
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry.export import telemetry_dir

__all__ = [
    "POSTMORTEM_DIR_ENV",
    "POSTMORTEM_KEEP_ENV",
    "FLIGHT_EVENTS_ENV",
    "FlightRecorder",
    "recorder",
    "record",
    "postmortem_dir",
    "all_thread_stacks",
    "dump_bundle",
    "install",
    "latest_bundle",
    "read_bundle",
]

POSTMORTEM_DIR_ENV = "RAYDP_TPU_POSTMORTEM_DIR"
POSTMORTEM_KEEP_ENV = "RAYDP_TPU_POSTMORTEM_KEEP"
FLIGHT_EVENTS_ENV = "RAYDP_TPU_FLIGHT_EVENTS"
BUNDLE_SCHEMA = "raydp-postmortem-v1"

_DEFAULT_CAPACITY = 512
_DEFAULT_KEEP = 20


def _capacity() -> int:
    try:
        return max(16, int(os.environ.get(FLIGHT_EVENTS_ENV, "")))
    except ValueError:
        return _DEFAULT_CAPACITY


def _keep() -> int:
    try:
        return max(1, int(os.environ.get(POSTMORTEM_KEEP_ENV, "")))
    except ValueError:
        return _DEFAULT_KEEP


class FlightRecorder:
    """Bounded ring of structured events (oldest evicted silently —
    unlike spans, flight events are *expected* to be overwritten; only
    the tail near death matters)."""

    def __init__(self, capacity: Optional[int] = None):
        self._ring: collections.deque = collections.deque(
            maxlen=capacity or _capacity()
        )
        self._mu = threading.Lock()

    @staticmethod
    def _event(kind: str, name: str, attrs: Dict[str, Any]) -> Dict[str, Any]:
        evt = {
            "wall": time.time(),
            "mono": time.monotonic(),
            "kind": kind,
            "name": name,
            "tid": threading.get_ident(),
        }
        if attrs:
            evt["attrs"] = attrs
        return evt

    def record(self, kind: str, name: str, **attrs: Any) -> None:
        """Append one event. ``kind`` is a coarse category (``state``,
        ``rpc``, ``train``, ``loader``, ``watchdog``, ``log``,
        ``error``); ``name`` identifies the event within it."""
        evt = self._event(kind, name, attrs)
        with self._mu:
            self._ring.append(evt)

    def record_nowait(self, kind: str, name: str, **attrs: Any) -> None:
        """Signal-safe append: never blocks on the ring lock. A signal
        handler can interrupt the very frame that holds ``_mu``; deque
        appends are atomic in CPython, so when the try-acquire fails we
        append without the lock rather than deadlock."""
        evt = self._event(kind, name, attrs)
        if self._mu.acquire(blocking=False):
            try:
                self._ring.append(evt)
            finally:
                self._mu.release()
        else:
            self._ring.append(evt)

    def tail(self, n: Optional[int] = None,
             blocking: bool = True) -> List[Dict[str, Any]]:
        """Snapshot of the ring, oldest first. ``blocking=False`` is the
        signal-safe variant: if the lock is unavailable (possibly held
        by the interrupted frame itself) the ring is copied without it,
        retrying on a concurrent-mutation race."""
        if self._mu.acquire(blocking=blocking):
            try:
                events = list(self._ring)
            finally:
                self._mu.release()
        else:
            events = []
            for _ in range(3):
                try:
                    events = list(self._ring)
                    break
                except RuntimeError:  # deque mutated mid-copy
                    continue
        return events if n is None else events[-n:]

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()

    def __len__(self) -> int:
        with self._mu:
            return len(self._ring)


recorder = FlightRecorder()
record = recorder.record

_install_mu = threading.Lock()
_installed_component: Optional[str] = None
_fault_file = None  # keep the fd alive; faulthandler writes to it on crash
# itertools.count: atomic under the GIL, so bundle sequence numbers
# need no lock — dump_bundle must stay callable from signal handlers.
_bundle_seq = itertools.count(1)
_prev_excepthook = None
_prev_threading_hook = None


def postmortem_dir() -> Optional[str]:
    """Bundle directory: RAYDP_TPU_POSTMORTEM_DIR, else
    ``<telemetry_dir>/postmortem``, else None (disabled)."""
    explicit = os.environ.get(POSTMORTEM_DIR_ENV)
    if explicit:
        return explicit
    base = telemetry_dir()
    return os.path.join(base, "postmortem") if base else None


def all_thread_stacks() -> Dict[str, str]:
    """Formatted stack per live thread, keyed ``"<tid> <name>"``."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks: Dict[str, str] = {}
    for tid, frame in sys._current_frames().items():
        label = f"{tid} {names.get(tid, '?')}"
        stacks[label] = "".join(traceback.format_stack(frame))
    return stacks


def _metrics_snapshot() -> Dict[str, Any]:
    try:
        from raydp_tpu_torch.utils.profiling import metrics

        return metrics.snapshot()
    except Exception:
        return {}


def _prune_bundles(directory: str, keep: int) -> None:
    """Delete the oldest ``postmortem-*.json`` beyond ``keep`` — the
    disk-bound on flapping dumpers. Lock-free and per-file best-effort
    (several processes may prune one shared directory concurrently)."""
    try:
        bundles = [
            os.path.join(directory, f)
            for f in os.listdir(directory)
            if f.startswith("postmortem-") and f.endswith(".json")
        ]
        if len(bundles) <= keep:
            return
        bundles.sort(key=_bundle_age_key)
        for path in bundles[:-keep]:
            try:
                os.unlink(path)
            except OSError:
                pass
    except OSError:
        pass


def _bundle_age_key(path: str) -> tuple:
    # mtime first; the numeric <seq> breaks same-mtime ties (bundles
    # written back-to-back by one process) so "oldest" is well-defined.
    name = os.path.basename(path)
    try:
        seq = int(name.rsplit("-", 1)[1].split(".", 1)[0])
    except (IndexError, ValueError):
        seq = 0
    try:
        mtime = os.path.getmtime(path)
    except OSError:
        mtime = 0.0
    return (mtime, seq)


def dump_bundle(reason: str, *, exc: Optional[BaseException] = None,
                directory: Optional[str] = None,
                signal_safe: bool = False) -> Optional[str]:
    """Write a postmortem bundle; returns its path (None when no bundle
    directory is configured). Never raises — this runs from excepthooks
    and signal handlers, where a second failure would mask the first.

    ``signal_safe=True`` (the SIGTERM handler) must not block on any
    non-reentrant lock the interrupted frame may hold: the ring is
    snapshotted with a try-acquire and the metrics snapshot (registry
    lock) is skipped.
    """
    try:
        directory = directory or postmortem_dir()
        if not directory:
            return None
        from raydp_tpu_torch.telemetry import propagation as _prop

        ctx = _prop.current_context()
        bundle: Dict[str, Any] = {
            "schema": BUNDLE_SCHEMA,
            "reason": reason,
            "component": _installed_component,
            "wall_time": time.time(),
            "pid": os.getpid(),
            "argv": list(sys.argv),
            "traceparent": _prop.to_traceparent(ctx) if ctx else None,
            # raydp: ignore[R2] — blocking=False on the signal path
            "events": recorder.tail(blocking=not signal_safe),
            "stacks": all_thread_stacks(),
            # raydp: ignore[R2] — snapshot skipped when signal_safe
            "metrics": {} if signal_safe else _metrics_snapshot(),
        }
        if exc is not None:
            bundle["exception"] = "".join(
                traceback.format_exception(type(exc), exc, exc.__traceback__)
            )
        path = os.path.join(
            directory, f"postmortem-{os.getpid()}-{next(_bundle_seq)}.json"
        )
        os.makedirs(directory, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(bundle, f, default=str)
        os.replace(tmp, path)
        _prune_bundles(directory, _keep())
        return path
    except Exception:
        return None


def _excepthook(exc_type, exc, tb):
    record("error", "unhandled", type=getattr(exc_type, "__name__", "?"),
           message=str(exc)[:200])
    dump_bundle("unhandled exception", exc=exc)
    if _prev_excepthook is not None:
        _prev_excepthook(exc_type, exc, tb)


def _threading_hook(args):
    exc = args.exc_value
    record("error", "thread-unhandled",
           thread=getattr(args.thread, "name", "?"),
           type=getattr(args.exc_type, "__name__", "?"),
           message=str(exc)[:200])
    dump_bundle(
        f"unhandled exception in thread {getattr(args.thread, 'name', '?')}",
        exc=exc,
    )
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def _sigterm_handler(signum, frame):
    # Runs on the main thread and may interrupt a frame that holds the
    # ring/metrics locks — everything here must be non-blocking, or the
    # process wedges inside the handler until SIGKILL and loses both
    # the bundle and its termination grace period.
    recorder.record_nowait("state", "sigterm")
    dump_bundle("SIGTERM", signal_safe=True)
    # Restore the default disposition and re-deliver so the sender's
    # kill semantics (exit status, process-group teardown) still hold.
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    os.kill(os.getpid(), signal.SIGTERM)


def install(component: str, signals: bool = True) -> None:
    """Arm the crash triggers for this process. Idempotent.

    ``component`` labels the bundles (``driver``, ``worker``,
    ``spmd-worker``…). ``signals=False`` skips the SIGTERM handler —
    the driver runs inside a user program whose signal handling is not
    ours to hijack; excepthooks and faulthandler are still armed.
    """
    global _installed_component, _fault_file
    global _prev_excepthook, _prev_threading_hook
    with _install_mu:
        if _installed_component is not None:
            return
        _installed_component = component
    record("state", "flight-recorder-armed", component=component,
           signals=signals)
    _prev_excepthook = sys.excepthook
    sys.excepthook = _excepthook
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _threading_hook
    directory = postmortem_dir()
    if directory:
        try:
            os.makedirs(directory, exist_ok=True)
            _fault_file = open(
                os.path.join(directory, f"crash-{os.getpid()}.txt"), "w"
            )
            faulthandler.enable(file=_fault_file)
        except OSError:
            _fault_file = None
    if signals:
        try:
            signal.signal(signal.SIGTERM, _sigterm_handler)
        except (ValueError, OSError):
            pass  # not the main thread / restricted environment


def installed_component() -> Optional[str]:
    return _installed_component


# -- bundle readers ----------------------------------------------------


def read_bundle(path: str) -> Dict[str, Any]:
    with open(path, "r", encoding="utf-8") as f:
        return json.load(f)


def latest_bundle(directory: Optional[str] = None) -> Optional[str]:
    """Path of the newest bundle under ``directory`` (default: the
    configured postmortem dir), or None."""
    directory = directory or postmortem_dir()
    if not directory or not os.path.isdir(directory):
        return None
    bundles = [
        os.path.join(directory, f)
        for f in os.listdir(directory)
        if f.startswith("postmortem-") and f.endswith(".json")
    ]
    return max(bundles, key=os.path.getmtime) if bundles else None


def main(argv: Optional[List[str]] = None) -> int:
    """CLI: print the newest bundle's reason + event tail (CI black box).

    ``python -m raydp_tpu_torch.telemetry.flight_recorder [DIR] [--events N]``
    """
    import argparse

    parser = argparse.ArgumentParser(
        description="Inspect the newest raydp_tpu postmortem bundle."
    )
    parser.add_argument("directory", nargs="?", default=None)
    parser.add_argument("--events", type=int, default=20,
                        help="event-tail length to print (default 20)")
    args = parser.parse_args(argv)
    path = latest_bundle(args.directory)
    if path is None:
        print("no postmortem bundles found")
        return 0
    bundle = read_bundle(path)
    print(f"postmortem bundle: {path}")
    print(f"  reason:    {bundle.get('reason')}")
    print(f"  component: {bundle.get('component')}  "
          f"pid: {bundle.get('pid')}")
    events = bundle.get("events") or []
    print(f"  last {min(args.events, len(events))} of "
          f"{len(events)} flight events:")
    for evt in events[-args.events:]:
        attrs = evt.get("attrs") or {}
        extra = " ".join(f"{k}={v}" for k, v in attrs.items())
        print(f"    {evt.get('wall', 0):.3f} [{evt.get('kind')}] "
              f"{evt.get('name')} {extra}".rstrip())
    stacks = bundle.get("stacks") or {}
    print(f"  threads captured: {len(stacks)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
