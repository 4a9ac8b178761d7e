"""Per-process progress watchdog: who is stuck, where, since when.

The port's copy of ``raydp_tpu/telemetry/watchdog.py``; it leaves nothing
of it to a later slice.

The stall signal is **in-flight operation age**. Instrumented code
brackets its potentially-hanging regions with
:func:`inflight`::

    from raydp_tpu_torch.telemetry.watchdog import inflight

    with inflight("train/step", epoch=2, step=41):
        step()           # a wedge here is attributed to train/step

(`train/step`, `worker/task`, `spmd/func`, `spmd/dispatch`,
`ingest/chunk`, `ingest/device_put` and every RPC are bracketed out of
the box.) A background :class:`Watchdog` thread samples the tracker;
any component whose oldest in-flight op is older than
``RAYDP_TPU_WATCHDOG_STALL_S`` (default 60) is **stalled**: the
watchdog records a flight event, bumps the ``watchdog/stalls`` counter
(exported as ``raydp_stalls_total``), dumps one postmortem bundle with
all-thread stacks for the episode, and flips the process's
:func:`health` — which the worker heartbeat ships to the master
(``Cluster.health_report()``) and ``/healthz`` turns into a 503.
Recovery (the op finally finishing) clears the flag on the next check.

Brackets around regions that are *expected* to run long — a whole task
body, a scan-mode epoch, a first step that JIT-compiles, an RPC with
an explicit long deadline — pass ``stall_after_s`` to raise their own
threshold (it can only raise, never lower, the global one), so a
healthy 5-minute compile does not read as a wedge. The default for
such whole-body brackets is :func:`long_stall_s`
(``RAYDP_TPU_WATCHDOG_LONG_STALL_S``, default 900).

Env knobs::

    RAYDP_TPU_WATCHDOG=0            disable the background thread
    RAYDP_TPU_WATCHDOG_INTERVAL     check period, seconds (default 5)
    RAYDP_TPU_WATCHDOG_STALL_S      stall threshold, seconds (default 60)
    RAYDP_TPU_WATCHDOG_LONG_STALL_S threshold for whole-body brackets
                                    (task/epoch/compile; default 900)
    RAYDP_TPU_WATCHDOG_BUNDLE_COOLDOWN_S
                                    min seconds between postmortem
                                    bundles per component (default 600)

Everything is stdlib + O(#in-flight ops) per check; with no wedge the
cost is two dict ops per bracketed region.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Callable, Dict, Iterator, Optional

from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.utils.profiling import metrics

__all__ = [
    "WATCHDOG_ENV",
    "WATCHDOG_INTERVAL_ENV",
    "WATCHDOG_STALL_ENV",
    "WATCHDOG_LONG_STALL_ENV",
    "WATCHDOG_BUNDLE_COOLDOWN_ENV",
    "STALL_COUNTER",
    "ProgressTracker",
    "Watchdog",
    "tracker",
    "inflight",
    "ensure_started",
    "health",
    "long_stall_s",
]

WATCHDOG_ENV = "RAYDP_TPU_WATCHDOG"
WATCHDOG_INTERVAL_ENV = "RAYDP_TPU_WATCHDOG_INTERVAL"
WATCHDOG_STALL_ENV = "RAYDP_TPU_WATCHDOG_STALL_S"
WATCHDOG_LONG_STALL_ENV = "RAYDP_TPU_WATCHDOG_LONG_STALL_S"
WATCHDOG_BUNDLE_COOLDOWN_ENV = "RAYDP_TPU_WATCHDOG_BUNDLE_COOLDOWN_S"
STALL_COUNTER = "watchdog/stalls"

_DEFAULT_INTERVAL_S = 5.0
_DEFAULT_STALL_S = 60.0
_DEFAULT_LONG_STALL_S = 900.0
_DEFAULT_BUNDLE_COOLDOWN_S = 600.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ[name])
    except (KeyError, ValueError):
        return default


def long_stall_s() -> float:
    """Stall threshold for brackets around *expected-long* regions
    (whole task bodies, scan-mode epochs, first-step JIT compiles)."""
    return _env_float(WATCHDOG_LONG_STALL_ENV, _DEFAULT_LONG_STALL_S)


class ProgressTracker:
    """Registry of in-flight operations, keyed by an opaque token."""

    def __init__(self):
        self._mu = threading.Lock()
        self._seq = itertools.count(1)
        # token -> (component, attrs, start_mono, start_wall, tid,
        #           stall_after_s override or None)
        self._ops: Dict[int, tuple] = {}

    def begin(self, component: str,
              stall_after_s: Optional[float] = None, **attrs: Any) -> int:
        """``stall_after_s`` raises THIS op's stall threshold above the
        global one (never lowers it) — for regions that legitimately run
        long, like a whole task body or a first-step compile."""
        token = next(self._seq)
        op = (component, attrs, time.monotonic(), time.time(),
              threading.get_ident(), stall_after_s)
        with self._mu:
            self._ops[token] = op
        return token

    def end(self, token: int) -> None:
        with self._mu:
            self._ops.pop(token, None)

    @contextlib.contextmanager
    def inflight(self, component: str,
                 stall_after_s: Optional[float] = None,
                 **attrs: Any) -> Iterator[None]:
        token = self.begin(component, stall_after_s=stall_after_s, **attrs)
        try:
            yield
        finally:
            self.end(token)

    def snapshot(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """Per-component view of the OLDEST in-flight op (the stall
        candidate) plus the concurrent-op count."""
        if now is None:
            now = time.monotonic()
        with self._mu:
            ops = list(self._ops.values())
        out: Dict[str, Dict] = {}
        for component, attrs, start_mono, start_wall, tid, stall_s in ops:
            age = now - start_mono
            cur = out.get(component)
            if cur is None:
                out[component] = {
                    "age_s": age, "since_wall": start_wall,
                    "tid": tid, "attrs": dict(attrs), "count": 1,
                    "stall_after_s": stall_s,
                }
            else:
                cur["count"] += 1
                if age > cur["age_s"]:
                    cur.update(age_s=age, since_wall=start_wall,
                               tid=tid, attrs=dict(attrs),
                               stall_after_s=stall_s)
        return out


tracker = ProgressTracker()
inflight = tracker.inflight


class Watchdog:
    """Samples a :class:`ProgressTracker`, escalating new stalls."""

    def __init__(
        self,
        progress: Optional[ProgressTracker] = None,
        interval_s: Optional[float] = None,
        stall_after_s: Optional[float] = None,
        on_stall: Optional[Callable[[str, Dict], None]] = None,
        dump_bundles: bool = True,
        bundle_cooldown_s: Optional[float] = None,
    ):
        self.progress = progress if progress is not None else tracker
        self.interval_s = (
            interval_s if interval_s is not None
            else _env_float(WATCHDOG_INTERVAL_ENV, _DEFAULT_INTERVAL_S)
        )
        self.stall_after_s = (
            stall_after_s if stall_after_s is not None
            else _env_float(WATCHDOG_STALL_ENV, _DEFAULT_STALL_S)
        )
        self.on_stall = on_stall
        self.dump_bundles = dump_bundles
        self.bundle_cooldown_s = (
            bundle_cooldown_s if bundle_cooldown_s is not None
            else _env_float(WATCHDOG_BUNDLE_COOLDOWN_ENV,
                            _DEFAULT_BUNDLE_COOLDOWN_S)
        )
        self._mu = threading.Lock()
        self._stalled: Dict[str, Dict] = {}
        # component -> monotonic time of its last bundle dump. Survives
        # recovery on purpose: a flapping component (stall, recover,
        # stall again every few seconds) must not write a bundle per
        # flap and exhaust the postmortem volume.
        self._last_bundle: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="raydp-watchdog", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=2.0)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.check()
            except Exception:
                pass  # the watchdog must never take the process down

    # -- detection ------------------------------------------------------

    def check(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One detection pass; safe to call directly (tests, endpoints).
        Returns the resulting :meth:`health` dict."""
        snap = self.progress.snapshot(now)
        # A per-op stall_after_s override raises the threshold for that
        # component's oldest op, never lowers it below the global one.
        stalls = {
            c: info for c, info in snap.items()
            if info["age_s"] >= max(self.stall_after_s,
                                    info.get("stall_after_s") or 0.0)
        }
        with self._mu:
            fresh = {c: i for c, i in stalls.items() if c not in self._stalled}
            recovered = [c for c in self._stalled if c not in stalls]
            self._stalled = stalls
        for component in recovered:
            _flight.record("watchdog", "recovered", component=component)
        mono = time.monotonic()
        for component, info in fresh.items():
            metrics.counter_add(STALL_COUNTER)
            _flight.record(
                "watchdog", "stall", component=component,
                age_s=round(info["age_s"], 3), tid=info["tid"],
                **info["attrs"],
            )
            try:  # timeline correlation; never let telemetry stall us
                from raydp_tpu_torch.telemetry import events as _events

                _events.emit(
                    "sentinel/stall", component=component,
                    age_s=round(info["age_s"], 3),
                )
            except Exception:
                pass
            last = self._last_bundle.get(component)
            if self.dump_bundles and (
                last is None or mono - last >= self.bundle_cooldown_s
            ):
                self._last_bundle[component] = mono
                _flight.dump_bundle(
                    f"watchdog stall: {component} "
                    f"(no progress for {info['age_s']:.1f}s)"
                )
            if self.on_stall is not None:
                try:
                    self.on_stall(component, info)
                except Exception:
                    pass
        return self.health()

    def health(self) -> Dict[str, Any]:
        """Health as of the last :meth:`check`."""
        with self._mu:
            stalls = {
                c: {"age_s": round(i["age_s"], 3),
                    "since_wall": i["since_wall"],
                    "count": i["count"], "attrs": i["attrs"]}
                for c, i in self._stalled.items()
            }
        return {
            "healthy": not stalls,
            "stalls": stalls,
            "pid": os.getpid(),
            "stall_after_s": self.stall_after_s,
        }


# -- process singleton --------------------------------------------------

_watchdog: Optional[Watchdog] = None
_start_mu = threading.Lock()


def ensure_started() -> Optional[Watchdog]:
    """Start the process-wide watchdog thread (idempotent). Returns
    None when disabled via ``RAYDP_TPU_WATCHDOG=0``."""
    global _watchdog
    if os.environ.get(WATCHDOG_ENV, "1") in ("0", "false", "no", "off"):
        return None
    with _start_mu:
        if _watchdog is None:
            _watchdog = Watchdog()
            _watchdog.start()
        return _watchdog


def health() -> Dict[str, Any]:
    """This process's health. Uses the running watchdog's last check
    when one is started; otherwise evaluates the tracker live against
    the configured threshold (no side effects either way)."""
    wd = _watchdog
    if wd is not None:
        return wd.health()
    threshold = _env_float(WATCHDOG_STALL_ENV, _DEFAULT_STALL_S)
    snap = tracker.snapshot()
    stalls = {
        c: {"age_s": round(i["age_s"], 3), "since_wall": i["since_wall"],
            "count": i["count"], "attrs": i["attrs"]}
        for c, i in snap.items()
        if i["age_s"] >= max(threshold, i.get("stall_after_s") or 0.0)
    }
    return {
        "healthy": not stalls,
        "stalls": stalls,
        "pid": os.getpid(),
        "stall_after_s": threshold,
    }
