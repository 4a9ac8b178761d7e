"""Process-local fault hooks and preemption state: the serve and RPC subset.

The counterpart of ``raydp_tpu/fault/inject.py`` for what the serve plane
runs: :func:`on_serve_request` (``serve_kill``, ``latency``),
:func:`on_rpc` (``rpc_delay``, ``rpc_drop``) and the preemption drain
(:func:`request_preemption`, :func:`mark_drained`,
:func:`install_sigterm_drain`). All hooks are cheap no-ops unless
``RAYDP_TPU_FAULT_PLAN`` is set. The parsed plan is cached per plan
string; each armed clause fires at most once per process.

Preemption is a process-wide flag: a real SIGTERM (via
:func:`install_sigterm_drain`) sets it and arms a grace-deadline
force-exit timer; the replica drains its in-flight work and calls
:func:`mark_drained`, which cancels the timer.
"""
from __future__ import annotations

import os
import signal
import sys
import threading
import time
from typing import List, Optional

from raydp_tpu_torch.fault.plan import (
    FAULT_PLAN_ENV,
    FAULT_SEED_ENV,
    FaultClause,
    parse_plan,
)
from raydp_tpu_torch.utils import clock as _clock

PREEMPT_GRACE_ENV = "RAYDP_TPU_PREEMPT_GRACE_S"

_DEFAULT_GRACE_S = 30.0
_PREEMPT_EXIT_CODE = 143  # 128 + SIGTERM, what an undrained preemption looks like


class _State:
    def __init__(self) -> None:
        self.plan_text: Optional[str] = None
        self.clauses: List[FaultClause] = []
        self.rpc_counts: dict = {}
        self.preempt = threading.Event()
        self.drained = threading.Event()
        self.grace_timer: Optional[threading.Timer] = None
        self.prev_sigterm = None
        self.sigterm_installed = False


_lock = threading.Lock()
_state = _State()


def _clauses() -> List[FaultClause]:
    text = os.environ.get(FAULT_PLAN_ENV)
    if not text:
        return []
    with _lock:
        if _state.plan_text != text:
            try:
                seed = int(os.environ.get(FAULT_SEED_ENV, "0"))
            except ValueError:
                seed = 0
            _state.clauses = parse_plan(text, seed=seed)
            _state.plan_text = text
            _state.rpc_counts = {}
        return _state.clauses


def active() -> bool:
    """True when a fault plan is configured for this process."""
    return bool(os.environ.get(FAULT_PLAN_ENV))


def plan_clauses() -> List[FaultClause]:
    """The active plan's parsed clauses (shared and mutable: marking one
    ``fired`` consumes it process-wide)."""
    return _clauses()


def _die(clause: FaultClause, what: str) -> None:
    print(
        f"raydp-fault: injected kill: {what} (exit {clause.code})",
        file=sys.stderr,
        flush=True,
    )
    os._exit(clause.code)


def ambient_replica() -> Optional[int]:
    """The serving replica index of this process, if launched as one."""
    raw = os.environ.get("RAYDP_SERVE_REPLICA")
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def _ambient_incarnation() -> int:
    """Restart count of this replica's lineage (0 = first spawn)."""
    try:
        return int(os.environ.get("RAYDP_SERVE_INCARNATION", "0"))
    except ValueError:
        return 0


def on_serve_request(
    request_index: int, replica: Optional[int] = None
) -> None:
    """Hook when a serving replica begins executing its
    ``request_index``-th request (0-based, per process).

    Fires ``serve_kill`` (hard exit, first incarnation of the lineage
    only, so a respawned replica is not killed again) and ``latency``
    (an in-place stall through the clock seam).
    """
    clauses = _clauses()
    if not clauses:
        return
    if replica is None:
        replica = ambient_replica()
    for c in clauses:
        if not c.armed or c.fired:
            continue
        if not c.matches_replica(replica):
            continue
        if c.kind == "serve_kill" and c.request == request_index:
            if _ambient_incarnation() > 0:
                continue
            c.fired = True
            _die(c, f"replica {replica} at request {request_index}")
        elif c.kind == "latency" and c.nth == request_index:
            c.fired = True
            _clock.sleep(c.delay)


def on_rpc(qualified_method: str) -> Optional[str]:
    """Hook before an RPC client sends ``Service.Method``.

    Sleeps in place for a matching ``rpc_delay`` clause. Returns
    ``"drop"`` when a matching ``rpc_drop`` clause fires (the caller
    raises an unavailable-peer error instead of sending); ``None``
    otherwise.
    """
    clauses = _clauses()
    if not clauses:
        return None
    with _lock:
        n = _state.rpc_counts.get(qualified_method, 0)
        _state.rpc_counts[qualified_method] = n + 1
    verdict = None
    for c in clauses:
        if not c.armed or c.fired or c.nth != n or not c.matches_method(qualified_method):
            continue
        if c.kind == "rpc_delay":
            c.fired = True
            time.sleep(c.delay)
        elif c.kind == "rpc_drop":
            c.fired = True
            verdict = "drop"
    return verdict


def preemption_requested() -> bool:
    """True once a preemption notice (real or injected) has landed."""
    return _state.preempt.is_set()


def request_preemption(grace_s: Optional[float] = None) -> None:
    """Deliver a preemption notice to this process.

    Sets the drain flag and arms a force-exit timer: if the process has
    not called :func:`mark_drained` within the grace window, it
    hard-exits with code 143. ``grace_s <= 0`` disables the deadline.
    """
    if grace_s is None:
        raw = os.environ.get(PREEMPT_GRACE_ENV)
        try:
            grace_s = float(raw) if raw else _DEFAULT_GRACE_S
        except ValueError:
            grace_s = _DEFAULT_GRACE_S
    with _lock:
        first = not _state.preempt.is_set()
        _state.preempt.set()
        if first and grace_s > 0:
            def _force_exit() -> None:
                if _state.drained.is_set():
                    return
                print(
                    f"raydp-fault: preemption grace of {grace_s:.1f}s expired "
                    "before drain; force-exiting",
                    file=sys.stderr,
                    flush=True,
                )
                os._exit(_PREEMPT_EXIT_CODE)

            t = threading.Timer(grace_s, _force_exit)
            t.daemon = True
            t.start()
            _state.grace_timer = t
    if first:
        print(
            f"raydp-fault: preemption notice (grace {grace_s:.1f}s); "
            "draining in-flight work",
            file=sys.stderr,
            flush=True,
        )


def mark_drained() -> None:
    """Cancel the preemption force-exit deadline; drain completed."""
    _state.drained.set()
    with _lock:
        if _state.grace_timer is not None:
            _state.grace_timer.cancel()
            _state.grace_timer = None


def install_sigterm_drain() -> None:
    """Route SIGTERM into the preemption drain path. No-op off the main
    thread."""
    def _handler(signum, frame):  # noqa: ANN001 - signal signature
        request_preemption()

    try:
        with _lock:
            if _state.sigterm_installed:
                return
            _state.prev_sigterm = signal.signal(signal.SIGTERM, _handler)
            _state.sigterm_installed = True
    except ValueError:
        # Not the main thread; preemption notices must then be injected.
        pass


def reset_for_tests() -> None:
    """Clear all process-local fault state (plan cache, preemption)."""
    with _lock:
        _state.plan_text = None
        _state.clauses = []
        _state.rpc_counts = {}
        _state.preempt = threading.Event()
        _state.drained = threading.Event()
        if _state.grace_timer is not None:
            _state.grace_timer.cancel()
            _state.grace_timer = None
        if _state.sigterm_installed and _state.prev_sigterm is not None:
            try:
                signal.signal(signal.SIGTERM, _state.prev_sigterm)
            except ValueError:
                pass
        _state.sigterm_installed = False
        _state.prev_sigterm = None
