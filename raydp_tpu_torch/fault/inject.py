"""Process-local fault hooks and preemption state.

The counterpart of ``raydp_tpu/fault/inject.py``: the training hooks
:func:`on_train_step` (``kill rank=…,step=K``, ``preempt``),
:func:`on_task` (``kill worker=…,task=K``) and :func:`on_heartbeat`
(``hb_stall``), the serve hook :func:`on_serve_request`
(``serve_kill``, ``latency``), :func:`on_rpc` (``rpc_delay``,
``rpc_drop``) and the preemption drain (:func:`request_preemption`,
:func:`mark_drained`, :func:`install_sigterm_drain`). All hooks are
cheap no-ops unless ``RAYDP_TPU_FAULT_PLAN`` is set. The parsed plan is
cached per plan string; each armed clause fires at most once per
process.

Preemption is a process-wide flag: the injected ``preempt`` clause, a
real SIGTERM (via :func:`install_sigterm_drain`) and a gang rank's
``Preempt`` RPC all set it and arm a grace-deadline force-exit timer.
The training loop drains at a step boundary (an emergency checkpoint,
then :class:`PreemptionError`); a serving replica drains its in-flight
work. Either calls :func:`mark_drained`, which cancels the timer.

A ``job=`` clause fires only where the accounting plane's ambient job
(a thread's scope, the process's job, ``RAYDP_TPU_JOB`` adopted by a
worker main) matches it by id or name (``raydp_tpu/fault/inject.py:
81-97``). Every clause that fires lands on the event timeline as
``fault/clause`` (written through, so it survives a clause that kills
the process). :func:`on_spawn` (``spawn_fail``, ``spawn_delay``) runs
before each host-spawn attempt of the autoscaler
(``control/autoscaler.py``), which backs off and retries on
:class:`SpawnFaultError`.

SIGTERM: :func:`install_sigterm_drain` replaces the handler installed
before it (a rank's flight recorder) and keeps it. A SIGTERM sets the
drain flag; once the process has drained and stops,
:func:`reraise_drained_sigterm` hands the signal to the kept handler,
which writes the postmortem bundle and dies by the signal.
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
# The gang rank's index in its environment (``spmd/job.py``'s
# ``ENV_RANK``; this module stays free of the gang's imports).
ENV_RANK = "RAYDP_SPMD_RANK"

_DEFAULT_GRACE_S = 30.0
_PREEMPT_EXIT_CODE = 143  # 128 + SIGTERM, what an undrained preemption looks like


class PreemptionError(RuntimeError):
    """Raised by a training loop after draining a preemption notice.

    ``checkpoint_path`` is the emergency checkpoint written during the
    drain, or ``None`` if no checkpoint directory was configured.
    """

    def __init__(self, message: str, checkpoint_path: Optional[str] = None):
        super().__init__(message)
        self.checkpoint_path = checkpoint_path


class SpawnFaultError(RuntimeError):
    """Raised by :func:`on_spawn` for an armed ``spawn_fail`` clause.

    The autoscaler's provisioner boundary catches it and applies its
    backoff-and-retry budget, as it would a real launcher failure.
    """


class _State:
    def __init__(self) -> None:
        self.plan_text: Optional[str] = None
        self.clauses: List[FaultClause] = []
        self.rpc_counts: dict = {}
        self.spawn_count = 0
        self.preempt = threading.Event()
        self.drained = threading.Event()
        self.grace_timer: Optional[threading.Timer] = None
        self.prev_sigterm = None
        self.sigterm_installed = False
        self.sigterm_received = False


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
            _state.spawn_count = 0
        return _state.clauses


def active() -> bool:
    """True when a fault plan is configured for this process."""
    return bool(os.environ.get(FAULT_PLAN_ENV))


def plan_clauses() -> List[FaultClause]:
    """The active plan's parsed clauses (shared and mutable: marking one
    ``fired`` consumes it process-wide)."""
    return _clauses()


def _ambient_job() -> tuple:
    """``(job_id, name)`` of the job this process's work is billed to
    (the accounting plane's ambient job), or ``(None, None)``."""
    try:
        from raydp_tpu_torch.telemetry import accounting as _acct

        ctx = _acct.current_job()
        if ctx is None:
            return (None, None)
        return (ctx.job_id, ctx.name)
    except Exception:
        return (None, None)


def _emit_clause(clause: FaultClause, what: str) -> None:
    """A clause that fired, on the event timeline next to the churn it
    causes (written through: durable even when the clause kills this
    process)."""
    try:
        from raydp_tpu_torch.telemetry import events as _events

        # The attribute must not be named "kind": emit()'s first
        # positional parameter.
        _events.emit("fault/clause", clause=clause.kind, what=what)
    except Exception:
        pass


def _die(clause: FaultClause, what: str) -> None:
    _emit_clause(clause, what)
    print(
        f"raydp-fault: injected kill: {what} (exit {clause.code})",
        file=sys.stderr,
        flush=True,
    )
    os._exit(clause.code)


def ambient_rank() -> Optional[int]:
    """The SPMD rank of this process, if launched as a gang member."""
    raw = os.environ.get(ENV_RANK)
    if raw is None:
        return None
    try:
        return int(raw)
    except ValueError:
        return None


def on_train_step(step: int, rank: Optional[int] = None) -> bool:
    """Hook at each estimator train-step boundary.

    ``step`` is 1-based (the step that just completed). ``rank``
    defaults to the ambient SPMD rank. A ``kill`` clause dies with its
    code; a ``preempt`` clause delivers a notice
    (:func:`request_preemption` with the clause's grace). Returns True
    when a ``preempt`` clause without ``rank=`` fired: every rank of a
    gang evaluates the same plan at the same step, so every rank got
    this notice at this step, and the ranks may drain here without
    agreeing first.
    """
    clauses = _clauses()
    if not clauses:
        return False
    if rank is None:
        rank = ambient_rank()
    job_id, job_name = _ambient_job()
    gang_wide = False
    for c in clauses:
        if not c.armed or c.fired or not c.matches_job(job_id, job_name):
            continue
        if c.kind == "kill" and c.step is not None and c.step == step:
            if c.matches_rank(rank):
                c.fired = True
                _die(c, f"rank {rank} at train step {step}")
        elif c.kind == "preempt" and c.step == step and c.matches_rank(rank):
            c.fired = True
            gang_wide = gang_wide or c.rank is None
            _emit_clause(c, f"rank {rank} preempted at train step {step}")
            request_preemption(grace_s=c.grace)
    return gang_wide


def on_task(worker_id: str, task_index: int) -> None:
    """Hook when an ETL worker begins its ``task_index``-th task
    (0-based, counted per process)."""
    clauses = _clauses()
    if not clauses:
        return
    job_id, job_name = _ambient_job()
    for c in clauses:
        if not c.armed or c.fired or not c.matches_job(job_id, job_name):
            continue
        if c.kind == "kill" and c.task is not None and c.task == task_index:
            if c.matches_worker(worker_id):
                c.fired = True
                _die(c, f"worker {worker_id} at task {task_index}")


def on_heartbeat(beat_index: int, rank: Optional[int] = None,
                 worker: Optional[str] = None) -> bool:
    """Hook per heartbeat; returns True when this beat must be skipped
    (an ``hb_stall`` window covers ``beat_index``)."""
    clauses = _clauses()
    if not clauses:
        return False
    if rank is None and worker is None:
        rank = ambient_rank()
    for c in clauses:
        if c.kind != "hb_stall" or not c.armed:
            continue
        if c.rank is not None and not c.matches_rank(rank):
            continue
        if c.worker is not None and not c.matches_worker(worker):
            continue
        if c.after <= beat_index < c.after + c.beats:
            return True
    return False


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
            _emit_clause(c, f"replica {replica} stalled {c.delay}s at "
                            f"request {request_index}")
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
            _emit_clause(c, f"delayed {qualified_method} by {c.delay}s")
            time.sleep(c.delay)
        elif c.kind == "rpc_drop":
            c.fired = True
            _emit_clause(c, f"dropped {qualified_method}")
            verdict = "drop"
    return verdict


def on_spawn() -> None:
    """Hook before each host-spawn attempt at the provisioner boundary.

    Counts attempts per process (0-based). A matching ``spawn_delay``
    clause sleeps in place through the clock seam (a hung provisioning
    call; virtual time under the simulator); a matching ``spawn_fail``
    clause raises :class:`SpawnFaultError`.
    """
    clauses = _clauses()
    if not clauses:
        return
    with _lock:
        n = _state.spawn_count
        _state.spawn_count = n + 1
    for c in clauses:
        if not c.armed or c.fired or c.nth != n:
            continue
        if c.kind == "spawn_delay":
            c.fired = True
            _emit_clause(c, f"delayed spawn attempt {n} by {c.delay}s")
            _clock.sleep(c.delay)
        elif c.kind == "spawn_fail":
            c.fired = True
            _emit_clause(c, f"failed spawn attempt {n}")
            raise SpawnFaultError(f"injected spawn failure (attempt {n})")


def preemption_requested() -> bool:
    """True once a preemption notice (real or injected) has landed."""
    return _state.preempt.is_set()


def request_preemption(grace_s: Optional[float] = None) -> None:
    """Deliver a preemption notice to this process.

    Sets the drain flag and arms a force-exit timer: if the process has
    not called :func:`mark_drained` within the grace window, it
    hard-exits with code 143, as an undrained preemption does.
    ``grace_s <= 0`` disables the deadline. ``grace_s`` None reads
    ``RAYDP_TPU_PREEMPT_GRACE_S`` (default 30 s).
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
    """Route SIGTERM into the preemption drain path, keeping the handler
    it replaces for :func:`reraise_drained_sigterm`. Install it after
    the flight recorder. No-op off the main thread."""
    def _handler(signum, frame):  # noqa: ANN001 - signal signature
        # Only flag-setting here: the frame interrupted may hold locks.
        _state.sigterm_received = True
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


def reraise_drained_sigterm() -> None:
    """After a SIGTERM was drained, hand it to the handler the drain
    replaced (a flight recorder's writes a postmortem bundle, then dies
    by the signal; the default just dies by it). A no-op when no SIGTERM
    arrived or the drain is not installed. Call it once the process has
    reported its drain and is about to exit."""
    with _lock:
        if not (_state.sigterm_received and _state.sigterm_installed):
            return
        prev = _state.prev_sigterm
        _state.sigterm_installed = False
    try:
        signal.signal(signal.SIGTERM,
                      prev if prev is not None else signal.SIG_DFL)
    except ValueError:
        return  # not the main thread
    os.kill(os.getpid(), signal.SIGTERM)


def reset_for_tests() -> None:
    """Clear all process-local fault state (plan cache, preemption)."""
    with _lock:
        _state.plan_text = None
        _state.clauses = []
        _state.rpc_counts = {}
        _state.spawn_count = 0
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
        _state.sigterm_received = False
        _state.prev_sigterm = None
