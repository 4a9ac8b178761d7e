"""Deterministic fault injection and preemption notices.

The counterpart of ``raydp_tpu/fault/``. A seeded, env-driven plan
(``RAYDP_TPU_FAULT_PLAN``, the same grammar in both packages) says which
rank or worker dies at which step or task, which rank is preempted,
which heartbeats are skipped, which replica dies or stalls at which
request, which RPC is delayed or dropped, or which host spawn fails.
Hooks (all no-ops when no plan is set):

* :func:`on_train_step`: the estimator's step boundary (``kill`` /
  ``preempt``);
* :func:`on_task`: an ETL worker's task start (``kill``);
* :func:`on_heartbeat`: a rank's or worker's heartbeat loop
  (``hb_stall``);
* :func:`on_serve_request`: a serving replica's request boundary
  (``serve_kill`` / ``latency``);
* :func:`on_rpc`: an RPC client send (``rpc_delay`` / ``rpc_drop``).
* :func:`on_spawn`: the autoscaler's host-spawn attempt
  (``spawn_fail`` / ``spawn_delay``).

Preemption notices are independent of the plan: a real SIGTERM (through
:func:`install_sigterm_drain`) or a gang rank's ``Preempt`` RPC lands in
the same :func:`preemption_requested` flag as the injected ``preempt``
clause, so the estimator drains to an emergency checkpoint and raises
:class:`PreemptionError` the same way for all of them.
"""
from raydp_tpu_torch.fault.inject import (
    PREEMPT_GRACE_ENV,
    PreemptionError,
    SpawnFaultError,
    active,
    ambient_rank,
    ambient_replica,
    install_sigterm_drain,
    mark_drained,
    on_heartbeat,
    on_rpc,
    on_serve_request,
    on_spawn,
    on_task,
    on_train_step,
    plan_clauses,
    preemption_requested,
    reraise_drained_sigterm,
    request_preemption,
    reset_for_tests,
)
from raydp_tpu_torch.fault.plan import (
    FAULT_PLAN_ENV,
    FAULT_SEED_ENV,
    FaultClause,
    FaultPlanError,
    parse_plan,
)

__all__ = [
    "FAULT_PLAN_ENV",
    "FAULT_SEED_ENV",
    "PREEMPT_GRACE_ENV",
    "FaultClause",
    "FaultPlanError",
    "PreemptionError",
    "SpawnFaultError",
    "active",
    "ambient_rank",
    "ambient_replica",
    "install_sigterm_drain",
    "mark_drained",
    "on_heartbeat",
    "on_rpc",
    "on_serve_request",
    "on_spawn",
    "on_task",
    "on_train_step",
    "parse_plan",
    "plan_clauses",
    "preemption_requested",
    "reraise_drained_sigterm",
    "request_preemption",
    "reset_for_tests",
]
