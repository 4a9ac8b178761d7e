"""Deterministic fault injection and preemption notices: the serve subset.

The counterpart of ``raydp_tpu/fault/`` for the serve plane. A seeded,
env-driven plan (``RAYDP_TPU_FAULT_PLAN``, the same grammar in both
packages) says which replica dies or stalls at which request, or which
RPC is delayed or dropped. Hooks (all no-ops when no plan is set):

* :func:`on_serve_request`: a serving replica's request boundary
  (``serve_kill`` / ``latency``);
* :func:`on_rpc`: an RPC client send (``rpc_delay`` / ``rpc_drop``).

A real SIGTERM lands in :func:`preemption_requested` through
:func:`install_sigterm_drain`; the replica drains and exits cleanly.
"""
from raydp_tpu_torch.fault.inject import (
    PREEMPT_GRACE_ENV,
    active,
    ambient_replica,
    install_sigterm_drain,
    mark_drained,
    on_rpc,
    on_serve_request,
    plan_clauses,
    preemption_requested,
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
    "active",
    "ambient_replica",
    "install_sigterm_drain",
    "mark_drained",
    "on_rpc",
    "on_serve_request",
    "parse_plan",
    "plan_clauses",
    "preemption_requested",
    "request_preemption",
    "reset_for_tests",
]
