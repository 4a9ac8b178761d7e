"""Multi-tenant control plane: admission, fair share, preemption,
and telemetry-driven pool sizing.

The port's counterpart of ``raydp_tpu/control/``: the public surface of
:mod:`raydp_tpu_torch.control.arbiter` and
:mod:`raydp_tpu_torch.control.autoscaler` (``doc/scheduling.md`` gives
the state machines and semantics). Its callers: ``SPMDJob.start``
(admission before ranks spawn), ``fit_spmd`` (one gang lease across
restarts), the DataFrame executor (``stage_gate``), ``ReplicaGroup.start``
(``slots = replicas``), the HTTP frontend (``ClusterBusyError`` -> 429)
and ``Cluster.scheduler_report``. Imports no torch.
"""
from raydp_tpu_torch.control.arbiter import (
    SCHED_ADMIT_TIMEOUT_ENV,
    SCHED_CAPACITY_ENV,
    SCHED_LEASE_TTL_ENV,
    SCHED_MAX_QUEUE_ENV,
    SCHED_PREEMPT_TIMEOUT_ENV,
    SCHED_PRESSURE_ENV,
    ClusterArbiter,
    ClusterBusyError,
    Lease,
    configure,
    get_arbiter,
    reset_for_tests,
    stage_gate,
)
from raydp_tpu_torch.control.autoscaler import (
    AUTOSCALE_MAX_ENV,
    AUTOSCALE_MIN_ENV,
    Autoscaler,
    AutoscalerConfig,
    ClusterProvisioner,
    Decision,
    HostProvisioner,
    ProvisionerError,
)

__all__ = [
    "SCHED_ADMIT_TIMEOUT_ENV",
    "SCHED_CAPACITY_ENV",
    "SCHED_LEASE_TTL_ENV",
    "SCHED_MAX_QUEUE_ENV",
    "SCHED_PREEMPT_TIMEOUT_ENV",
    "SCHED_PRESSURE_ENV",
    "AUTOSCALE_MAX_ENV",
    "AUTOSCALE_MIN_ENV",
    "ClusterArbiter",
    "ClusterBusyError",
    "Lease",
    "Autoscaler",
    "AutoscalerConfig",
    "ClusterProvisioner",
    "Decision",
    "HostProvisioner",
    "ProvisionerError",
    "configure",
    "get_arbiter",
    "reset_for_tests",
    "stage_gate",
]
