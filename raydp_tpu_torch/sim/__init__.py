"""Control-plane observatory: discrete-event simulation at scale.

The gates exercise the arbiter, autoscaler, and serving queue with a
handful of hosts and hundreds of requests; the north star claims three
more orders of magnitude. This package closes that observation gap by
running the **real** control-plane code — :class:`ClusterArbiter`,
:class:`Autoscaler`, :class:`RequestQueue`, the fault-plan hooks — on
a virtual clock against simulated hosts and replicas, so thousands of
hosts × millions of arrivals × the loadgen diurnal/heavy-tail/
flash-crowd schedules execute in seconds of wall time
(arXiv:2011.03641: sweep offered concurrency far past the comfortable
regime and characterize where and *why* the system breaks).

Layout:

* :mod:`~raydp_tpu_torch.sim.vclock` — :class:`SimClock`, the event-heap
  clock installed behind :mod:`raydp_tpu_torch.utils.clock`.
* :mod:`~raydp_tpu_torch.sim.cluster` — :class:`SimProvisioner` (behind the
  ``HostProvisioner`` seam) and virtual replicas behind the
  ``RequestQueue`` dispatch edge, honoring ``spawn_fail`` /
  ``spawn_delay`` / ``serve_kill`` / ``latency`` fault clauses on
  virtual time.
* :mod:`~raydp_tpu_torch.sim.monitors` — invariant monitors evaluated
  continuously during the run.
* :mod:`~raydp_tpu_torch.sim.pathology` — detectors that scan the simulated
  timeline for emergent failure shapes (priority inversion,
  autoscale/preemption resonance, shed storms, fragmentation).
* :mod:`~raydp_tpu_torch.sim.scenario` — trace replay + virtual-time knee
  sweeps; ``python -m raydp_tpu_torch.sim`` is the CLI.
"""
from raydp_tpu_torch.sim.vclock import (
    SimClock,
    SimDeadlockError,
    SimWallBudgetError,
)
from raydp_tpu_torch.sim.cluster import (
    DecodeServiceModel,
    ReplicaPool,
    ServiceModel,
    SimProvisioner,
)
from raydp_tpu_torch.sim.monitors import InvariantMonitor, InvariantViolation
from raydp_tpu_torch.sim.pathology import Pathology, scan_timeline
from raydp_tpu_torch.sim.scenario import (
    GangJobSpec,
    ScenarioConfig,
    SimResult,
    run_trace,
    sim_knee,
)

__all__ = [
    "SimClock",
    "SimDeadlockError",
    "SimWallBudgetError",
    "SimProvisioner",
    "ReplicaPool",
    "DecodeServiceModel",
    "ServiceModel",
    "InvariantMonitor",
    "InvariantViolation",
    "Pathology",
    "scan_timeline",
    "ScenarioConfig",
    "GangJobSpec",
    "SimResult",
    "run_trace",
    "sim_knee",
]
