"""Fault-plan grammar and parser.

The counterpart of ``raydp_tpu/fault/plan.py``, whole: a plan string
means the same in both packages. A plan is a semicolon-separated list
of clauses read from ``RAYDP_TPU_FAULT_PLAN``::

    clause  ::= kind ":" key "=" value ("," key "=" value)*
    plan    ::= clause (";" clause)*

Kinds and their keys (``doc/fault_tolerance.md`` gives the semantics):

``kill``
    ``rank=N,step=K[,code=C]`` — SPMD rank ``N`` hard-exits with code
    ``C`` (default 23) when its estimator reaches train step ``K``; or
    ``worker=ID,task=K[,code=C]`` — ETL worker ``ID`` hard-exits when
    it starts its ``K``-th task (0-based). Either form may target
    ``job=NAME`` instead of (or in addition to) ``rank``/``worker``:
    the clause then only fires in a process whose ambient job
    (``RAYDP_TPU_JOB`` propagation) has that name or job id — the
    multi-tenant analogue of rank targeting.
``preempt``
    ``step=K[,rank=N][,job=NAME][,grace=S]`` — deliver a preemption
    notice at train step ``K`` (all ranks unless ``rank`` is given;
    injected slice preemption takes the whole gang, matching TPU
    semantics). ``job=NAME`` restricts the notice to gangs of that
    job, so a chaos sweep over a shared cluster preempts one tenant
    deterministically. ``grace`` overrides
    ``RAYDP_TPU_PREEMPT_GRACE_S`` for the force-exit deadline.
``rpc_delay``
    ``method=M,nth=K,delay=S`` — the ``K``-th (0-based) client call of
    RPC method ``M`` (bare or ``Service.Method``) sleeps ``S`` seconds
    before sending.
``rpc_drop``
    ``method=M,nth=K`` — the ``K``-th client call of method ``M``
    raises an UNAVAILABLE error instead of being sent.
``hb_stall``
    ``rank=N,beats=B[,after=K]`` (or ``worker=ID``) — the heartbeat
    loop of that process skips ``B`` consecutive beats starting at
    beat ``K`` (default 0), simulating a network partition long enough
    to trip liveness timeouts.
``serve_kill``
    ``replica=N,request=K[,code=C]`` — serving replica ``N`` hard-exits
    with code ``C`` (default 23) when it begins executing its ``K``-th
    request (0-based, counted per process). The clause targets the
    lineage's *first* incarnation only: a respawned replica is not
    re-killed, mirroring how a ``kill step=K`` fires once because the
    resumed run skips past step ``K``.
``latency``
    ``nth=K,delay=S[,replica=N]`` — the ``K``-th request executed by a
    serving replica (0-based, per process) stalls ``S`` seconds before
    running, simulating a straggler batch; ``replica=N`` restricts the
    stall to one replica.
``spawn_fail``
    ``nth=K[,prob=P]`` — the ``K``-th host-spawn attempt (0-based,
    counted per process at the autoscaler's provisioner boundary)
    raises a provisioner error instead of launching, exercising the
    backoff-and-retry budget deterministically.
``spawn_delay``
    ``nth=K,delay=S`` — the ``K``-th host-spawn attempt stalls ``S``
    seconds before proceeding, simulating a hung cloud-provisioning
    call.

Any clause may carry ``prob=P`` (0..1): whether it arms is decided
once, deterministically, from ``RAYDP_TPU_FAULT_SEED`` and the clause
index — so a seeded chaos sweep is reproducible run-to-run. Each
armed clause fires at most once per process.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

FAULT_PLAN_ENV = "RAYDP_TPU_FAULT_PLAN"
FAULT_SEED_ENV = "RAYDP_TPU_FAULT_SEED"

_KINDS = (
    "kill", "preempt", "rpc_delay", "rpc_drop", "hb_stall",
    "serve_kill", "latency", "spawn_fail", "spawn_delay",
)

_REQUIRED: Dict[str, tuple] = {
    "rpc_delay": ("method", "nth", "delay"),
    "rpc_drop": ("method", "nth"),
    "hb_stall": ("beats",),
    "serve_kill": ("replica", "request"),
    "latency": ("nth", "delay"),
    "spawn_fail": ("nth",),
    "spawn_delay": ("nth", "delay"),
}

_ALLOWED: Dict[str, tuple] = {
    "kill": ("rank", "step", "worker", "task", "code", "job", "prob"),
    "preempt": ("step", "rank", "grace", "job", "prob"),
    "rpc_delay": ("method", "nth", "delay", "prob"),
    "rpc_drop": ("method", "nth", "prob"),
    "hb_stall": ("rank", "worker", "beats", "after", "prob"),
    "serve_kill": ("replica", "request", "code", "prob"),
    "latency": ("nth", "delay", "replica", "prob"),
    "spawn_fail": ("nth", "prob"),
    "spawn_delay": ("nth", "delay", "prob"),
}

_INT_KEYS = (
    "rank", "step", "task", "code", "nth", "beats", "after",
    "replica", "request",
)
_FLOAT_KEYS = ("delay", "grace", "prob")


class FaultPlanError(ValueError):
    """Raised for a malformed ``RAYDP_TPU_FAULT_PLAN`` value."""


@dataclass
class FaultClause:
    """One parsed clause of the fault plan."""

    kind: str
    rank: Optional[int] = None
    worker: Optional[str] = None
    job: Optional[str] = None
    step: Optional[int] = None
    task: Optional[int] = None
    code: int = 23
    method: Optional[str] = None
    nth: Optional[int] = None
    replica: Optional[int] = None
    request: Optional[int] = None
    delay: float = 0.0
    grace: Optional[float] = None
    beats: int = 0
    after: int = 0
    prob: float = 1.0
    armed: bool = True
    fired: bool = field(default=False, compare=False)

    def matches_rank(self, rank: Optional[int]) -> bool:
        return self.rank is None or (rank is not None and rank == self.rank)

    def matches_replica(self, replica: Optional[int]) -> bool:
        return self.replica is None or (
            replica is not None and replica == self.replica
        )

    def matches_worker(self, worker: Optional[str]) -> bool:
        return self.worker is None or (worker is not None and worker == self.worker)

    def matches_job(self, job_id: Optional[str], name: Optional[str]) -> bool:
        """True when the ambient job satisfies the ``job=`` target.

        Matches either the human name or the minted job id, so plans
        can be written before ids exist. ``job=`` with no ambient job
        never matches (a clause must not fire in unattributed work).
        """
        if self.job is None:
            return True
        return self.job in {j for j in (job_id, name) if j is not None}

    def matches_method(self, qualified: str) -> bool:
        if self.method is None:
            return False
        if self.method == qualified:
            return True
        # Bare method name matches any service ("Ping" ~ "Master.Ping").
        return "." not in self.method and qualified.rsplit(".", 1)[-1] == self.method


def _coerce(kind: str, key: str, raw: str):
    try:
        if key in _INT_KEYS:
            return int(raw)
        if key in _FLOAT_KEYS:
            return float(raw)
    except ValueError:
        raise FaultPlanError(
            f"fault plan: clause {kind!r}: key {key}={raw!r} is not numeric"
        ) from None
    return raw


def parse_plan(text: str, seed: int = 0) -> List[FaultClause]:
    """Parse a plan string into armed clauses.

    ``seed`` feeds the deterministic ``prob`` coin flips; the clause
    index is mixed in so each clause gets an independent decision.
    """
    clauses: List[FaultClause] = []
    for idx, part in enumerate(p.strip() for p in text.split(";")):
        if not part:
            continue
        kind, sep, body = part.partition(":")
        kind = kind.strip()
        if kind not in _KINDS:
            raise FaultPlanError(
                f"fault plan: unknown kind {kind!r} (expected one of {_KINDS})"
            )
        if not sep or not body.strip():
            raise FaultPlanError(f"fault plan: clause {kind!r} has no arguments")
        kwargs: Dict[str, object] = {}
        for item in body.split(","):
            key, eq, raw = item.partition("=")
            key = key.strip()
            raw = raw.strip()
            if not eq or not key or not raw:
                raise FaultPlanError(
                    f"fault plan: clause {kind!r}: bad key=value item {item.strip()!r}"
                )
            if key not in _ALLOWED[kind]:
                raise FaultPlanError(
                    f"fault plan: clause {kind!r} does not accept key {key!r} "
                    f"(allowed: {_ALLOWED[kind]})"
                )
            if key in kwargs:
                raise FaultPlanError(
                    f"fault plan: clause {kind!r}: duplicate key {key!r}"
                )
            kwargs[key] = _coerce(kind, key, raw)
        for req in _REQUIRED.get(kind, ()):
            if req not in kwargs:
                raise FaultPlanError(
                    f"fault plan: clause {kind!r} requires key {req!r}"
                )
        if kind == "kill":
            if ("step" in kwargs) == ("task" in kwargs):
                raise FaultPlanError(
                    "fault plan: kill clause needs exactly one of step= (train "
                    "rank) or task= (ETL worker)"
                )
            if "step" in kwargs and "rank" not in kwargs and "job" not in kwargs:
                raise FaultPlanError(
                    "fault plan: kill step= clause needs rank= or job="
                )
            if "task" in kwargs and "worker" not in kwargs and "job" not in kwargs:
                raise FaultPlanError(
                    "fault plan: kill task= clause needs worker= or job="
                )
        if kind == "preempt" and "step" not in kwargs:
            raise FaultPlanError("fault plan: preempt clause requires key 'step'")
        if kind == "hb_stall" and "rank" not in kwargs and "worker" not in kwargs:
            raise FaultPlanError(
                "fault plan: hb_stall clause needs rank= or worker="
            )
        clause = FaultClause(kind=kind, **kwargs)  # type: ignore[arg-type]
        if not 0.0 <= clause.prob <= 1.0:
            raise FaultPlanError(
                f"fault plan: clause {kind!r}: prob must be in [0, 1]"
            )
        if clause.prob < 1.0:
            # str seed: hashlib-based, stable across processes and
            # PYTHONHASHSEED (tuple seeding is hash-based + deprecated)
            clause.armed = (
                random.Random(f"{seed}:{idx}").random() < clause.prob
            )
        clauses.append(clause)
    return clauses
