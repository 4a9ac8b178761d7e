"""Capacity-knee finder: stepped ramp, breach confirmation, bisection.

Saturation knees only emerge under swept offered load (arXiv:
2011.03641): below capacity, p99 tracks service time; past it, queues
grow without bound and p99/shed explode within a step. The finder
ramps offered RPS geometrically, calls a step *breached* when its p99
exceeds the SLO or its shed rate exceeds the threshold, requires two
consecutive breached steps (one bad step can be noise — a compile, a
GC pause), then bisects between the last good and first breached rate.

The knee is the highest offered RPS that sustained the SLO. Results
carry the full load-vs-p99/shed curve for plotting, are exported as
``raydp_loadgen_*`` families, and a ``load/knee`` event lands on the
timeline so a capacity regression is greppable next to deploys and
preemptions.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from raydp_tpu_torch.loadgen.runner import LoadResult, run_schedule
from raydp_tpu_torch.loadgen.schedules import poisson_schedule
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils.profiling import metrics

LOADGEN_START_RPS_ENV = "RAYDP_TPU_LOADGEN_START_RPS"
LOADGEN_MAX_RPS_ENV = "RAYDP_TPU_LOADGEN_MAX_RPS"
LOADGEN_STEP_FACTOR_ENV = "RAYDP_TPU_LOADGEN_STEP_FACTOR"
LOADGEN_STEP_S_ENV = "RAYDP_TPU_LOADGEN_STEP_S"
LOADGEN_SLO_MS_ENV = "RAYDP_TPU_LOADGEN_SLO_MS"
LOADGEN_SHED_THRESHOLD_ENV = "RAYDP_TPU_LOADGEN_SHED_THRESHOLD"
LOADGEN_BISECT_ROUNDS_ENV = "RAYDP_TPU_LOADGEN_BISECT_ROUNDS"
LOADGEN_SEED_ENV = "RAYDP_TPU_LOADGEN_SEED"


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


@dataclass
class KneeConfig:
    """Ramp/bisect knobs; ``from_env`` reads ``RAYDP_TPU_LOADGEN_*``
    (constructor arguments win)."""

    start_rps: float = 8.0
    max_rps: float = 1024.0
    step_factor: float = 1.7
    step_duration_s: float = 2.0
    slo_ms: float = 250.0
    shed_threshold: float = 0.05
    bisect_rounds: int = 3
    timeout_s: float = 5.0
    seed: int = 0

    @classmethod
    def from_env(cls) -> "KneeConfig":
        return cls(
            start_rps=max(0.1, _env_float(LOADGEN_START_RPS_ENV, 8.0)),
            max_rps=max(1.0, _env_float(LOADGEN_MAX_RPS_ENV, 1024.0)),
            step_factor=max(
                1.05, _env_float(LOADGEN_STEP_FACTOR_ENV, 1.7)
            ),
            step_duration_s=max(
                0.2, _env_float(LOADGEN_STEP_S_ENV, 2.0)
            ),
            slo_ms=max(1.0, _env_float(LOADGEN_SLO_MS_ENV, 250.0)),
            shed_threshold=min(1.0, max(
                0.0, _env_float(LOADGEN_SHED_THRESHOLD_ENV, 0.05)
            )),
            bisect_rounds=int(
                _env_float(LOADGEN_BISECT_ROUNDS_ENV, 3.0)
            ),
            timeout_s=max(0.5, _env_float(
                "RAYDP_TPU_LOADGEN_TIMEOUT_S", 5.0
            )),
            seed=int(_env_float(LOADGEN_SEED_ENV, 0.0)),
        )


@dataclass
class KneePoint:
    """One step of the ramp/bisect sweep."""

    rps: float
    achieved_rps: float
    p50_s: Optional[float]
    p99_s: Optional[float]
    shed_rate: float
    error_rate: float
    requests: int
    breached: bool
    stage: str  # "ramp" | "bisect"

    def to_record(self) -> Dict[str, Any]:
        return {
            "kind": "step",
            "stage": self.stage,
            "rps": round(self.rps, 3),
            "achieved_rps": round(self.achieved_rps, 3),
            "p50_s": self.p50_s,
            "p99_s": self.p99_s,
            "shed_rate": round(self.shed_rate, 4),
            "error_rate": round(self.error_rate, 4),
            "requests": self.requests,
            "breached": self.breached,
        }


@dataclass
class KneeResult:
    """The sweep's verdict: the knee, whether a cliff was actually
    found (``saturated``), and the full curve."""

    knee_rps: float
    saturated: bool
    p99_at_knee_s: Optional[float]
    shed_at_knee: float
    curve: List[KneePoint] = field(default_factory=list)
    config: Optional[KneeConfig] = None
    results: List[LoadResult] = field(default_factory=list)

    def summary(self) -> Dict[str, Any]:
        return {
            "kind": "knee",
            "knee_rps": round(self.knee_rps, 3),
            "saturated": self.saturated,
            "p99_at_knee_s": self.p99_at_knee_s,
            "shed_at_knee": round(self.shed_at_knee, 4),
            "steps": len(self.curve),
            "slo_ms": self.config.slo_ms if self.config else None,
            "shed_threshold": (
                self.config.shed_threshold if self.config else None
            ),
        }


def _breached(res: LoadResult, cfg: KneeConfig) -> bool:
    p99 = res.latency_quantile(0.99)
    if p99 is not None and p99 > cfg.slo_ms / 1000.0:
        return True
    if res.rate("shed") > cfg.shed_threshold:
        return True
    # A step where nothing succeeded at all is saturated by definition.
    return bool(res.outcomes) and res.achieved_rps == 0.0


def _run_step(target: Any, rps: float, cfg: KneeConfig, stage: str,
              step_index: int) -> KneePoint:
    schedule = poisson_schedule(
        rps, cfg.step_duration_s, seed=cfg.seed + step_index
    )
    res = run_schedule(target, schedule, timeout_s=cfg.timeout_s)
    point = KneePoint(
        rps=rps,
        achieved_rps=res.achieved_rps,
        p50_s=res.latency_quantile(0.5),
        p99_s=res.latency_quantile(0.99),
        shed_rate=res.rate("shed"),
        error_rate=res.rate("error") + res.rate("overload"),
        requests=len(res.outcomes),
        breached=_breached(res, cfg),
        stage=stage,
    )
    point._result = res  # type: ignore[attr-defined]
    return point


def find_knee(target: Any, config: Optional[KneeConfig] = None,
              on_point: Optional[Callable[[KneePoint], None]] = None
              ) -> KneeResult:
    """Sweep ``target`` for its capacity knee.

    Ramp geometrically from ``start_rps``; two consecutive breached
    steps end the ramp and bound the bisection. The returned knee is
    the highest offered RPS that held the SLO (``saturated=False``
    means the ramp hit ``max_rps`` without breaching — the knee is a
    lower bound, not a cliff).
    """
    cfg = config or KneeConfig.from_env()
    curve: List[KneePoint] = []
    results: List[LoadResult] = []
    step_index = 0

    def run(rps: float, stage: str) -> KneePoint:
        nonlocal step_index
        point = _run_step(target, rps, cfg, stage, step_index)
        step_index += 1
        curve.append(point)
        results.append(point._result)  # type: ignore[attr-defined]
        if on_point is not None:
            on_point(point)
        return point

    last_good: Optional[KneePoint] = None
    first_bad: Optional[KneePoint] = None
    prev_bad: Optional[KneePoint] = None
    offered = cfg.start_rps
    while offered <= cfg.max_rps:
        point = run(offered, "ramp")
        if point.breached:
            if prev_bad is not None:
                first_bad = prev_bad
                break
            prev_bad = point
        else:
            last_good = point
            prev_bad = None
        offered *= cfg.step_factor
    else:
        # Two consecutive breaches never happened below max_rps. A
        # single trailing breach still ends the sweep unsaturated —
        # it was never confirmed.
        first_bad = None

    if first_bad is None or last_good is None:
        knee = last_good.rps if last_good is not None else 0.0
        result = KneeResult(
            knee_rps=knee, saturated=False,
            p99_at_knee_s=(last_good.p99_s if last_good else None),
            shed_at_knee=(last_good.shed_rate if last_good else 0.0),
            curve=curve, config=cfg, results=results,
        )
    else:
        lo, hi = last_good, first_bad
        for _ in range(max(0, cfg.bisect_rounds)):
            mid_rps = (lo.rps + hi.rps) / 2.0
            if hi.rps - lo.rps < max(0.5, 0.05 * lo.rps):
                break
            point = run(mid_rps, "bisect")
            if point.breached:
                hi = point
            else:
                lo = point
        result = KneeResult(
            knee_rps=lo.rps, saturated=True,
            p99_at_knee_s=lo.p99_s, shed_at_knee=lo.shed_rate,
            curve=curve, config=cfg, results=results,
        )

    metrics.gauge_set("loadgen/knee_rps", result.knee_rps)
    _events.emit(
        "load/knee",
        knee_rps=round(result.knee_rps, 3),
        saturated=result.saturated,
        p99_at_knee_s=result.p99_at_knee_s,
        shed_at_knee=round(result.shed_at_knee, 4),
        steps=len(curve),
        slo_ms=cfg.slo_ms,
    )
    return result


def write_results(path: str, result: KneeResult) -> int:
    """Persist a knee sweep as JSONL: one ``knee`` summary line, one
    ``step`` line per curve point, one ``request`` line per outcome —
    the file ``python -m raydp_tpu_torch.loadgen report`` renders offline."""
    lines = 0
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(json.dumps(result.summary(), sort_keys=True) + "\n")
        lines += 1
        for point, res in zip(result.curve, result.results):
            fh.write(json.dumps(point.to_record(), sort_keys=True) + "\n")
            lines += 1
            for outcome in res.outcomes:
                rec = outcome.to_record()
                rec["step_rps"] = round(point.rps, 3)
                fh.write(json.dumps(rec, sort_keys=True) + "\n")
                lines += 1
    return lines
