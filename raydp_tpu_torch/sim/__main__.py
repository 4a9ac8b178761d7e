"""CLI for the control-plane observatory.

``python -m raydp_tpu_torch.sim run`` replays a loadgen JSONL trace (or a
generated schedule) through the real control plane on virtual time
and writes the :class:`SimResult` JSON; ``report`` renders a saved
result — headline numbers, every invariant violation, every detected
pathology — for humans and CI logs; ``knee`` runs the virtual-time
capacity sweep.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.control.autoscaler import AutoscalerConfig
from raydp_tpu_torch.loadgen import schedules as _schedules
from raydp_tpu_torch.loadgen.trace import read_trace
from raydp_tpu_torch.sim.scenario import (
    ScenarioConfig,
    result_to_json,
    run_trace,
    sim_knee,
)


def _build_schedule(args: argparse.Namespace) -> List[Any]:
    kind = args.schedule
    common = dict(seed=args.seed)
    if kind == "poisson":
        return _schedules.poisson_schedule(
            args.rps, args.duration, **common)
    if kind == "heavy_tail":
        return _schedules.heavy_tail_schedule(
            args.rps, args.duration, **common)
    if kind == "diurnal":
        return _schedules.diurnal_schedule(
            args.rps, args.duration, cycles=args.cycles, **common)
    if kind == "flash_crowd":
        return _schedules.flash_crowd_schedule(
            args.rps, args.duration, burst_mult=args.burst_mult, **common)
    raise SystemExit(f"unknown schedule {kind!r}")


def _scenario_from_args(args: argparse.Namespace) -> ScenarioConfig:
    autoscaler: Optional[AutoscalerConfig] = None
    if args.autoscale:
        lo, _, hi = args.autoscale.partition(":")
        autoscaler = AutoscalerConfig(
            min_workers=int(lo), max_workers=int(hi or lo),
            interval_s=args.autoscale_interval,
            up_cooldown_s=args.up_cooldown,
            down_cooldown_s=args.down_cooldown,
        )
    return ScenarioConfig(
        hosts=args.hosts,
        service_ms=args.service_ms,
        max_batch=args.max_batch,
        slo_ms=args.slo_ms,
        max_queue=args.max_queue,
        timeout_s=args.timeout_s,
        arbiter_capacity=args.arbiter_capacity,
        autoscaler=autoscaler,
        autoscale_interval_s=args.autoscale_interval,
        max_wall_s=args.max_wall_s,
    )


def _render(doc: Dict[str, Any]) -> str:
    lines = [
        "sim: {arrivals} arrivals -> {completed} completed, "
        "{shed} shed ({shed_rate:.1%}), {errors} errors".format(
            arrivals=doc.get("arrivals", 0),
            completed=doc.get("completed", 0),
            shed=doc.get("shed", 0),
            shed_rate=float(doc.get("shed_rate", 0.0)),
            errors=doc.get("errors", 0),
        ),
        "     {duration_s:.1f}s virtual in {wall_s:.2f}s wall "
        "({events} events, {eps:,.0f} events/s)".format(
            duration_s=float(doc.get("duration_s", 0.0)),
            wall_s=float(doc.get("wall_s", 0.0)),
            events=doc.get("events_processed", 0),
            eps=float(doc.get("events_per_s", 0.0)),
        ),
        "     p50 {p50} ms, p99 {p99} ms, final pool "
        "{pool} host(s), {deaths} replica death(s)".format(
            p50=doc.get("p50_ms"), p99=doc.get("p99_ms"),
            pool=doc.get("pool_size_final"),
            deaths=doc.get("replica_deaths", 0),
        ),
    ]
    violations = doc.get("invariant_violations", [])
    if violations:
        lines.append(f"invariants: {len(violations)} VIOLATION(S)")
        for v in violations:
            lines.append(
                f"  [{v.get('invariant')}] t={v.get('t')}: "
                f"{v.get('detail')}"
            )
    else:
        lines.append("invariants: clean")
    pathologies = doc.get("pathologies", [])
    if pathologies:
        lines.append(f"pathologies: {len(pathologies)} detected")
        for p in pathologies:
            lines.append(
                "  [{kind}] t={start}..{end}: {detail}".format(
                    kind=p.get("kind"), start=p.get("start_t"),
                    end=p.get("end_t"), detail=p.get("detail"),
                )
            )
    else:
        lines.append("pathologies: none detected")
    for g in doc.get("gangs", []):
        lines.append(
            "gang {job} (prio {priority}, {slots} slots): "
            "{admits} admit(s), {preempts} preemption(s), "
            "{sheds} shed(s)".format(**g)
        )
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m raydp_tpu_torch.sim",
        description="virtual-clock control-plane simulator",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    run_p = sub.add_parser("run", help="replay a trace or schedule")
    run_p.add_argument("--trace", help="loadgen JSONL trace path")
    run_p.add_argument("--schedule", default="poisson",
                       choices=("poisson", "heavy_tail", "diurnal",
                                "flash_crowd"))
    run_p.add_argument("--rps", type=float, default=50.0)
    run_p.add_argument("--duration", type=float, default=60.0)
    run_p.add_argument("--seed", type=int, default=0)
    run_p.add_argument("--cycles", type=float, default=1.0)
    run_p.add_argument("--burst-mult", type=float, default=5.0)
    run_p.add_argument("--out", help="write SimResult JSON here")

    knee_p = sub.add_parser("knee", help="virtual-time capacity sweep")
    knee_p.add_argument("--out", help="write knee JSON here")

    for p in (run_p, knee_p):
        p.add_argument("--hosts", type=int, default=2)
        p.add_argument("--service-ms", type=float, default=12.0)
        p.add_argument("--max-batch", type=int, default=8)
        p.add_argument("--slo-ms", type=float, default=50.0)
        p.add_argument("--max-queue", type=int, default=256)
        p.add_argument("--timeout-s", type=float, default=5.0)
        p.add_argument("--arbiter-capacity", type=int, default=0)
        p.add_argument("--autoscale", metavar="MIN:MAX", default="")
        p.add_argument("--autoscale-interval", type=float, default=1.0)
        p.add_argument("--up-cooldown", type=float, default=5.0)
        p.add_argument("--down-cooldown", type=float, default=30.0)
        p.add_argument("--max-wall-s", type=float, default=0.0)

    report_p = sub.add_parser("report", help="render a saved result")
    report_p.add_argument("path", help="SimResult JSON from `run --out`")

    args = parser.parse_args(argv)

    if args.cmd == "report":
        with open(args.path, "r", encoding="utf-8") as fh:
            doc = json.load(fh)
        print(_render(doc))
        return 0

    cfg = _scenario_from_args(args)
    if args.cmd == "knee":
        summary = sim_knee(cfg)
        if args.out:
            with open(args.out, "w", encoding="utf-8") as fh:
                json.dump(summary, fh, indent=2, sort_keys=True)
                fh.write("\n")
        print(
            "sim knee: {knee_rps} rps ({state}, p99 {p99} ms, "
            "{steps} steps)".format(
                knee_rps=summary["knee_rps"],
                state="saturated" if summary["saturated"]
                else "unsaturated",
                p99=summary.get("p99_at_knee_ms"),
                steps=summary["steps"],
            )
        )
        return 0

    if args.trace:
        events = read_trace(args.trace)
    else:
        events = _build_schedule(args)
    result = run_trace(events, cfg)
    if args.out:
        result_to_json(result, args.out)
    print(_render(result.to_dict()))
    return 1 if result.invariant_violations else 0


if __name__ == "__main__":
    sys.exit(main())
