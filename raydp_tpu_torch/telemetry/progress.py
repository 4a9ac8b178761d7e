"""Query-profiling substrate: per-stage runtime stats + live progress
(the port's copy of ``raydp_tpu/telemetry/progress.py``).

Two driver-side singletons feed EXPLAIN ANALYZE, ``profile()``,
``Cluster.progress_report()``, and the cost-based adaptive planner
(:mod:`raydp_tpu_torch.dataframe.aqe` reads measured layouts back
through ``StageStatsStore.output_bytes``/``output_layout``):

* :data:`stage_store` — a :class:`StageStatsStore` of
  :class:`StageStats` records, one per executed DataFrame stage
  (map / exchange / coalesce), carrying rows and bytes in/out,
  wall/dispatch/queue seconds, per-worker task attribution, and the
  per-partition output layout the skew ratio (max/mean rows) is
  computed from. Executors record into it as stages complete;
  materialized ``DataFrame``s keep the ids of the stages that built
  them, so ``df.stage_stats`` / ``df.explain(analyze=True)`` can
  re-associate numbers with plan nodes after the fact.
* :data:`progress` — a :class:`ProgressTracker` of live stage
  task-completion counts (done/total), served on ``/debug/progress``
  and ``Cluster.progress_report()``, with an opt-in driver-side logger
  (``RAYDP_TPU_PROGRESS_LOG=<seconds>``) that logs active-stage
  progress lines at that cadence.

Env knobs:

* ``RAYDP_TPU_STAGE_STATS=0`` — kill switch; stages still run their
  spans but record no stats (the <5% overhead guarantee's escape
  hatch).
* ``RAYDP_TPU_STAGE_STATS_KEEP`` — ring size of retained stage records
  (default 512).
* ``RAYDP_TPU_STATS_DIR`` (falls back to ``RAYDP_TPU_TELEMETRY_DIR``)
  — when set, every record is also appended to
  ``stats-<pid>.jsonl`` there, so CI can ship the stats store as an
  artifact from a process that already exited. The first write of a
  process there prunes the directory's ``stats-*.jsonl`` shards to the
  newest ``RAYDP_TPU_SHARD_KEEP`` (``telemetry/export.py``).
* ``RAYDP_TPU_PROGRESS_LOG=<seconds>`` — arm the progress logger.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "PROGRESS_LOG_ENV",
    "STAGE_STATS_ENV",
    "STATS_DIR_ENV",
    "StageStats",
    "StageStatsStore",
    "ProgressTracker",
    "stage_store",
    "progress",
    "stage_stats_enabled",
]

STAGE_STATS_ENV = "RAYDP_TPU_STAGE_STATS"
STATS_DIR_ENV = "RAYDP_TPU_STATS_DIR"
PROGRESS_LOG_ENV = "RAYDP_TPU_PROGRESS_LOG"


def stage_stats_enabled() -> bool:
    return os.environ.get(STAGE_STATS_ENV, "1") not in ("0", "false")


def _stats_dir() -> Optional[str]:
    return os.environ.get(STATS_DIR_ENV) or os.environ.get(
        "RAYDP_TPU_TELEMETRY_DIR"
    )


@dataclass
class StageStats:
    """Everything the AQE needs to re-plan, for one executed stage."""

    stage_id: int
    op: str                       # plan-node label, e.g. "exchange[k]"
    executor: str                 # "local" | "cluster"
    rows_in: int = 0
    rows_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    parts_in: int = 0
    parts_out: int = 0
    wall_s: float = 0.0
    dispatch_s: float = 0.0       # driver-side submit time
    queue_s: float = 0.0          # wall - worker exec, cluster stages
    workers: Dict[str, int] = field(default_factory=dict)  # wid -> tasks
    part_rows: List[int] = field(default_factory=list)     # output layout
    part_bytes: List[int] = field(default_factory=list)

    @property
    def skew(self) -> float:
        """Partition-skew ratio max/mean over output rows (>= 1.0); 1.0
        for empty or perfectly balanced output."""
        rows = [r for r in self.part_rows if r >= 0]
        if not rows or sum(rows) == 0:
            return 1.0
        mean = sum(rows) / len(rows)
        return max(rows) / mean if mean > 0 else 1.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "stage_id": self.stage_id,
            "op": self.op,
            "executor": self.executor,
            "rows_in": self.rows_in,
            "rows_out": self.rows_out,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "parts_in": self.parts_in,
            "parts_out": self.parts_out,
            "wall_s": round(self.wall_s, 6),
            "dispatch_s": round(self.dispatch_s, 6),
            "queue_s": round(self.queue_s, 6),
            "workers": dict(self.workers),
            "part_rows": list(self.part_rows),
            "part_bytes": list(self.part_bytes),
            "skew": round(self.skew, 4),
        }


class StageStatsStore:
    """Bounded driver-side ring of completed-stage stats, keyed by a
    process-monotonic stage id. Thread-safe: cluster stages complete on
    waiter threads while the planner records local ones."""

    def __init__(self, keep: Optional[int] = None):
        if keep is None:
            keep = int(os.environ.get("RAYDP_TPU_STAGE_STATS_KEEP", "512"))
        self._keep = max(1, keep)
        self._mu = threading.Lock()
        self._stats: "OrderedDict[int, StageStats]" = OrderedDict()
        self._next_id = 0
        self._shard_path: Optional[str] = None

    def next_id(self) -> int:
        with self._mu:
            self._next_id += 1
            return self._next_id

    def record(self, stats: StageStats) -> int:
        with self._mu:
            if stats.stage_id <= 0:
                self._next_id += 1
                stats.stage_id = self._next_id
            self._stats[stats.stage_id] = stats
            while len(self._stats) > self._keep:
                self._stats.popitem(last=False)
        self._append_shard(stats)
        return stats.stage_id

    def get(self, stage_id: int) -> Optional[StageStats]:
        with self._mu:
            return self._stats.get(stage_id)

    def last_id(self) -> int:
        with self._mu:
            return self._next_id

    def recent(self, n: int = 32) -> List[StageStats]:
        with self._mu:
            return list(self._stats.values())[-n:]

    def snapshot(self) -> Dict[str, Any]:
        with self._mu:
            stats = list(self._stats.values())
        return {
            "stages": [s.to_dict() for s in stats],
            "totals": {
                "stages": len(stats),
                "rows_out": sum(s.rows_out for s in stats),
                "bytes_out": sum(s.bytes_out for s in stats),
                "wall_s": round(sum(s.wall_s for s in stats), 6),
            },
        }

    # -- stats feedback (the AQE's read path) --------------------------
    def output_bytes(self, stage_ids: List[int]) -> Optional[int]:
        """Measured output bytes of the LAST recorded stage among
        ``stage_ids`` — a plan node's stages run in id order (partial →
        exchange → ...), so the highest id's output is the layout the
        node actually produced. ``None`` when none has recorded yet
        (still streaming, or evicted): the caller falls back to probing
        partitions directly."""
        with self._mu:
            for sid in sorted(stage_ids, reverse=True):
                s = self._stats.get(sid)
                if s is not None:
                    return s.bytes_out
        return None

    def output_layout(self, stage_ids: List[int]) -> Optional[List[int]]:
        """Per-partition output bytes of the last recorded stage among
        ``stage_ids`` (same selection as :meth:`output_bytes`) — the
        skew evidence replan rules consume."""
        with self._mu:
            for sid in sorted(stage_ids, reverse=True):
                s = self._stats.get(sid)
                if s is not None:
                    return list(s.part_bytes)
        return None

    def clear(self) -> None:
        with self._mu:
            self._stats.clear()

    def _append_shard(self, stats: StageStats) -> None:
        directory = _stats_dir()
        if not directory:
            return
        try:
            if self._shard_path is None or not self._shard_path.startswith(
                directory
            ):
                from raydp_tpu_torch.telemetry.export import prune_shards_once

                os.makedirs(directory, exist_ok=True)
                prune_shards_once(directory, "stats")
                self._shard_path = os.path.join(
                    directory, f"stats-{os.getpid()}.jsonl"
                )
            with open(self._shard_path, "a") as f:
                f.write(json.dumps(stats.to_dict()) + "\n")
        except OSError:
            pass  # artifact shipping must never fail a stage


class ProgressTracker:
    """Live done/total task counts per in-flight stage.

    ``stage_begin`` → n×``task_done`` → ``stage_end``; executors drive
    it as they dispatch and collect. Finished stages move to a bounded
    recent list so a progress report shows what just happened, not
    just what is happening."""

    def __init__(self, keep_recent: int = 64):
        self._mu = threading.Lock()
        self._active: "OrderedDict[int, Dict[str, Any]]" = OrderedDict()
        self._recent: List[Dict[str, Any]] = []
        self._keep_recent = keep_recent
        self._done_stages = 0
        self._logger_armed = False

    def stage_begin(self, stage_id: int, op: str, total: int) -> None:
        now = time.time()
        with self._mu:
            self._active[stage_id] = {
                "stage_id": stage_id,
                "op": op,
                "done": 0,
                "total": int(total),
                "started_wall": now,
            }
        self._maybe_start_logger()

    def task_done(self, stage_id: int, n: int = 1) -> None:
        with self._mu:
            st = self._active.get(stage_id)
            if st is not None:
                st["done"] += n

    def stage_end(self, stage_id: int) -> None:
        now = time.time()
        with self._mu:
            st = self._active.pop(stage_id, None)
            if st is None:
                return
            st["done"] = max(st["done"], st["total"])
            st["seconds"] = round(now - st.pop("started_wall"), 6)
            self._recent.append(st)
            del self._recent[: -self._keep_recent]
            self._done_stages += 1

    def report(self) -> Dict[str, Any]:
        now = time.time()
        with self._mu:
            active = []
            for st in self._active.values():
                entry = dict(st)
                entry["age_s"] = round(now - entry.pop("started_wall"), 3)
                active.append(entry)
            return {
                "active": active,
                "recent": list(self._recent),
                "stages_done": self._done_stages,
                "tasks_done": sum(s["done"] for s in self._recent)
                + sum(s["done"] for s in active),
            }


    # -- opt-in driver-side progress logger ----------------------------
    def _maybe_start_logger(self) -> None:
        """Arm, once, a daemon thread that logs each active stage's
        ``progress: stage <id> <op> <done>/<total> tasks`` every
        ``RAYDP_TPU_PROGRESS_LOG`` seconds (at least 0.2; 5 where the
        value does not parse)."""
        interval = os.environ.get(PROGRESS_LOG_ENV)
        if not interval:
            return
        with self._mu:
            if self._logger_armed:
                return
            self._logger_armed = True
        try:
            period = max(0.2, float(interval))
        except ValueError:
            period = 5.0

        def _loop() -> None:
            while True:
                time.sleep(period)
                with self._mu:
                    active = [dict(s) for s in self._active.values()]
                for st in active:
                    logger.info(
                        "progress: stage %d %s %d/%d tasks",
                        st["stage_id"], st["op"], st["done"], st["total"],
                    )

        threading.Thread(
            target=_loop, name="raydp-progress-log", daemon=True
        ).start()


stage_store = StageStatsStore()
progress = ProgressTracker()
