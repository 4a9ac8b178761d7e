"""Per-stage runtime statistics of the DataFrame engine.

The part of the JAX package's ``telemetry/progress.py`` the engine
needs: :data:`stage_store`, a :class:`StageStatsStore` of
:class:`StageStats` records, one per executed DataFrame stage (map,
exchange, coalesce), with rows and bytes in and out, wall and dispatch
seconds and the per-partition output layout. The adaptive planner
(:mod:`raydp_tpu_torch.dataframe.aqe`) reads measured output bytes
back through ``output_bytes``.

``RAYDP_TPU_STAGE_STATS=0`` turns recording off;
``RAYDP_TPU_STAGE_STATS_KEEP`` sizes the ring (default 512).
"""
from __future__ import annotations

import os
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import List, Optional

__all__ = [
    "STAGE_STATS_ENV",
    "StageStats",
    "StageStatsStore",
    "stage_stats_enabled",
    "stage_store",
]

STAGE_STATS_ENV = "RAYDP_TPU_STAGE_STATS"


def stage_stats_enabled() -> bool:
    return os.environ.get(STAGE_STATS_ENV, "1") not in ("0", "false")


@dataclass
class StageStats:
    """Everything the AQE needs to re-plan, for one executed stage."""

    stage_id: int
    op: str                       # plan-node label, e.g. "exchange[k]"
    executor: str                 # "local"
    rows_in: int = 0
    rows_out: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    parts_in: int = 0
    parts_out: int = 0
    wall_s: float = 0.0
    dispatch_s: float = 0.0       # submission time
    part_rows: List[int] = field(default_factory=list)     # output layout
    part_bytes: List[int] = field(default_factory=list)


class StageStatsStore:
    """Bounded ring of completed-stage stats, keyed by a process-
    monotonic stage id. Thread-safe: streaming stages complete on the
    executor's pool threads while the planner reads."""

    def __init__(self, keep: Optional[int] = None):
        if keep is None:
            keep = int(os.environ.get("RAYDP_TPU_STAGE_STATS_KEEP", "512"))
        self._keep = max(1, keep)
        self._mu = threading.Lock()
        self._stats: "OrderedDict[int, StageStats]" = OrderedDict()
        self._next_id = 0

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
        return stats.stage_id

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


stage_store = StageStatsStore()
