"""Adaptive query engine (AQE): runtime cost-based replanning.

The co-partitioning planner elides exchanges from *static* layout
metadata; the executor records the runtime inputs the adaptive form
needs (per-stage rows/bytes and a partition-skew ratio in
:class:`~raydp_tpu_torch.telemetry.progress.StageStatsStore`, plus
per-bucket chunk sizes measurable inside every exchange before merge
dispatch). This module closes the stats→plan loop with four replan
rules, applied at exchange choke points — where partitions already
barrier, so the streaming pipelining of narrow stages is unaffected:

* **coalesce** — merge post-shuffle buckets whose measured bytes fall
  below ``RAYDP_TPU_AQE_TARGET_PARTITION_MB`` (fewer merge tasks and
  envelopes), never dropping below a parallelism floor the caller
  supplies (Spark AQE's ``coalescePartitions.minPartitionNum``).
* **salt** — when the measured layout skew exceeds
  ``RAYDP_TPU_AQE_SKEW_RATIO``, split oversized buckets/partitions
  across ``k`` sub-parts: groupBy inputs are slice-split ahead of the
  two-phase partial-agg (partials merge downstream unchanged, so every
  agg spec stays bit-identical), join probe buckets are chunk-split
  with the matching build bucket replicated.
* **join** — broadcast vs zipped vs shuffle picked from *measured*
  upstream sizes (live partition sizes, falling back to recorded stage
  output bytes for still-pending streaming frames).
* **scan** — projections/predicates pushed into executor-side parquet
  scans (:mod:`raydp_tpu_torch.dataframe.io`), pruning row groups from
  footer statistics.

Every decision is recorded through :class:`Decisions` — exactly one
``aqe[<rule>]`` plan-annotation marker per ``aqe/replans/<rule>``
counter bump, which is the parity invariant ``explain(analyze=True)``
holds (:func:`rule_counts`). ``RAYDP_TPU_AQE=0`` disables every rule and
restores the static planner bit-for-bit.
"""
from __future__ import annotations

import math
import os
import re
from typing import Dict, List, Optional, Tuple

from raydp_tpu_torch.utils.profiling import metrics

__all__ = [
    "AQE_ENV",
    "TARGET_MB_ENV",
    "SKEW_RATIO_ENV",
    "SALT_K_ENV",
    "MIN_EXCHANGE_MB_ENV",
    "RULES",
    "aqe_enabled",
    "target_partition_bytes",
    "skew_ratio",
    "max_salt_k",
    "min_exchange_bytes",
    "Decisions",
    "ExchangePlan",
    "plan_exchange",
    "plan_rebalance",
    "rule_counts",
]

AQE_ENV = "RAYDP_TPU_AQE"
TARGET_MB_ENV = "RAYDP_TPU_AQE_TARGET_PARTITION_MB"
SKEW_RATIO_ENV = "RAYDP_TPU_AQE_SKEW_RATIO"
SALT_K_ENV = "RAYDP_TPU_AQE_SALT_K"
MIN_EXCHANGE_MB_ENV = "RAYDP_TPU_AQE_MIN_EXCHANGE_MB"

RULES = ("coalesce", "salt", "join", "scan")

_MARKER = re.compile(r"aqe\[(\w+)\]")


def aqe_enabled() -> bool:
    """Kill switch (default on). Read live so tests and benches can
    flip paths without re-importing modules."""
    return os.environ.get(AQE_ENV, "1") not in ("0", "false")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def target_partition_bytes() -> int:
    """Advisory post-shuffle partition size (Spark AQE's
    ``advisoryPartitionSizeInBytes`` analog)."""
    return int(_env_float(TARGET_MB_ENV, 32.0) * (1 << 20))


def skew_ratio() -> float:
    """max/mean layout ratio above which a bucket/partition counts as
    skewed (hot-key suspect)."""
    return max(1.0, _env_float(SKEW_RATIO_ENV, 2.0))


def max_salt_k() -> int:
    """Upper bound on sub-parts a skewed bucket is split across."""
    return max(2, int(_env_float(SALT_K_ENV, 8)))


def min_exchange_bytes() -> int:
    """Replan floor: exchanges moving less than this stay static —
    task orchestration dominates at that size and the static plan is
    already the measured-optimal shape for it."""
    return int(_env_float(MIN_EXCHANGE_MB_ENV, 4.0) * (1 << 20))


class Decisions:
    """Per-query-node decision recorder.

    One :meth:`record` call = one ``aqe[<rule>]`` annotation marker in
    the plan = one ``aqe/replans/<rule>`` counter bump, kept together
    in one method."""

    def __init__(self) -> None:
        self.notes: List[str] = []

    def record(self, rule: str, note: str) -> None:
        if rule not in RULES:
            raise ValueError(f"unknown AQE rule {rule!r}")
        metrics.counter_add(f"aqe/replans/{rule}")
        self.notes.append(f"aqe[{rule}]: {note}")

    @property
    def fired(self) -> bool:
        return bool(self.notes)

    def suffix(self) -> str:
        """Annotation suffix appended to the owning plan node."""
        return "".join(f"; {n}" for n in self.notes)


class ExchangePlan:
    """Rewritten output layout for one exchange.

    ``groups`` is an ordered list of output-partition build rules over
    the static bucket ids::

        ("merge", [ids])     concat those buckets into ONE output
        ("split", id, k)     spread bucket id's chunk list over k outputs
        ("replicate", id, k) merge bucket id once, list it k times

    ``split`` requires ``combine is None`` (a per-bucket combine over a
    sub-bucket would see partial groups) and ``k`` no larger than the
    exchange's input-partition count — :func:`plan_exchange` clamps it.
    """

    def __init__(self, groups: List[tuple]) -> None:
        self.groups = groups

    @property
    def n_out(self) -> int:
        return sum(
            g[2] if g[0] in ("split", "replicate") else 1
            for g in self.groups
        )

    def has_splits(self) -> bool:
        return any(g[0] == "split" for g in self.groups)

    def conform_build_side(self) -> "ExchangePlan":
        """The matching plan for the OTHER side of a shuffle join: same
        merge groups (co-location preserved), but where the probe side
        split a hot bucket the build side replicates its matching
        bucket — every probe sub-bucket joins against the full build
        rows of those keys, which conserves the join result exactly."""
        return ExchangePlan([
            ("replicate", g[1], g[2]) if g[0] == "split" else g
            for g in self.groups
        ])


def plan_exchange(
    bucket_bytes: List[int],
    n_in: int,
    *,
    allow_salt: bool = False,
    min_parts: int = 1,
    decisions: Optional[Decisions] = None,
) -> Optional[ExchangePlan]:
    """Replan one exchange from its measured per-bucket bytes.

    Returns ``None`` (keep the static layout) when the exchange is
    below the replan floor or no rule changes anything. Coalescing
    bin-packs adjacent small buckets toward the advisory target size
    but never reduces the output below ``min_parts`` — the effective
    bin size is ``min(target, total/min_parts)`` so downstream
    parallelism survives small-data exchanges."""
    n = len(bucket_bytes)
    total = sum(bucket_bytes)
    if n <= 1 or total < min_exchange_bytes():
        return None
    mean = total / n
    hot = skew_ratio() * mean
    target = max(1, min(
        target_partition_bytes(),
        int(math.ceil(total / max(1, min_parts))),
    ))

    groups: List[tuple] = []
    cur: List[int] = []
    cur_bytes = 0
    salted = 0

    def flush() -> None:
        nonlocal cur, cur_bytes
        if cur:
            groups.append(("merge", cur))
            cur, cur_bytes = [], 0

    for i, b in enumerate(bucket_bytes):
        if allow_salt and n_in > 1 and b >= hot and b > mean:
            # Sub-part count sized so each sub-bucket lands near the
            # mean; bounded by the input-partition count because the
            # executor distributes the bucket's per-input chunks.
            k = min(
                max(2, int(round(b / max(mean, 1.0)))),
                max_salt_k(),
                n_in,
            )
            flush()
            groups.append(("split", i, k))
            salted += 1
            continue
        if b >= target:
            flush()
            groups.append(("merge", [i]))
            continue
        if cur and cur_bytes + b > target:
            flush()
        cur.append(i)
        cur_bytes += b
    flush()

    merged_away = sum(
        len(g[1]) - 1 for g in groups if g[0] == "merge"
    )
    if salted == 0 and merged_away == 0:
        return None
    plan = ExchangePlan(groups)
    if decisions is not None:
        if merged_away:
            decisions.record(
                "coalesce",
                f"{n}->{plan.n_out} buckets "
                f"(merged {merged_away} below {target}B)",
            )
            metrics.counter_add("aqe/coalesced_partitions", merged_away)
        if salted:
            decisions.record(
                "salt",
                f"split {salted} hot bucket(s) "
                f"(max {max(bucket_bytes)}B vs mean {int(mean)}B)",
            )
            metrics.counter_add("aqe/salted_keys", salted)
    return plan


def plan_rebalance(
    part_bytes: List[int],
    part_rows: List[int],
) -> Optional[Dict[int, int]]:
    """Input-partition slice plan for a skewed two-phase aggregation:
    ``{partition_index: k}`` for partitions whose measured bytes exceed
    the skew threshold, each to be replaced by ``k`` zero-copy row
    slices ahead of the partial-agg stage. Slices stay in partition
    order, so order-sensitive partials (collect_list) merge
    identically. ``None`` when balanced or below the replan floor."""
    n = len(part_bytes)
    total = sum(part_bytes)
    if n <= 1 or total < min_exchange_bytes():
        return None
    mean = total / n
    if mean <= 0 or max(part_bytes) / mean < skew_ratio():
        return None
    hot = skew_ratio() * mean
    plan: Dict[int, int] = {}
    for i, b in enumerate(part_bytes):
        if b < hot:
            continue
        k = min(
            max(2, int(round(b / max(mean, 1.0)))),
            max_salt_k(),
        )
        # A slice needs at least one row; unknown row counts (-1) are
        # unsliceable without materializing, so they stay whole.
        if part_rows[i] >= k:
            plan[i] = k
    return plan or None


def rule_counts(text: str) -> Dict[str, int]:
    """Count ``aqe[<rule>]`` markers in rendered plan text — the
    explain side of the annotation↔counter parity invariant."""
    out: Dict[str, int] = {}
    for m in _MARKER.finditer(text):
        out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def measured_frame_bytes(executor, parts, lineage=None) -> Tuple[int, str]:
    """Measured size of a frame's partitions for join planning.

    Settled partitions are sized directly (``part_nbytes`` reads ref
    metadata without materializing). When partitions are still pending
    streaming tasks, resolving them here would barrier the pipeline —
    instead fall back to the recorded output bytes of the stage that is
    producing them (the stage-stats feedback path); only if no stage has
    recorded yet do we resolve. Returns ``(bytes, source)`` where
    source is ``measured`` or ``recorded``."""
    from raydp_tpu_torch.dataframe.scheduler import all_settled
    from raydp_tpu_torch.telemetry.progress import stage_store

    if all_settled(parts):
        return sum(executor.part_nbytes(p) for p in parts), "measured"
    for node in reversed(lineage or []):
        ids = node.get("stage_ids") or []
        recorded = stage_store.output_bytes(ids)
        if recorded is not None:
            return recorded, "recorded"
    return sum(executor.part_nbytes(p) for p in parts), "measured"
