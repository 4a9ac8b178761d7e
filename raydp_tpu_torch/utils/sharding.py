"""Equal-samples-per-rank block sharding math.

The port's own copy of what its dataset needs from
``raydp_tpu/utils/sharding.py``: given blocks of varying sizes and a
data-parallel world size, every rank receives exactly
``ceil(total_samples / world_size)`` samples, the last rank padding by
wrapping to the head of the (optionally shuffled) block sequence, and
every row is covered at least once. :func:`divide_blocks_local` keeps
the same invariants while each rank drains the blocks of its own node
first, and :func:`locality_fraction` scores a plan by the share of
samples read on the node that holds them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class BlockSlice:
    """Rows ``[offset, offset + num_samples)`` of block ``block_index``."""

    block_index: int
    num_samples: int
    offset: int = 0


def divide_blocks(
    blocks: Sequence[int],
    world_size: int,
    shuffle: bool = False,
    shuffle_seed: Optional[int] = None,
) -> Dict[int, List[BlockSlice]]:
    """Assign block slices to ranks: rank r owns the contiguous span
    ``[r * per_rank, (r + 1) * per_rank)`` of the global row sequence that
    the (optionally seeded-shuffled) block order defines, the final rank
    wrapping around to the sequence head for padding."""
    blocks = list(blocks)
    if world_size <= 0:
        raise ValueError("world_size must be positive")
    if len(blocks) < world_size:
        raise ValueError(
            f"not enough blocks ({len(blocks)}) to divide across "
            f"world_size={world_size}"
        )
    if any(b < 0 for b in blocks):
        raise ValueError("block sizes must be non-negative")

    total = sum(blocks)
    if total == 0:
        raise ValueError("dataset has no rows")
    samples_per_rank = math.ceil(total / world_size)

    order = list(range(len(blocks)))
    if shuffle:
        rng = np.random.default_rng(
            0 if shuffle_seed is None else shuffle_seed
        )
        rng.shuffle(order)

    starts = []
    pos = 0
    for b in order:
        starts.append(pos)
        pos += blocks[b]

    def span_slices(lo: int, hi: int) -> List[BlockSlice]:
        """Slices covering global rows [lo, hi)."""
        out: List[BlockSlice] = []
        for b, start in zip(order, starts):
            s_lo = max(lo, start)
            s_hi = min(hi, start + blocks[b])
            if s_lo < s_hi:
                out.append(BlockSlice(b, s_hi - s_lo, s_lo - start))
        return out

    assignment: Dict[int, List[BlockSlice]] = {}
    for rank in range(world_size):
        lo = rank * samples_per_rank
        hi = min(lo + samples_per_rank, total)
        plan = span_slices(lo, hi)
        short = samples_per_rank - (hi - lo)
        if short > 0:  # final rank pads by wrapping to the sequence head
            plan += span_slices(0, short)
        assignment[rank] = plan
    return assignment



def divide_blocks_local(
    blocks: Sequence[int],
    world_size: int,
    block_nodes: Sequence[str],
    rank_nodes: Sequence[str],
    shuffle: bool = False,
    shuffle_seed: Optional[int] = None,
) -> Dict[int, List[BlockSlice]]:
    """Locality-preferring variant of :func:`divide_blocks`.

    Each rank drains blocks living on ITS OWN node before touching remote
    ones (the reference's locality-preferring shard selection,
    reference: python/raydp/spark/dataset.py:411-443 to_torch +
    rdd/RayDatasetRDD.scala:53-55 getPreferredLocations). Invariants are
    identical to divide_blocks: exactly ``ceil(total/world)`` samples per
    rank, full coverage, in-bounds slices, deterministic under a seed.

    When data is balanced across nodes proportionally to the ranks on
    them, every byte stays node-local; imbalance spills the minimum
    possible remainder to remote ranks.
    """
    blocks = list(blocks)
    if world_size <= 0:
        raise ValueError("world_size must be positive")
    if len(rank_nodes) != world_size:
        raise ValueError("rank_nodes must have world_size entries")
    if len(block_nodes) != len(blocks):
        raise ValueError("block_nodes must have one entry per block")
    if len(blocks) < world_size:
        raise ValueError(
            f"not enough blocks ({len(blocks)}) to divide across "
            f"world_size={world_size}"
        )
    total = sum(blocks)
    if total == 0:
        raise ValueError("dataset has no rows")
    samples_per_rank = math.ceil(total / world_size)

    # Per-node pools of block indices, consumed front to back.
    pools: Dict[str, List[int]] = {}
    for i, node in enumerate(block_nodes):
        pools.setdefault(node, []).append(i)
    if shuffle:
        rng = np.random.default_rng(
            0 if shuffle_seed is None else shuffle_seed
        )
        for lst in pools.values():
            rng.shuffle(lst)
    consumed = [0] * len(blocks)  # rows of each block already assigned

    def take_from(pool: List[int], want: int, plan: List[BlockSlice]) -> int:
        """Move up to ``want`` rows out of ``pool`` into ``plan``."""
        got = 0
        while pool and got < want:
            b = pool[0]
            avail = blocks[b] - consumed[b]
            if avail <= 0:
                pool.pop(0)
                continue
            n = min(avail, want - got)
            plan.append(BlockSlice(b, n, consumed[b]))
            consumed[b] += n
            got += n
            if consumed[b] >= blocks[b]:
                pool.pop(0)
        return got

    def remaining(pool: List[int]) -> int:
        return sum(blocks[b] - consumed[b] for b in pool)

    assignment: Dict[int, List[BlockSlice]] = {}
    for rank in range(world_size):
        node = rank_nodes[rank]
        plan: List[BlockSlice] = []
        need = samples_per_rank
        need -= take_from(pools.get(node, []), need, plan)
        # Remote spill: drain the fullest remaining pools first so the
        # leftover stays balanced for later ranks.
        while need > 0:
            candidates = [
                (n, p) for n, p in pools.items() if p and n != node
            ] or [(n, p) for n, p in pools.items() if p]
            if not candidates:
                break
            _, pool = max(candidates, key=lambda np_: remaining(np_[1]))
            need -= take_from(pool, need, plan)
        if need > 0:
            # All rows are assigned; pad by re-reading rows this rank
            # already holds (or the largest block when its plan is empty —
            # only possible when every pool drained before this rank).
            source = [s for s in plan if s.num_samples > 0]
            if not source:
                big = int(np.argmax(blocks))
                source = [
                    BlockSlice(big, min(samples_per_rank, blocks[big]), 0)
                ]
            i = 0
            while need > 0:
                s = source[i % len(source)]
                n = min(need, s.num_samples)
                plan.append(BlockSlice(s.block_index, n, s.offset))
                need -= n
                i += 1
        assignment[rank] = plan
    return assignment


def locality_fraction(
    assignment: Dict[int, List[BlockSlice]],
    block_nodes: Sequence[str],
    rank_nodes: Sequence[str],
) -> float:
    """Fraction of assigned samples that are node-local to their rank."""
    local = 0
    total = 0
    for rank, plan in assignment.items():
        for s in plan:
            total += s.num_samples
            if block_nodes[s.block_index] == rank_nodes[rank]:
                local += s.num_samples
    return local / max(1, total)


def assignment_sample_counts(
    assignment: Dict[int, List[BlockSlice]],
) -> Dict[int, int]:
    """Samples each rank's plan holds."""
    return {r: sum(s.num_samples for s in plan)
            for r, plan in assignment.items()}


def split_sizes(total: int, parts: int) -> Tuple[int, ...]:
    """Split ``total`` rows into ``parts`` near-equal contiguous chunk sizes."""
    if parts <= 0:
        raise ValueError("parts must be positive")
    base, extra = divmod(total, parts)
    return tuple(base + (1 if i < extra else 0) for i in range(parts))
