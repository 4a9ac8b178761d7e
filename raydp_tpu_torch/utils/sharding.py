"""Equal-samples-per-rank block sharding math.

The port's own copy of what its dataset needs from
``raydp_tpu/utils/sharding.py``: given blocks of varying sizes and a
data-parallel world size, every rank receives exactly
``ceil(total_samples / world_size)`` samples, the last rank padding by
wrapping to the head of the (optionally shuffled) block sequence, and
every row is covered at least once.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

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

