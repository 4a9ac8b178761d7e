"""Plain attention ops (the counterparts of ``raydp_tpu/ops/attention.py``).

All keep the JAX package's ``[B, S, H, D]`` layout at their interface.
They were XLA code in JAX and stay plain torch ops here; the sequence-
parallel ones (ring, Ulysses, and dense attention over gathered K/V) take
the port's mesh (``raydp_tpu_torch.parallel.Mesh``) and run their
collectives over its ``sp`` group
(``raydp_tpu_torch/parallel/collectives.py``).
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """Plain softmax attention. Shapes: [B, S, H, D] → [B, S, H, D]."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        s_q, s_k = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(
            (s_q, s_k), dtype=torch.bool, device=q.device
        ).tril(diagonal=s_k - s_q)
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def cached_decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    lengths: torch.Tensor,
) -> torch.Tensor:
    """Single-step decode attention over a per-slot KV cache.

    ``q`` is one new query per slot, [B, 1, H, D], attending over the first
    ``lengths[b]`` positions of its cache row ([B, T, H, D]). Positions at
    and beyond ``lengths[b]`` are masked, so stale rows from a slot's
    previous occupant never leak into a live sequence.
    """
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k_cache) * scale
    t = k_cache.shape[1]
    valid = torch.arange(t, device=q.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v_cache)


def _sp_group(mesh, axis_name: str):
    return None if mesh is None else mesh.group(axis_name)


def ring_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh=None,
    axis_name: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Sequence-parallel attention over a ring of ``axis_name`` peers
    (``raydp_tpu/ops/attention.py:73-138``).

    ``q``, ``k`` and ``v`` are this rank's block, ``[B, S/n, H, D]``: its
    dp rows and its ``n``-th of the positions. q stays; the K/V block
    rotates ``n - 1`` times by
    :func:`~raydp_tpu_torch.parallel.collectives.ring_shift` and is merged
    with an online-softmax accumulator, the causal mask on global
    positions. Memory a step is O(S/n): the sequence is never gathered.
    The backward is autograd's through the shifts (each shift's backward
    is the reverse shift), so it keeps each step's K/V block, as JAX's
    autodiff of its loop does. ``mesh`` None (or an axis of one rank) is
    plain attention on the rank's block."""
    from raydp_tpu_torch.parallel.collectives import (
        group_rank,
        group_size,
        ring_shift,
    )

    group = _sp_group(mesh, axis_name)
    n, rank = group_size(group), group_rank(group)
    b, s_l, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    q_pos = rank * s_l + torch.arange(s_l, device=q.device)

    def scores_for(t: int, k_t: torch.Tensor) -> torch.Tensor:
        # After t rotations this rank holds the block that started at
        # rank - t (mod n).
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k_t) * scale
        if causal:
            src = (rank - t) % n
            k_pos = src * s_l + torch.arange(s_l, device=q.device)
            mask = q_pos[:, None] >= k_pos[None, :]
            scores = scores.masked_fill(~mask, NEG_INF)
        return scores

    scores0 = scores_for(0, k)
    m = scores0.amax(dim=-1)
    p0 = torch.exp(scores0 - m[..., None])
    l = p0.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bhqd", p0, v)
    kv = torch.stack([k, v])
    for t in range(1, n):
        kv = ring_shift(kv, group)
        k_t, v_t = kv.unbind(0)
        scores = scores_for(t, k_t)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        correction = torch.exp(m - m_new)
        p = torch.exp(scores - m_new[..., None])
        l = l * correction + p.sum(dim=-1)
        o = o * correction[..., None] + torch.einsum("bhqk,bkhd->bhqd",
                                                     p, v_t)
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3)


def ulysses_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh=None,
    axis_name: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Head-sharded (DeepSpeed-Ulysses) sequence parallelism
    (``raydp_tpu/ops/attention.py:141-194``): an all_to_all turns this
    rank's ``[B, S/n, H, D]`` block into ``[B, S, H/n, D]``, plain
    attention runs on those heads, and the inverse all_to_all turns the
    result back. The rank's heads (its tp share) must divide by ``n``."""
    from raydp_tpu_torch.parallel.collectives import all_to_all, group_size

    group = _sp_group(mesh, axis_name)
    n = group_size(group)
    if q.shape[2] % n != 0:
        raise ValueError(
            f"ulysses needs heads ({q.shape[2]}) divisible by sp ({n})")
    q_h, k_h, v_h = (all_to_all(x, 2, 1, group) for x in (q, k, v))
    out = reference_attention(q_h, k_h, v_h, causal=causal)
    return all_to_all(out, 1, 2, group)


def gathered_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mesh=None,
    axis_name: str = "sp",
    causal: bool = False,
) -> torch.Tensor:
    """Dense attention of this rank's queries over the whole sequence:
    K and V are all-gathered over ``axis_name`` (what XLA does for the
    JAX package's dense attention on sequence-sharded inputs), the
    causal mask on global positions."""
    from raydp_tpu_torch.parallel.collectives import all_gather, group_rank

    group = _sp_group(mesh, axis_name)
    s_l = q.shape[1]
    kf, vf = all_gather(k, 1, group), all_gather(v, 1, group)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bqhd,bkhd->bhqk", q, kf) * scale
    if causal:
        q_pos = group_rank(group) * s_l + torch.arange(s_l, device=q.device)
        k_pos = torch.arange(kf.shape[1], device=q.device)
        scores = scores.masked_fill(~(q_pos[:, None] >= k_pos[None, :]),
                                    float("-inf"))
    weights = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights, vf)
