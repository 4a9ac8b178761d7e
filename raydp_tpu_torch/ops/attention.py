"""Plain attention ops (the counterparts of ``raydp_tpu/ops/attention.py``).

Both keep the JAX package's ``[B, S, H, D]`` layout at their interface.
They were XLA code in JAX and stay plain torch ops here. Ring and Ulysses
attention arrive with the multi-GPU slice.
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
