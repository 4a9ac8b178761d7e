"""Transformer family: BERT-style encoder, GLUE classifier, causal LM.

The counterpart of ``raydp_tpu/models/transformer.py``, with the same
module names and parameter tree (``params_from_flax`` in
``models/convert.py`` carries the flax parameters across). As in flax,
parameters are kept in ``param_dtype`` and every layer computes in
``cfg.dtype``; the classifier head and the LM head compute in float32.
LayerNorm epsilon is flax's 1e-6 and gelu is the tanh approximation.
Dropout sits where flax puts it and draws from the generator that
``set_dropout_generator`` hands the model (``models/dropout.py``).

Attention is ``dense`` (plain softmax attention) or ``flash`` (the
hand-written kernel on CUDA, its plain version on the CPU). Ring and
Ulysses attention, the mesh and ``remat`` arrive with later slices.

The decode KV cache is a preallocated ``(key, value)`` tensor pair per
layer, ``[slots, max_len, H, D]`` in ``cfg.dtype``. Prefill and decode
steps write it in place (the JAX package returns a new cache pytree
instead); rows are recycled without zeroing, and the length mask in
``cached_decode_attention`` keeps stale rows invisible.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.models.dropout import Dropout
from raydp_tpu_torch.ops.attention import (
    cached_decode_attention,
    reference_attention,
)
from raydp_tpu_torch.ops.flash_attention import flash_attention
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

ATTENTION_IMPLS = ("dense", "flash")

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 30522          # BERT wordpiece vocab
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 512
    n_segments: int = 2
    dropout_rate: float = 0.1
    causal: bool = False
    attention_impl: str = "dense"    # dense | flash
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} "
                f"(the port has {ATTENTION_IMPLS}; ring and ulysses come "
                "with the multi-GPU slice)"
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


class Dense(nn.Linear):
    """``nn.Linear`` over ``param_dtype`` weights that computes in
    ``dtype`` (flax ``Dense(dtype=..., param_dtype=...)``)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNorm(nn.LayerNorm):
    """Flax LayerNorm: f32 statistics, epsilon 1e-6, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__(features, eps=1e-6, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """Embedding table in ``param_dtype``, looked up into ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__(num, features, dtype=param_dtype)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers: xavier-uniform dense kernels, zero
    biases, N(0, 0.02) embeddings, unit LayerNorm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                nn.init.normal_(m.weight, std=0.02, generator=generator)
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()


class MultiHeadAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        hd = cfg.n_heads * cfg.head_dim
        # Fused q/k/v projection: flax's DenseGeneral kernel [E, 3, H, D]
        # flattened to a Linear of 3·H·D outputs.
        self.qkv = Dense(cfg.d_model, 3 * hd, cfg.dtype, cfg.param_dtype)
        self.out = Dense(hd, cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(
        self,
        x: torch.Tensor,
        *,
        cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        cache_mode: Optional[str] = None,
        cache_positions: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None,
        slots: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        # q, k, v stay strided views of the fused projection.
        qkv = self.qkv(x).view(b, s, 3, cfg.n_heads, cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)

        if cache_mode is not None:
            ck, cv = cache
            if cache_mode == "prefill":
                # The whole (padded) prompt lands in rows [0, S) of each
                # slot; rows past the true length hold junk until decode
                # overwrites them, always before the length mask admits
                # them.
                rows = torch.arange(b, device=x.device) if slots is None \
                    else slots
                ck[rows, :s] = k.to(ck.dtype)
                cv[rows, :s] = v.to(cv.dtype)
                out = reference_attention(q, k, v, causal=True)
            elif cache_mode == "step":
                rows = torch.arange(b, device=x.device)
                ck[rows, cache_positions] = k[:, 0].to(ck.dtype)
                cv[rows, cache_positions] = v[:, 0].to(cv.dtype)
                out = cached_decode_attention(
                    q, ck[:, :kv_len], cv[:, :kv_len], cache_positions + 1
                )
            else:
                raise ValueError(f"unknown cache_mode {cache_mode!r}")
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = reference_attention(q, k, v, causal=cfg.causal)

        out = self.out(out.reshape(b, s, cfg.n_heads * cfg.head_dim))
        return self.dropout(out)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.mlp_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, cfg.param_dtype)
        self.mlp_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype,
                              cfg.param_dtype)
        self.dropout = Dropout(cfg.dropout_rate)

    def forward(self, x: torch.Tensor, **cache_kw) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), **cache_kw)
        y = F.gelu(self.mlp_up(self.ln_mlp(x)), approximate="tanh")
        return x + self.dropout(self.mlp_down(y))


class TransformerEncoder(nn.Module):
    """Token + position (+ optional segment) embeddings, N blocks, final LN.

    Input: integer token ids [B, S] (+ optional segment ids). Output:
    [B, S, d_model] hidden states in ``cfg.dtype``. The segment table
    exists only where the model takes segment ids (``segments=True``), as
    flax creates it only when called with them.
    """

    def __init__(self, cfg: TransformerConfig, segments: bool = False):
        super().__init__()
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt, pdt)
        self.pos_embed = Embed(cfg.max_len, cfg.d_model, dt, pdt)
        self.seg_embed = (
            Embed(cfg.n_segments, cfg.d_model, dt, pdt) if segments else None
        )
        self.dropout = Dropout(cfg.dropout_rate)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg) for _ in range(cfg.n_layers)
        )
        self.ln_final = LayerNorm(cfg.d_model, dt, pdt)

    def forward(
        self,
        input_ids: torch.Tensor,
        segment_ids: Optional[torch.Tensor] = None,
        *,
        cache: Optional[KVCache] = None,
        cache_mode: Optional[str] = None,
        cache_positions: Optional[torch.Tensor] = None,
        kv_len: Optional[int] = None,
        slots: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        cfg = self.cfg
        x = self.tok_embed(input_ids)
        if cache_mode == "step":
            # Each slot's token sits at its own absolute position.
            pos = torch.clamp(cache_positions, max=cfg.max_len - 1)[:, None]
        else:
            pos = torch.arange(input_ids.shape[-1],
                               device=input_ids.device)[None, :]
        x = x + self.pos_embed(pos)
        if segment_ids is not None:
            if self.seg_embed is None:
                raise ValueError("this encoder takes no segment ids")
            x = x + self.seg_embed(segment_ids)
        x = self.dropout(x)
        for i, block in enumerate(self.blocks):
            x = block(
                x,
                cache=None if cache is None else cache[i],
                cache_mode=cache_mode,
                cache_positions=cache_positions,
                kv_len=kv_len,
                slots=slots,
            )
        return self.ln_final(x)


class SequenceClassifier(nn.Module):
    """Encoder + first-token pooler + classification head: the BERT-GLUE
    fine-tune model. Logits are float32."""

    def __init__(self, cfg: TransformerConfig, num_classes: int = 2, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg, segments=True)
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg.dtype,
                            cfg.param_dtype)
        self.head = Dense(cfg.d_model, num_classes, torch.float32,
                          cfg.param_dtype)
        init_params(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.encoder(input_ids, segment_ids)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return self.head(pooled)


class CausalLM(nn.Module):
    """Decoder-only LM with the serve plane's decode pair.

    Besides the teacher-forced ``forward``, :meth:`prefill` runs a prompt
    once, writing its KV rows into a cache from :meth:`init_cache` and
    returning the first greedy token's logits; :meth:`decode_step` extends
    every slot by one token against that cache.
    """

    def __init__(self, cfg: TransformerConfig, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not cfg.causal:
            raise ValueError("CausalLM requires cfg.causal=True")
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg)
        self.lm_head = Dense(cfg.d_model, cfg.vocab_size, torch.float32,
                             cfg.param_dtype)
        init_params(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.encoder(input_ids))

    def prefill(self, input_ids: torch.Tensor, lengths: torch.Tensor,
                cache: KVCache,
                slots: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Prompt pass that writes the KV cache.

        ``input_ids`` [B, S] right-padded prompts, ``lengths`` [B] true
        prompt lengths, ``slots`` [B] the cache rows to write (default
        ``0..B-1``). Returns the logits at each prompt's last real
        position, [B, V]."""
        h = self.encoder(input_ids, cache=cache, cache_mode="prefill",
                         slots=slots)
        last = torch.clamp(lengths - 1, min=0)
        rows = torch.arange(h.shape[0], device=h.device)
        return self.lm_head(h[rows, last])

    def decode_step(self, tokens: torch.Tensor,
                    cache_positions: torch.Tensor, kv_len: int,
                    cache: KVCache) -> torch.Tensor:
        """One decode iteration over the whole slot batch.

        ``tokens`` [B, 1] last token per slot, ``cache_positions`` [B] each
        slot's cache length (where the new token's K/V is written),
        ``kv_len`` the cache-length bucket attended over. Returns the
        next-token logits [B, V]."""
        h = self.encoder(tokens, cache=cache, cache_mode="step",
                         cache_positions=cache_positions, kv_len=kv_len)
        return self.lm_head(h)[:, 0]

    def init_cache(self, batch: int) -> KVCache:
        """A zeroed ``(key, value)`` pair per layer, [batch, max_len, H, D]."""
        cfg = self.cfg
        shape = (batch, cfg.max_len, cfg.n_heads, cfg.head_dim)

        def zeros():
            return torch.zeros(shape, dtype=cfg.dtype, device=self.device)

        return [(zeros(), zeros()) for _ in range(cfg.n_layers)]


# ---------------------------------------------------------------- factories

def bert_base(**overrides) -> TransformerConfig:
    """BERT-base (the GLUE fine-tune target)."""
    return TransformerConfig(**overrides)


def tiny_transformer(**overrides) -> TransformerConfig:
    """Small config for tests and dry runs."""
    defaults = dict(
        vocab_size=1024, d_model=128, n_heads=8, n_layers=2, d_ff=256,
        max_len=128, dropout_rate=0.0,
    )
    defaults.update(overrides)
    return TransformerConfig(**defaults)
