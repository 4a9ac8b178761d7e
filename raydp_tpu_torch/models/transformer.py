"""Transformer family: BERT-style encoder, GLUE classifier, causal LM.

The counterpart of ``raydp_tpu/models/transformer.py``, with the same
module names and parameter tree (``params_from_flax`` in
``models/convert.py`` carries the flax parameters across). As in flax,
parameters are kept in ``param_dtype`` and every layer computes in
``cfg.dtype``; the classifier head and the LM head compute in float32.
LayerNorm epsilon is flax's 1e-6 and gelu is the tanh approximation.
Dropout sits where flax puts it and draws from the generator that
``set_dropout_generator`` hands the model (``models/dropout.py``).

Attention is ``dense`` (plain softmax attention), ``flash`` (the
hand-written kernel on CUDA, its plain version on the CPU), ``ring`` or
``ulysses`` (sequence parallel over the mesh's ``sp`` axis,
``ops/attention.py``). ``remat`` checkpoints every encoder block
(:func:`checkpoint_block`): its activations are recomputed in the
backward instead of kept.

**Model parallelism** (``raydp_tpu/models/transformer.py:105-190,
235-246, 277-296, 342-355, 465-494``). Every parameter declares the
logical axes of the flax parameter it carries (``logical_axes`` on its
layer); :data:`LOGICAL_RULES` lowers them onto the mesh and
:func:`~raydp_tpu_torch.parallel.mesh.shard_module` cuts each parameter
to this rank's block and binds the mesh (a ``cfg.mesh`` that is a built
:class:`~raydp_tpu_torch.parallel.mesh.Mesh` does it at construction;
the estimator does it for its mesh). Megatron tensor parallelism follows
from the axes: ``qkv`` (heads) and ``mlp_up`` (mlp) are column-parallel,
their input passing :func:`~raydp_tpu_torch.parallel.collectives.copy_to_region`;
``out`` and ``mlp_down`` are row-parallel, their partial products summed
by :func:`~raydp_tpu_torch.parallel.collectives.reduce_from_region`
before the bias. A rank computes its heads only, so the flash kernel
runs on them unchanged. The biases of ``qkv`` and ``mlp_up`` are cut
with their kernels: the JAX package replicates them, but a rank's block
is all its heads touch, and a replicated bias would get a different
gradient on every tp rank. With ``sp > 1`` the encoder takes the whole
sequence and keeps this rank's positions; attention is the ring, Ulysses
or (``dense``) dense attention over gathered K/V; the classifier's first
token is this sp axis's rank 0's, summed over sp; the LM gathers its
hidden states over sp before the head. ``pos_embed``'s ``seq`` axis maps
to sp in the JAX package, but the port keeps the table whole on every
rank: a rank's positions fall in another rank's block of the table
whenever the sequence is shorter than ``max_len``, and the table is
small. The decode cache does not run on a mesh.

The decode KV cache is a preallocated ``(key, value)`` tensor pair per
layer, ``[slots, max_len, H, D]`` in ``cfg.dtype``. Prefill and decode
steps write it in place (the JAX package returns a new cache pytree
instead); rows are recycled without zeroing, and the length mask in
``cached_decode_attention`` keeps stale rows invisible.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from raydp_tpu_torch.models.dropout import Dropout, MaskTape
from raydp_tpu_torch.ops.attention import (
    cached_decode_attention,
    gathered_attention,
    reference_attention,
    ring_attention,
    ulysses_attention,
)
from raydp_tpu_torch.ops.flash_attention import flash_attention
from raydp_tpu_torch.parallel import collectives as C
from raydp_tpu_torch.parallel.mesh import (
    Mesh,
    Placement,
    param_placements,
    shard_module,
)
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

ATTENTION_IMPLS = ("dense", "flash", "ring", "ulysses")

# Logical axis → mesh axis, the JAX transformer's
# (raydp_tpu/models/transformer.py:39-50). None keeps the axis replicated.
LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("seq", "sp"),
    ("vocab", None),
    ("embed", None),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("pooled", None),
    ("stage", "pp"),  # stacked pipeline-stage axis (models/pipelined.py)
    ("expert", "dp"),  # MoE expert axis shards over dp (models/moe.py)
)

# A layer's logical axes: parameter name → (axes, view), the axes naming
# the dimensions of ``view`` (the parameter regrouped) or, with view
# None, of the parameter itself.
LogicalAxes = Dict[str, Tuple[Tuple[Optional[str], ...],
                              Optional[Tuple[int, ...]]]]

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
    attention_impl: str = "dense"    # dense | flash | ring | ulysses
    remat: bool = False              # checkpoint blocks (memory-bound fits)
    dtype: torch.dtype = torch.bfloat16        # compute dtype
    param_dtype: torch.dtype = torch.float32
    # A built Mesh shards the model at construction; a MeshSpec (or None)
    # leaves that to the estimator's mesh.
    mesh: Any = None

    def __post_init__(self):
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ValueError(
                f"unknown attention_impl {self.attention_impl!r} "
                f"(the port has {ATTENTION_IMPLS})"
            )
        if self.d_model % self.n_heads:
            raise ValueError(
                f"d_model {self.d_model} not divisible by n_heads "
                f"{self.n_heads}"
            )

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def layer_axes(cfg: TransformerConfig) -> Dict[str, LogicalAxes]:
    """The logical axes of every layer of the family, by the layer's
    attribute name: the flax kernels' partitioning metadata in the port's
    layouts (a Linear weight is the flax kernel transposed; the fused
    ``qkv`` and ``out`` weights are seen through their flax shapes). The
    one table the modules and ``models/convert.py`` read."""
    h, d, e = cfg.n_heads, cfg.head_dim, cfg.d_model
    return {
        "qkv": {"weight": ((None, "heads", "kv", "embed"), (3, h, d, e)),
                "bias": ((None, "heads", "kv"), (3, h, d))},
        "out": {"weight": (("embed", "heads", "kv"), (e, h, d))},
        "mlp_up": {"weight": (("mlp", "embed"), None),
                   "bias": (("mlp",), None)},
        "mlp_down": {"weight": (("embed", "mlp"), None)},
        "tok_embed": {"weight": (("vocab", "embed"), None)},
        # Kept whole over sp (the module docstring).
        "pos_embed": {"weight": ((None, "embed"), None)},
        "seg_embed": {"weight": ((None, "embed"), None)},
        "pooler": {"weight": (("pooled", "embed"), None)},
        "head": {"weight": ((None, "embed"), None)},
        "lm_head": {"weight": (("vocab", "embed"), None)},
    }


class Dense(nn.Linear):
    """``nn.Linear`` over ``param_dtype`` weights that computes in
    ``dtype`` (flax ``Dense(dtype=..., param_dtype=...)``). ``axes`` are
    its parameters' logical axes (flax's partitioning metadata)."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype, param_dtype: torch.dtype,
                 axes: Optional[LogicalAxes] = None):
        super().__init__(in_features, out_features, dtype=param_dtype)
        self.compute_dtype = dtype
        self.logical_axes = axes or {}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))

    def row_parallel(self, x: torch.Tensor, group) -> torch.Tensor:
        """The layer with its input features cut over ``group``: this
        rank's partial product, summed over the group, then the bias."""
        if group is None:
            return self(x)
        dt = self.compute_dtype
        partial = F.linear(x.to(dt), self.weight.to(dt))
        return C.reduce_from_region(partial, group) + self.bias.to(dt)


class LayerNorm(nn.LayerNorm):
    """Flax LayerNorm: f32 statistics, epsilon 1e-6, output in ``dtype``."""

    def __init__(self, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype):
        super().__init__(features, eps=1e-6, dtype=param_dtype)
        self.compute_dtype = dtype
        self.logical_axes = {"weight": (("embed",), None)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape,
                         self.weight.float(), self.bias.float(), self.eps)
        return y.to(self.compute_dtype)


class Embed(nn.Embedding):
    """Embedding table in ``param_dtype``, looked up into ``dtype``."""

    def __init__(self, num: int, features: int, dtype: torch.dtype,
                 param_dtype: torch.dtype,
                 axes: Optional[LogicalAxes] = None):
        super().__init__(num, features, dtype=param_dtype)
        self.compute_dtype = dtype
        self.logical_axes = axes or {}

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return super().forward(ids).to(self.compute_dtype)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """The JAX package's initialisers: xavier-uniform dense kernels, zero
    biases, N(0, 0.02) embeddings, unit LayerNorm scales."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_uniform_(m.weight, generator=generator)
                if m.bias is not None:
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
        h, d, e = cfg.n_heads, cfg.head_dim, cfg.d_model
        axes = layer_axes(cfg)
        # Fused q/k/v projection: flax's DenseGeneral kernel [E, 3, H, D]
        # flattened to a Linear of 3·H·D outputs.
        self.qkv = Dense(e, 3 * h * d, cfg.dtype, cfg.param_dtype,
                         axes=axes["qkv"])
        self.out = Dense(h * d, e, cfg.dtype, cfg.param_dtype,
                         axes=axes["out"])
        self.dropout = Dropout(cfg.dropout_rate)
        # This rank's heads and the mesh's groups (bind_mesh).
        self.heads = h
        self.mesh: Optional[Mesh] = None
        self.tp_group = self.sp_group = None

    def bind_mesh(self, mesh: Mesh) -> None:
        """Run on ``mesh``: the heads this rank's (possibly cut) ``qkv``
        holds, and the tp and sp groups."""
        self.mesh = mesh
        self.heads = self.qkv.weight.shape[0] // (3 * self.cfg.head_dim)
        self.tp_group = (mesh.group("tp") if self.heads != self.cfg.n_heads
                         else None)
        self.sp_group = mesh.group("sp")

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
        x = C.copy_to_region(x, self.tp_group)
        qkv = self.qkv(x).view(b, s, 3, self.heads, cfg.head_dim)
        q, k, v = qkv.unbind(dim=2)

        if cache_mode is not None:
            if self.tp_group is not None or self.sp_group is not None:
                raise ValueError("the decode cache does not run on a mesh")
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
        elif cfg.attention_impl == "ring":
            out = ring_attention(q, k, v, self.mesh, causal=cfg.causal)
        elif cfg.attention_impl == "ulysses":
            out = ulysses_attention(q, k, v, self.mesh, causal=cfg.causal)
        elif self.sp_group is not None:
            if cfg.attention_impl == "flash":
                raise ValueError(
                    "flash attention runs on whole sequences: with sp > 1 "
                    "use attention_impl='ring' or 'ulysses'")
            out = gathered_attention(q, k, v, self.mesh, causal=cfg.causal)
        elif cfg.attention_impl == "flash":
            out = flash_attention(q, k, v, causal=cfg.causal)
        else:
            out = reference_attention(q, k, v, causal=cfg.causal)

        out = self.out.row_parallel(
            out.reshape(b, s, self.heads * cfg.head_dim), self.tp_group)
        return self.dropout(out)


class TransformerBlock(nn.Module):
    """Pre-LN encoder block."""

    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.ln_attn = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        self.attn = MultiHeadAttention(cfg)
        self.ln_mlp = LayerNorm(cfg.d_model, cfg.dtype, cfg.param_dtype)
        axes = layer_axes(cfg)
        self.mlp_up = Dense(cfg.d_model, cfg.d_ff, cfg.dtype, cfg.param_dtype,
                            axes=axes["mlp_up"])
        self.mlp_down = Dense(cfg.d_ff, cfg.d_model, cfg.dtype,
                              cfg.param_dtype, axes=axes["mlp_down"])
        self.dropout = Dropout(cfg.dropout_rate)
        self.d_ff = cfg.d_ff
        self.tp_group = None

    def bind_mesh(self, mesh: Mesh) -> None:
        self.tp_group = (mesh.group("tp")
                         if self.mlp_up.weight.shape[0] != self.d_ff
                         else None)

    def forward(self, x: torch.Tensor, **cache_kw) -> torch.Tensor:
        x = x + self.attn(self.ln_attn(x), **cache_kw)
        y = C.copy_to_region(self.ln_mlp(x), self.tp_group)
        y = F.gelu(self.mlp_up(y), approximate="tanh")
        return x + self.dropout(self.mlp_down.row_parallel(y, self.tp_group))


def checkpoint_block(block: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``block(x)`` under ``torch.utils.checkpoint``: its activations are
    dropped after the forward and recomputed in the backward (flax's
    ``nn.remat``).

    The recompute must apply the forward's dropout masks, or the
    gradients belong to other masks than the loss. ``checkpoint`` restores
    only the default generators, and the port's dropout draws from an
    explicit one (``models/dropout.py``). Rewinding that generator for the
    recompute cannot be done inside the scan path's CUDA graph: there the
    generator is registered with the graph, ``set_state`` raises while
    capturing, ``graphsafe_get_state`` shares the live state rather than
    copying it, and a ``clone_state`` copy is not registered, so no draw
    can be made from it during capture. So the forward's keep-masks are
    kept instead (one byte an element, against the block's activations in
    ``cfg.dtype``) and the recompute reads them back
    (:class:`~raydp_tpu_torch.models.dropout.MaskTape`). The generator
    advances once per forward, as without remat."""
    tape = MaskTape()
    drops = [m for m in block.modules() if isinstance(m, Dropout)]

    def run(h: torch.Tensor) -> torch.Tensor:
        tape.cursor = 0
        for d in drops:
            d.tape = tape
        try:
            return block(h)
        finally:
            for d in drops:
                d.tape = None
            tape.replaying = True

    return torch.utils.checkpoint.checkpoint(
        run, x, use_reentrant=False, preserve_rng_state=False)


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
        axes = layer_axes(cfg)
        self.tok_embed = Embed(cfg.vocab_size, cfg.d_model, dt, pdt,
                               axes=axes["tok_embed"])
        self.pos_embed = Embed(cfg.max_len, cfg.d_model, dt, pdt,
                               axes=axes["pos_embed"])
        self.seg_embed = (
            Embed(cfg.n_segments, cfg.d_model, dt, pdt,
                  axes=axes["seg_embed"])
            if segments else None
        )
        self.dropout = Dropout(cfg.dropout_rate)
        self.blocks = nn.ModuleList(
            TransformerBlock(cfg) for _ in range(cfg.n_layers)
        )
        self.ln_final = LayerNorm(cfg.d_model, dt, pdt)
        self.sp_group = None
        self.sp_rank = 0

    def bind_mesh(self, mesh: Mesh) -> None:
        self.sp_group = mesh.group("sp")
        self.sp_rank = mesh.coords["sp"]

    def _local_positions(self, *seqs: Optional[torch.Tensor]):
        """With sp > 1: this rank's block of each ``[B, S]`` input and the
        global offset of its first position."""
        n = C.group_size(self.sp_group)
        if n == 1:
            return seqs, 0
        s = seqs[0].shape[-1]
        if s % n:
            raise ValueError(f"sequence {s} does not divide over sp={n}")
        s_l = s // n
        lo = self.sp_rank * s_l
        return tuple(None if t is None else t[..., lo:lo + s_l]
                     for t in seqs), lo

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
        if cache_mode is not None and cfg.remat:
            raise ValueError("decode cache is incompatible with remat")
        (input_ids, segment_ids), lo = self._local_positions(input_ids,
                                                            segment_ids)
        x = self.tok_embed(input_ids)
        if cache_mode == "step":
            # Each slot's token sits at its own absolute position.
            pos = torch.clamp(cache_positions, max=cfg.max_len - 1)[:, None]
        else:
            pos = lo + torch.arange(input_ids.shape[-1],
                                    device=input_ids.device)[None, :]
        x = x + self.pos_embed(pos)
        if segment_ids is not None:
            if self.seg_embed is None:
                raise ValueError("this encoder takes no segment ids")
            x = x + self.seg_embed(segment_ids)
        x = self.dropout(x)
        if cfg.remat and torch.is_grad_enabled():
            for block in self.blocks:
                x = checkpoint_block(block, x)
            return self.ln_final(x)
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

    @startup.timed("model")
    def __init__(self, cfg: TransformerConfig, num_classes: int = 2, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = TransformerEncoder(cfg, segments=True)
        axes = layer_axes(cfg)
        self.pooler = Dense(cfg.d_model, cfg.d_model, cfg.dtype,
                            cfg.param_dtype, axes=axes["pooler"])
        self.head = Dense(cfg.d_model, num_classes, torch.float32,
                          cfg.param_dtype, axes=axes["head"])
        init_params(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)
        _shard_at_construction(self)

    def forward(self, input_ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.encoder(input_ids, segment_ids)
        enc = self.encoder
        first = h[:, 0]
        if enc.sp_group is not None:
            # The first token is sp rank 0's; the others add zeros.
            first = C.reduce_from_region(
                first * (1.0 if enc.sp_rank == 0 else 0.0), enc.sp_group)
        pooled = torch.tanh(self.pooler(first))
        return self.head(pooled)


class CausalLM(nn.Module):
    """Decoder-only LM with the serve plane's decode pair.

    Besides the teacher-forced ``forward``, :meth:`prefill` runs a prompt
    once, writing its KV rows into a cache from :meth:`init_cache` and
    returning the first greedy token's logits; :meth:`decode_step` extends
    every slot by one token against that cache.
    """

    @startup.timed("model")
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
                             cfg.param_dtype, axes=layer_axes(cfg)["lm_head"])
        init_params(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)
        _shard_at_construction(self)

    @property
    def device(self) -> torch.device:
        return self.lm_head.weight.device

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        # With sp > 1 every rank gets the whole sequence's logits.
        h = C.all_gather(self.encoder(input_ids), 1, self.encoder.sp_group)
        return self.lm_head(h)

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


# ------------------------------------------------------------- shardings

def param_shardings(model: nn.Module, mesh,
                    rules=LOGICAL_RULES) -> Dict[str, Placement]:
    """Every parameter's placement on ``mesh`` from its logical axes (the
    JAX package's ``param_shardings``, without the abstract init: the
    port's model exists already). Every port mesh has all four axes, so
    the JAX package's ``effective_rules`` has nothing to restrict."""
    return param_placements(model, mesh, rules)


def _shard_at_construction(model: nn.Module) -> None:
    if isinstance(model.cfg.mesh, Mesh):
        shard_module(model, model.cfg.mesh, LOGICAL_RULES)
