"""DLRM: deep learning recommendation model (the Criteo CTR config).

The counterpart of ``raydp_tpu/models/dlrm.py`` on one device, with the
same module names and parameter tree (``params_from_flax`` carries the
flax parameters across): a bottom MLP over the dense features, one
embedding table per categorical feature (one id, or a multi-hot bag
pooled by sum or mean), a dot-product feature interaction over the
strict lower triangle, a top MLP and a float32 CTR logit. The trunk
computes in ``cfg.dtype`` over ``param_dtype`` parameters.

Embedding lookups (``ShardedEmbedding``):

* ``take`` gathers the rows, then casts them to ``cfg.dtype`` (the same
  values as casting the table first, without a cast of every row each
  step);
* ``onehot`` contracts the pooled ``[B, V]`` bag indicator with the
  table, as the JAX package does on an accelerator.

``"auto"`` resolves to ``take`` here. The JAX package picks ``onehot``
for vocabularies of 8192 and more on an accelerator
(``raydp_tpu/models/dlrm.py:73-89``): the contraction runs on the MXU and
gives GSPMD a contracting dim to shard the table over ``tp``. On one card
the tables are replicated, so that reason does not hold, and at
``criteo_dlrm``'s 26 × 100k vocabularies and batch 1024 the one-hot
operand would be 205 MB a table in bf16 for the same sums. The rule comes
back when tables shard over several cards (ROADMAP Queue A, item 9),
with ``LOGICAL_RULES`` and ``dlrm_shardings``. Ids out of a table's range
are an error here (``jnp.take`` fills them with NaN).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from raydp_tpu_torch.models.transformer import Dense, init_params
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

EMBEDDING_IMPLS = ("take", "onehot")


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    """Criteo-shaped defaults: 13 dense features, 26 categorical tables."""

    dense_features: int = 13
    vocab_sizes: Tuple[int, ...] = tuple([100_000] * 26)
    embed_dim: int = 128
    bottom_mlp: Tuple[int, ...] = (512, 256, 128)
    top_mlp: Tuple[int, ...] = (1024, 1024, 512, 256)
    interaction: str = "dot"                 # dot | cat
    embedding_impl: str = "auto"             # auto | take | onehot
    pooling: str = "sum"                     # sum | mean (multi-hot bags)
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @property
    def n_tables(self) -> int:
        return len(self.vocab_sizes)

    def impl_for(self, vocab: int) -> str:
        """The lookup of a table of ``vocab`` rows: ``embedding_impl``, or
        ``take`` for ``"auto"`` while tables are replicated (the module
        docstring)."""
        return "take" if self.embedding_impl == "auto" else \
            self.embedding_impl


class ShardedEmbedding(nn.Module):
    """One embedding table. ``ids`` is ``[B]`` (one id) or ``[B, L]`` (a
    multi-hot bag, pooled by ``pooling``); the output is ``[B, D]`` in
    ``dtype``. The name is the JAX module's; on one card the table is
    whole."""

    def __init__(self, vocab_size: int, embed_dim: int, impl: str = "take",
                 pooling: str = "sum", dtype: torch.dtype = torch.bfloat16,
                 param_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if impl not in EMBEDDING_IMPLS:
            raise ValueError(f"unknown embedding impl {impl!r}")
        self.vocab_size, self.embed_dim = vocab_size, embed_dim
        self.impl, self.pooling, self.dtype = impl, pooling, dtype
        self.table = nn.Parameter(torch.empty(vocab_size, embed_dim,
                                              dtype=param_dtype))
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            nn.init.normal_(self.table, std=1.0 / math.sqrt(self.embed_dim),
                            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        squeeze = ids.ndim == 1
        if squeeze:
            ids = ids[:, None]                  # [B, 1]: one form for both
        if self.impl == "onehot":
            # The bag is pooled inside the contraction: the [B, V]
            # operand is the summed indicator of the bag's ids.
            vocab = torch.arange(self.vocab_size, device=ids.device)
            bag = (ids[..., None] == vocab).to(self.dtype).sum(dim=1)
            out = bag @ self.table.to(self.dtype)
        else:
            # index_select's backward is one index_add_, which a CUDA
            # graph can capture.
            rows = torch.index_select(self.table, 0, ids.reshape(-1))
            out = rows.to(self.dtype).reshape(
                ids.shape + (self.embed_dim,)).sum(dim=1)
        if self.pooling == "mean" and not squeeze:
            out = out / ids.shape[1]
        return out


class DotInteraction(nn.Module):
    """Pairwise dot products of the feature vectors ``[B, F, D]``: the
    strict lower triangle in row-major order (numpy's ``tril_indices``),
    ``[B, F·(F-1)/2]``."""

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        z = torch.bmm(feats, feats.transpose(1, 2))
        f = feats.shape[1]
        li, lj = torch.tril_indices(f, f, -1, device=feats.device)
        return z[:, li, lj]


class DLRM(nn.Module):
    """Bottom MLP + one embedding per categorical feature + interaction +
    top MLP → CTR logit ``[B]`` in float32. ``forward(dense, sparse)``:
    ``dense`` ``[B, dense_features]`` floats, ``sparse`` int ids
    ``[B, n_tables]`` or bags ``[B, n_tables, L]``."""

    def __init__(self, cfg: DLRMConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        if cfg.bottom_mlp[-1] != cfg.embed_dim:
            raise ValueError("bottom MLP output width must equal embed_dim "
                             f"({cfg.bottom_mlp[-1]} != {cfg.embed_dim})")
        if cfg.interaction not in ("dot", "cat"):
            raise ValueError(f"unknown interaction {cfg.interaction!r}")
        self.cfg = cfg
        dt, pdt = cfg.dtype, cfg.param_dtype
        gen = generator or torch.Generator().manual_seed(0)
        widths = (cfg.dense_features,) + tuple(cfg.bottom_mlp)
        self.bottom = nn.ModuleList(
            Dense(a, b, dt, pdt) for a, b in zip(widths[:-1], widths[1:]))
        self.emb = nn.ModuleList(
            ShardedEmbedding(v, cfg.embed_dim, impl=cfg.impl_for(v),
                             pooling=cfg.pooling, dtype=dt, param_dtype=pdt,
                             generator=gen)
            for v in cfg.vocab_sizes)
        n_feat = 1 + cfg.n_tables
        if cfg.interaction == "dot":
            self.interaction = DotInteraction()
            top_in = cfg.embed_dim + n_feat * (n_feat - 1) // 2
        else:
            top_in = n_feat * cfg.embed_dim
        widths = (top_in,) + tuple(cfg.top_mlp)
        self.top = nn.ModuleList(
            Dense(a, b, dt, pdt) for a, b in zip(widths[:-1], widths[1:]))
        self.logit = Dense(widths[-1], 1, torch.float32, pdt)
        init_params(self, gen)
        self.to(dev)

    def forward(self, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
        x = dense.to(self.cfg.dtype)
        for layer in self.bottom:
            x = torch.relu(layer(x))
        embs = [table(sparse[:, t]) for t, table in enumerate(self.emb)]
        feats = torch.stack([x] + embs, dim=1)           # [B, 1 + T, D]
        if self.cfg.interaction == "dot":
            top = torch.cat([x, self.interaction(feats)], dim=-1)
        else:
            top = feats.reshape(feats.shape[0], -1)
        for layer in self.top:
            top = torch.relu(layer(top))
        return self.logit(top)[:, 0]


class PackedDLRM(nn.Module):
    """DLRM over one packed feature matrix ``[B, dense_features +
    n_tables]``: the dense floats first, then the categorical ids
    (float-encoded by the tabular path, cast back to int here). The form
    an ``Estimator`` over dataset columns feeds."""

    def __init__(self, cfg: DLRMConfig, *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.dlrm = DLRM(cfg, device=device, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.cfg.dense_features
        return self.dlrm(x[:, :d], x[:, d:].to(torch.int64))


def criteo_dlrm(**overrides) -> DLRMConfig:
    """The Criteo Terabyte-shaped config (BASELINE.md's DLRM row)."""
    return DLRMConfig(**overrides)


def tiny_dlrm(**overrides) -> DLRMConfig:
    """Small config for tests and dry runs."""
    defaults = dict(
        dense_features=4,
        vocab_sizes=(64, 10_000, 128, 32),
        embed_dim=16,
        bottom_mlp=(32, 16),
        top_mlp=(32, 16),
    )
    defaults.update(overrides)
    return DLRMConfig(**defaults)
