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

``"auto"`` resolves to ``take`` for a whole table. The JAX package picks
``onehot`` for vocabularies of 8192 and more on an accelerator
(``raydp_tpu/models/dlrm.py:73-89``): the contraction runs on the MXU and
gives GSPMD a contracting dim to shard the table over ``tp``. A whole
table on one card gives that reason no hold, and at ``criteo_dlrm``'s 26
× 100k vocabularies and batch 1024 the one-hot operand would be 205 MB a
table in bf16 for the same sums. For a table cut over tp the rule comes
back (:meth:`DLRMConfig.impl_for`). Ids out of a table's range are an
error here (``jnp.take`` fills them with NaN).

**Over tp** (``raydp_tpu/models/dlrm.py:9-25, 41-47, 126-131, 220-223``):
every parameter declares the logical axes of the flax parameter it
carries (``logical_axes``), and :data:`LOGICAL_RULES`, the JAX package's
DLRM rules (``Estimator(logical_rules=LOGICAL_RULES)``;
:func:`dlrm_shardings`), cut the tables by rows over tp: rank ``r`` holds
rows ``[r·V/tp, (r+1)·V/tp)``. A cut table's lookup gathers its local
rows, ids outside the block giving zero, pools the bag in ``cfg.dtype``
and sums the ``[B, D]`` partials over tp
(:func:`~raydp_tpu_torch.parallel.collectives.reduce_from_region`): JAX's
local contraction plus one ``psum``. It gathers for ``take`` and
``onehot`` alike: a single id has one nonzero partial, so the sums are
the one-hot contraction's, without its ``[B, V/tp]`` operand (51 MB a
table in bf16 at 100k rows, tp=2 and 512 rows a dp rank). The MLP kernels
(``("hidden", "mlp")``) are cut by column over tp under either rules
(``mlp`` → tp); a cut layer's input passes ``copy_to_region`` and its
output is gathered over tp before the next layer, as GSPMD does for such
chains (:func:`~raydp_tpu_torch.parallel.collectives.gather_from_region`).
Its bias is cut with its kernel, as the transformer's ``mlp_up`` bias is:
a replicated bias would get a different gradient on each tp rank.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from raydp_tpu_torch.models.transformer import Dense, init_params
from raydp_tpu_torch.parallel import collectives as C
from raydp_tpu_torch.parallel.mesh import Placement, param_placements
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

EMBEDDING_IMPLS = ("take", "onehot")

# Logical axis → mesh axis for DLRM, the JAX package's
# (raydp_tpu/models/dlrm.py:41-47): embedding rows over tp.
LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("vocab", "tp"),
    ("embed", None),
    ("mlp", "tp"),
    ("hidden", None),
)

# At this many rows and more, 'auto' picks the one-hot contraction for a
# table cut over tp (raydp_tpu/models/dlrm.py:51).
AUTO_ONEHOT_THRESHOLD = 8192

# A Dense kernel's flax axes ("hidden", "mlp") on the port's [out, in]
# weight; the bias is cut with it (the module docstring).
MLP_AXES = {"weight": (("mlp", "hidden"), None), "bias": (("mlp",), None)}
LOGIT_AXES = {"weight": ((None, "hidden"), None)}
TABLE_AXES = {"table": (("vocab", "embed"), None)}


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

    def impl_for(self, vocab: int, sharded: bool = False) -> str:
        """The lookup of a table of ``vocab`` rows: ``embedding_impl``, or
        for ``"auto"`` the JAX rule where the table is cut over tp
        (``onehot`` from :data:`AUTO_ONEHOT_THRESHOLD` rows) and ``take``
        for a whole table (the module docstring)."""
        if self.embedding_impl != "auto":
            return self.embedding_impl
        return "onehot" if sharded and vocab >= AUTO_ONEHOT_THRESHOLD \
            else "take"


class ShardedEmbedding(nn.Module):
    """One embedding table. ``ids`` is ``[B]`` (one id) or ``[B, L]`` (a
    multi-hot bag, pooled by ``pooling``); the output is ``[B, D]`` in
    ``dtype``. The name is the JAX module's; cut over tp (``bind_mesh``)
    this rank holds a block of the rows (the module docstring)."""

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
        self.logical_axes = TABLE_AXES
        self.tp_group, self.row0 = None, 0
        self.reset_parameters(generator or torch.Generator().manual_seed(0))

    def bind_mesh(self, mesh) -> None:
        rows = self.table.shape[0]
        if rows != self.vocab_size:
            self.tp_group = mesh.group("tp")
            self.row0 = mesh.coords["tp"] * rows

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            nn.init.normal_(self.table, std=1.0 / math.sqrt(self.embed_dim),
                            generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        squeeze = ids.ndim == 1
        if squeeze:
            ids = ids[:, None]                  # [B, 1]: one form for both
        if self.tp_group is not None:
            # This rank's rows: ids outside the block contribute zero,
            # the bag pooled before the sum over tp.
            rows = self.table.shape[0]
            local = ids - self.row0
            inside = (local >= 0) & (local < rows)
            got = torch.index_select(self.table, 0,
                                     local.clamp(0, rows - 1).reshape(-1))
            got = got.to(self.dtype).reshape(ids.shape + (self.embed_dim,))
            out = (got * inside[..., None].to(self.dtype)).sum(dim=1)
            out = C.reduce_from_region(out, self.tp_group)
        elif self.impl == "onehot":
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

    @startup.timed("model")
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
            Dense(a, b, dt, pdt, axes=MLP_AXES)
            for a, b in zip(widths[:-1], widths[1:]))
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
            Dense(a, b, dt, pdt, axes=MLP_AXES)
            for a, b in zip(widths[:-1], widths[1:]))
        self.logit = Dense(widths[-1], 1, torch.float32, pdt,
                           axes=LOGIT_AXES)
        self.tp_group = None
        init_params(self, gen)
        self.to(dev)

    def bind_mesh(self, mesh) -> None:
        """Run on ``mesh``: the MLP layers cut over tp gather their
        outputs there; a cut table resolves ``"auto"`` by the JAX rule."""
        cut = any(layer.weight.shape[0] != layer.out_features
                  for layer in (*self.bottom, *self.top))
        self.tp_group = mesh.group("tp") if cut else None
        for table in self.emb:
            if table.table.shape[0] != table.vocab_size:
                table.impl = self.cfg.impl_for(table.vocab_size,
                                               sharded=True)

    def _layer(self, layer: Dense, x: torch.Tensor) -> torch.Tensor:
        """A column-parallel layer where cut: the input copied into the
        tp region, this rank's columns, the outputs gathered."""
        if self.tp_group is None or \
                layer.weight.shape[0] == layer.out_features:
            return layer(x)
        y = layer(C.copy_to_region(x, self.tp_group))
        return C.gather_from_region(y, -1, self.tp_group)

    def forward(self, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
        x = dense.to(self.cfg.dtype)
        for layer in self.bottom:
            x = torch.relu(self._layer(layer, x))
        embs = [table(sparse[:, t]) for t, table in enumerate(self.emb)]
        feats = torch.stack([x] + embs, dim=1)           # [B, 1 + T, D]
        if self.cfg.interaction == "dot":
            top = torch.cat([x, self.interaction(feats)], dim=-1)
        else:
            top = feats.reshape(feats.shape[0], -1)
        for layer in self.top:
            top = torch.relu(self._layer(layer, top))
        return self.logit(top)[:, 0]


def dlrm_shardings(model: nn.Module, mesh) -> Dict[str, Placement]:
    """Each parameter's placement on the built ``mesh`` under the DLRM
    rules: the tables row-cut over tp
    (``raydp_tpu/models/dlrm.py:220-223``)."""
    return param_placements(model, mesh, LOGICAL_RULES)


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
