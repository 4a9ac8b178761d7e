"""Pipeline-parallel sequence classifier (the port's
``raydp_tpu/models/pipelined.py``).

``PipelinedClassifier`` embeds tokens, runs its encoder blocks as a GPipe
pipeline over the mesh's ``pp`` ranks
(:func:`~raydp_tpu_torch.parallel.pipeline.spmd_pipeline`), pools the
first token and classifies. The parameters keep the JAX package's tree:
``embed`` (``tok``, ``pos``), ``stages`` (every block leaf stacked on a
leading stage axis, logical axis ``stage`` → ``pp``, so a pp rank holds
its stage only once the estimator or :func:`~raydp_tpu_torch.parallel.mesh.shard_module`
cuts it) and ``head`` (``out``).

As in the reference, the model builds **one block per stage**, ``pp``
blocks in all, whatever ``cfg.n_layers`` says (``n_layers`` must still
divide into the stages): the port keeps this shape for parity, and
ROADMAP Queue C lists it among the reference's faults. Dropout is
refused (GPipe stages must keep their shape, and the schedule replays
activations); ``n_microbatches`` defaults to ``2 × pp``.

A rank holds its dp rows, so the batch it feeds is padded (by cycling
its rows) to a multiple of ``n_microbatches`` and sliced back: over the
global batch that is the reference's multiple of ``n_microbatches ×
dp``. Without a bound mesh (one process) the stages run in sequence: the
reference the pipeline is held against.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from raydp_tpu_torch.models.transformer import (
    Dense,
    Embed,
    TransformerBlock,
    TransformerConfig,
    init_params,
)
from raydp_tpu_torch.parallel.mesh import Mesh, MeshSpec
from raydp_tpu_torch.parallel.pipeline import spmd_pipeline
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

__all__ = ["PipelinedClassifier"]


class _Embed(nn.Module):
    def __init__(self, cfg: TransformerConfig):
        super().__init__()
        self.cfg = cfg
        pdt = cfg.param_dtype
        self.tok = Embed(cfg.vocab_size, cfg.d_model, pdt, pdt)
        self.pos = nn.Parameter(torch.empty(cfg.max_len, cfg.d_model,
                                            dtype=pdt))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        e = self.tok(ids) + self.pos[None, :ids.shape[1]]
        return e.to(self.cfg.dtype)


class _Head(nn.Module):
    def __init__(self, cfg: TransformerConfig, num_classes: int):
        super().__init__()
        self.out = Dense(cfg.d_model, num_classes, torch.float32,
                         cfg.param_dtype)

    def forward(self, pooled: torch.Tensor) -> torch.Tensor:
        return self.out(pooled.float())


class PipelinedClassifier(nn.Module):
    """Sequence classifier whose encoder blocks run as a ``pp``
    pipeline. ``mesh`` is the :class:`MeshSpec` the estimator's mesh is
    built from."""

    @startup.timed("model")
    def __init__(self, cfg: TransformerConfig, mesh: MeshSpec,
                 num_classes: int = 2,
                 n_microbatches: Optional[int] = None, *,
                 device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if mesh.pp < 2:
            raise ValueError("PipelinedClassifier needs a pp axis >= 2")
        if cfg.dropout_rate:
            raise ValueError(
                "pipelined stages do not support dropout; use "
                "dropout_rate=0.0")
        if cfg.n_layers % mesh.pp != 0:
            raise ValueError(
                f"n_layers={cfg.n_layers} must divide into pp={mesh.pp} "
                "stages")
        dev = resolve_device(device)
        self.cfg = cfg
        self.mesh_spec = mesh
        self.num_classes = num_classes
        self.n_stages = mesh.pp
        self.n_microbatches = n_microbatches or 2 * mesh.pp
        gen = generator or torch.Generator().manual_seed(0)
        self.embed = _Embed(cfg)
        # One block a stage (the module docstring), each initialised on
        # its own, then stacked: the block's module tree with stacked
        # leaves, applied one stage's slice at a time (functional_call).
        blocks = [TransformerBlock(cfg) for _ in range(self.n_stages)]
        for b in blocks:
            init_params(b, gen)
        self.stages = blocks[0]
        with torch.no_grad():
            for name, p in list(self.stages.named_parameters()):
                owner, leaf = _owner(self.stages, name)
                stacked = torch.stack([dict(b.named_parameters())[name]
                                       for b in blocks])
                setattr(owner, leaf, nn.Parameter(stacked))
        for m in self.stages.modules():
            m.logical_axes = {n: (("stage",), None)
                              for n, _ in m.named_parameters(recurse=False)}
        # The stacked tree is a template, never bound to the mesh itself.
        self.stages.mesh_opaque = True
        self.head = _Head(cfg, num_classes)
        init_params(self.embed, gen)
        init_params(self.head, gen)
        with torch.no_grad():
            nn.init.normal_(self.embed.pos, std=0.02, generator=gen)
        self.mesh: Optional[Mesh] = None
        self.to(dev)

    def bind_mesh(self, mesh: Mesh) -> None:
        if mesh.shape["pp"] != self.n_stages:
            raise ValueError(f"mesh pp={mesh.shape['pp']} but the model "
                             f"has {self.n_stages} stages")
        self.mesh = mesh

    def _stage_fn(self, params, mb: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.stages, params, (mb,))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        h = self.embed(ids)
        stacked = dict(self.stages.named_parameters())
        if self.mesh is None:
            for i in range(self.n_stages):
                h = self._stage_fn({k: v[i] for k, v in stacked.items()}, h)
            return self.head(h[:, 0])
        n = h.shape[0]
        pad = (-n) % self.n_microbatches
        if pad:
            reps = -(-pad // n)
            h = torch.cat([h] * (reps + 1))[:n + pad]
        run = spmd_pipeline(self._stage_fn, self.mesh, self.n_microbatches)
        h = run(stacked, h)[:n]
        return self.head(h[:, 0])


def _owner(root: nn.Module, name: str):
    *path, leaf = name.split(".")
    mod = root
    for p in path:
        mod = getattr(mod, p)
    return mod, leaf
