"""Dropout that draws from an explicit generator.

The JAX package threads a dropout key from the estimator into every
apply (``rngs={"dropout": ...}``, ``raydp_tpu/train/estimator.py:749,
827``), so a fit is reproducible and resumes exactly. ``torch.nn.Dropout``
draws from torch's global generator instead. :class:`Dropout` keeps
flax's semantics (keep each element with probability ``1 - rate`` and
scale it by ``1 / (1 - rate)``; the identity when ``rate == 0`` or in
``.eval()``) and draws its mask from the ``torch.Generator`` that
:func:`set_dropout_generator` hands it, on the model's device.

Under block rematerialisation (``TransformerConfig.remat``) a
:class:`MaskTape` keeps each mask that a checkpointed block drew, and
the block's recomputed forward reads them back instead of drawing new
ones (:func:`raydp_tpu_torch.models.transformer.checkpoint_block` says
why the masks are kept rather than the generator rewound).
"""
from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn


class MaskTape:
    """The keep-masks of one checkpointed forward, in the order they were
    drawn: recorded by the forward, read back by the recompute."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.replaying = False
        self.cursor = 0

    def keep(self, draw: Callable[[], torch.Tensor]) -> torch.Tensor:
        if not self.replaying:
            self.masks.append(draw())
            return self.masks[-1]
        mask = self.masks[self.cursor]
        self.cursor += 1
        return mask


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        if not 0.0 <= rate <= 1.0:
            raise ValueError(f"dropout rate {rate} not in [0, 1]")
        self.rate = rate
        self.generator: Optional[torch.Generator] = None
        self.tape: Optional[MaskTape] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate == 1.0:
            return torch.zeros_like(x)
        if self.generator is None:
            raise RuntimeError(
                "dropout in training mode needs a generator: call "
                "set_dropout_generator(model, torch.Generator(device=...))"
            )
        keep_prob = 1.0 - self.rate

        def draw() -> torch.Tensor:
            keep = torch.empty(x.shape, dtype=torch.float32, device=x.device)
            keep.bernoulli_(keep_prob, generator=self.generator)
            return keep.bool()

        keep = draw() if self.tape is None else self.tape.keep(draw)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every :class:`Dropout` of ``model`` at ``generator``, which
    must live on the model's device."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
