"""MLP models for tabular regression and classification.

The counterpart of ``raydp_tpu/models/mlp.py``: a dense stack of hidden
layers with an activation (and optional dropout) and a linear head.
Kernels are xavier-uniform and biases zero, as flax's ``nn.Dense``
defaults give; parameters are float32 and every layer computes in
``dtype``. Flax infers the input width at init; here it is an argument.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
from torch import nn

from raydp_tpu_torch.models.dropout import Dropout
from raydp_tpu_torch.models.transformer import Dense, init_params
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device


class MLP(nn.Module):
    """Dense stack: hidden layers + linear head. ``layers.<i>`` holds flax's
    ``Dense_<i>``."""

    @startup.timed("model")
    def __init__(
        self,
        in_features: int,
        hidden: Sequence[int] = (256, 128, 64),
        out_dim: int = 1,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
        *,
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        widths = [in_features, *hidden, out_dim]
        self.dtype = dtype
        self.activation = activation
        self.layers = nn.ModuleList(
            Dense(a, b, dtype, torch.float32)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.dropout = Dropout(dropout_rate)
        init_params(self, generator or torch.Generator().manual_seed(0))
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for layer in self.layers[:-1]:
            x = self.dropout(self.activation(layer(x)))
        return self.layers[-1](x)


def taxi_fare_regressor(in_features: int, dtype=torch.float32, *,
                        device: DeviceLike = "cuda",
                        generator: Optional[torch.Generator] = None) -> MLP:
    """NYC-taxi fare MLP."""
    return MLP(in_features, hidden=(256, 128, 64, 32), out_dim=1,
               dtype=dtype, device=device, generator=generator)


def binary_classifier(in_features: int, hidden: Sequence[int] = (128, 64),
                      dtype=torch.float32, *, device: DeviceLike = "cuda",
                      generator: Optional[torch.Generator] = None) -> MLP:
    """Binary classifier emitting one logit."""
    return MLP(in_features, hidden=tuple(hidden), out_dim=1, dtype=dtype,
               device=device, generator=generator)
