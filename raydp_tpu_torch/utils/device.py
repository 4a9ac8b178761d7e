"""Device selection for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
card the default raises: the port never moves to the CPU by itself. The
CPU path runs only when a caller asks for it (``device="cpu"``), as the
tests do.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The ``torch.device`` for ``device``; raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def set_exact_float32() -> None:
    """Full float32 matmuls and convolutions on the card (no TF32).

    Float32 greedy decode is checked token for token against a reference
    forward; TF32's ~3 significant digits would turn near-ties into
    mismatches."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
