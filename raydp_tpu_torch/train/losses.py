"""Loss and metric functions, addressable by name.

The counterpart of ``raydp_tpu/train/losses.py``: the same names, the same
squeeze rule (predictions one rank above the targets lose their last
axis) and the same formulas, in torch.
"""
from __future__ import annotations

from typing import Callable, Dict, Union

import torch
import torch.nn.functional as F


def _squeezed(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return preds.squeeze(-1) if preds.ndim == targets.ndim + 1 else preds


def mse(preds, targets):
    return torch.mean((_squeezed(preds, targets) - targets) ** 2)


def mae(preds, targets):
    return torch.mean(torch.abs(_squeezed(preds, targets) - targets))


def smooth_l1(preds, targets, beta: float = 1.0):
    """Huber/SmoothL1."""
    diff = torch.abs(_squeezed(preds, targets) - targets)
    return torch.mean(
        torch.where(diff < beta, 0.5 * diff**2 / beta, diff - 0.5 * beta)
    )


def binary_crossentropy(logits, targets):
    """optax's ``sigmoid_binary_cross_entropy``, averaged."""
    logits = _squeezed(logits, targets)
    t = targets.float()
    return torch.mean(
        -t * F.logsigmoid(logits) - (1.0 - t) * F.logsigmoid(-logits)
    )


def softmax_crossentropy(logits, targets):
    """Softmax cross-entropy with integer labels, averaged."""
    return F.cross_entropy(logits, targets.long())


def lm_crossentropy(logits, tokens):
    """Next-token language-modeling loss: position t of ``logits`` predicts
    token t+1 of ``tokens``."""
    pred = logits[:, :-1, :]
    return F.cross_entropy(pred.reshape(-1, pred.shape[-1]),
                           tokens[:, 1:].reshape(-1).long())


LOSSES: Dict[str, Callable] = {
    "mse": mse,
    "mae": mae,
    "smooth_l1": smooth_l1,
    "huber": smooth_l1,
    "bce": binary_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "softmax_ce": softmax_crossentropy,
    "sparse_categorical_crossentropy": softmax_crossentropy,
    "lm_ce": lm_crossentropy,
}


def resolve_loss(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    if loss in LOSSES:
        return LOSSES[loss]
    raise ValueError(f"unknown loss {loss!r}; known: {sorted(LOSSES)}")


# -- metrics ---------------------------------------------------------------
def binary_accuracy(logits, targets):
    logits = _squeezed(logits, targets)
    return torch.mean(((logits > 0).int() == targets.int()).float())


def categorical_accuracy(logits, targets):
    return torch.mean((torch.argmax(logits, -1) == targets.int()).float())


METRICS: Dict[str, Callable] = {
    "mse": mse,
    "mae": mae,
    "accuracy": binary_accuracy,
    "binary_accuracy": binary_accuracy,
    "categorical_accuracy": categorical_accuracy,
}


def resolve_metric(metric: Union[str, Callable]) -> Callable:
    if callable(metric):
        return metric
    if metric in METRICS:
        return METRICS[metric]
    raise ValueError(f"unknown metric {metric!r}; known: {sorted(METRICS)}")
