"""Training: the estimator, its losses and metrics."""
from raydp_tpu_torch.train.estimator import Estimator, TrainingCallback
from raydp_tpu_torch.train.losses import (
    LOSSES,
    METRICS,
    resolve_loss,
    resolve_metric,
)

__all__ = [
    "Estimator",
    "LOSSES",
    "METRICS",
    "TrainingCallback",
    "resolve_loss",
    "resolve_metric",
]
