"""Training: the estimator, its losses and metrics, the multi-process
``fit_spmd``, the torch compat estimator, gradient-boosted trees and the
keras wire-format estimator."""
from raydp_tpu_torch.train.estimator import Estimator, TrainingCallback
from raydp_tpu_torch.train.gbt import GBTEstimator
from raydp_tpu_torch.train.spmd_fit import fit_spmd
from raydp_tpu_torch.train.losses import (
    LOSSES,
    METRICS,
    resolve_loss,
    resolve_metric,
)
from raydp_tpu_torch.train.torch_estimator import TorchEstimator
from raydp_tpu_torch.train.tf_estimator import (
    KerasSequential,
    TFEstimator,
    parse_keras_model,
    parse_keras_optimizer,
)

__all__ = [
    "Estimator",
    "GBTEstimator",
    "KerasSequential",
    "LOSSES",
    "METRICS",
    "TFEstimator",
    "TorchEstimator",
    "TrainingCallback",
    "fit_spmd",
    "parse_keras_model",
    "parse_keras_optimizer",
    "resolve_loss",
    "resolve_metric",
]
