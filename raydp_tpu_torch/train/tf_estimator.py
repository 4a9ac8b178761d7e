"""The keras wire-format estimator over the port's ``Estimator``.

The counterpart of ``raydp_tpu/train/tf_estimator.py``: the same inputs
(a ``model.to_json()`` string, its parsed dict or a plain Sequential
layer-config list; keras optimizer and loss identifiers), lowered onto a
torch module (:class:`KerasSequential`) trained by
:class:`~raydp_tpu_torch.train.estimator.Estimator`. TensorFlow is never
imported.

* A terminal sigmoid or softmax before a from-probabilities loss is
  stripped and the fused from-logits loss used instead.
* Flax's ``Dense`` infers its input width at init; ``nn.Linear`` needs
  it. So the module is built at the first ``fit``, ``predict`` or
  ``restore``, from the feature width, before the optimizer exists.
* :func:`parse_keras_optimizer` reproduces the JAX package's optax
  transforms, not torch's defaults: Adam, AdamW and SGD map to torch's
  own; ``rmsprop`` and ``adagrad`` put eps inside the square root and
  start adagrad's accumulator at 0.1, as optax does, which torch's
  optimizers cannot, so :class:`OptaxRMSprop` and :class:`OptaxAdagrad`
  do it. They have no capturable mode, so ``epoch_mode="auto"`` streams
  them on a card (``utils/graphed.py``, ``capture_refusal``).
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, \
    Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from raydp_tpu_torch.models.dropout import Dropout
from raydp_tpu_torch.models.transformer import LayerNorm
from raydp_tpu_torch.train.estimator import Estimator, TrainingCallback
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device

_ACTIVATIONS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": lambda x: x,
    "relu": torch.relu,
    "tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),   # flax's default
    "selu": F.selu,
    "softplus": F.softplus,
    "leaky_relu": F.leaky_relu,
}

# keras loss identifier → (the port's loss name, terminal activation it fuses)
_LOSSES: Dict[str, Tuple[str, Optional[str]]] = {
    "mse": ("mse", None),
    "mean_squared_error": ("mse", None),
    "mae": ("mae", None),
    "mean_absolute_error": ("mae", None),
    "huber": ("huber", None),
    "huber_loss": ("huber", None),
    "binary_crossentropy": ("bce", "sigmoid"),
    "categorical_crossentropy": ("softmax_ce", "softmax"),
    "sparse_categorical_crossentropy": ("softmax_ce", "softmax"),
}

_METRICS = {
    "accuracy": "accuracy",
    "acc": "accuracy",
    "binary_accuracy": "binary_accuracy",
    "categorical_accuracy": "categorical_accuracy",
    "sparse_categorical_accuracy": "categorical_accuracy",
    "mse": "mse",
    "mae": "mae",
}

_SUPPORTED = ("Dense, Dropout, Activation, Flatten, InputLayer, "
              "BatchNormalization/LayerNormalization")


def _activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    fn = _ACTIVATIONS.get(name)
    if fn is None:
        raise ValueError(
            f"unsupported activation {name!r}; known: {sorted(_ACTIVATIONS)}")
    return fn


def _lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """flax ``Dense``'s default kernel init: a normal truncated at two
    standard deviations, of variance 1 / fan_in after truncation."""
    std = math.sqrt(1.0 / w.shape[1]) / .87962566103423978
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)


class KerasSequential(nn.Module):
    """The torch twin of a keras Sequential built from its layer configs,
    for inputs of ``in_shape`` (the trailing dims of a batch).

    Parameters are named as flax names them: a layer with a keras
    ``name`` keeps it; an unnamed ``Dense`` is flax's ``Dense_<i>`` and
    lives at ``layers.<i>``; an unnamed normalisation is
    ``LayerNorm_<i>``. BatchNormalization and LayerNormalization are a
    flax-style LayerNorm (epsilon 1e-6, no running statistics), as in the
    JAX package. Float32 throughout."""

    def __init__(self, layer_configs: Sequence[Dict[str, Any]],
                 in_shape: Sequence[int], *, device: DeviceLike = "cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        gen = generator or torch.Generator().manual_seed(0)
        self.layer_configs = tuple(layer_configs)
        self.layers = nn.ModuleDict()
        self.dropouts = nn.ModuleList()
        self._plan: List[Tuple[str, Any]] = []
        counters: Dict[str, int] = {}
        shape = tuple(int(d) for d in in_shape)

        def auto_name(kind: str, given: Optional[str]) -> str:
            if given:
                return given
            i = counters.get(kind, 0)
            counters[kind] = i + 1
            return f"{kind}_{i}"

        def register(name: str, module: nn.Module) -> Tuple[str, str]:
            if name.startswith("Dense_") and name[6:].isdigit():
                self.layers[name[6:]] = module
                return ("module", f"layers.{name[6:]}")
            self.add_module(name, module)
            return ("module", name)

        for cfg in self.layer_configs:
            cls = cfg["class_name"]
            c = cfg.get("config", {})
            if cls in ("InputLayer", "Input"):
                continue
            if cls == "Flatten":
                self._plan.append(("flatten", None))
                shape = (math.prod(shape),)
            elif cls == "Dense":
                units = int(c["units"])
                dense = nn.Linear(shape[-1], units)
                with torch.no_grad():
                    _lecun_normal_(dense.weight, gen)
                    dense.bias.zero_()
                self._plan.append(register(auto_name("Dense", c.get("name")),
                                           dense))
                act = c.get("activation", "linear") or "linear"
                self._plan.append(("act", _activation(act)))
                shape = shape[:-1] + (units,)
            elif cls == "Dropout":
                self.dropouts.append(Dropout(float(c.get("rate", 0.5))))
                self._plan.append(("dropout", len(self.dropouts) - 1))
            elif cls == "Activation":
                self._plan.append(("act", _activation(c["activation"])))
            elif cls in ("BatchNormalization", "LayerNormalization"):
                norm = LayerNorm(shape[-1], torch.float32, torch.float32)
                self._plan.append(register(
                    auto_name("LayerNorm", c.get("name")), norm))
            else:
                raise ValueError(
                    f"unsupported keras layer {cls!r}; supported: "
                    f"{_SUPPORTED}")
        self.to(dev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        for kind, arg in self._plan:
            if kind == "flatten":
                x = x.reshape(x.shape[0], -1)
            elif kind == "module":
                x = self.get_submodule(arg)(x)
            elif kind == "act":
                x = arg(x)
            else:
                x = self.dropouts[arg](x)
        return x


def parse_keras_model(spec: Union[str, dict, list]) -> List[Dict[str, Any]]:
    """``model.to_json()`` string, parsed dict or plain layer-config list
    → the list of layer configs."""
    if isinstance(spec, str):
        spec = json.loads(spec)
    if isinstance(spec, dict):
        if spec.get("class_name") not in ("Sequential", "Functional"):
            raise ValueError(
                "only Sequential-style keras models are supported; got "
                f"{spec.get('class_name')!r}")
        layers = spec.get("config", {}).get("layers", [])
    else:
        layers = list(spec)
    for layer in layers:
        if not isinstance(layer, dict) or "class_name" not in layer:
            raise ValueError(f"malformed layer config: {layer!r}")
    return list(layers)


class OptaxRMSprop(torch.optim.Optimizer):
    """``optax.rmsprop(lr, decay)``: ``nu = decay·nu + (1 - decay)·g²``
    from 0, then ``p -= lr · g / sqrt(nu + eps)`` (eps inside the root;
    torch's RMSprop adds it outside)."""

    def __init__(self, params, lr: float, decay: float = 0.9,
                 eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.addcdiv_(p.grad, (nu + group["eps"]).sqrt_(),
                           value=-group["lr"])
        return loss


class OptaxAdagrad(torch.optim.Optimizer):
    """``optax.adagrad(lr)``: the sum of squares starts at 0.1 and gains
    g² each step, then ``p -= lr · g / sqrt(sum + eps)`` with eps 1e-7
    inside the root (torch's Adagrad starts at 0 and adds 1e-10
    outside)."""

    def __init__(self, params, lr: float,
                 initial_accumulator_value: float = 0.1, eps: float = 1e-7):
        super().__init__(params, dict(
            lr=lr, initial_accumulator_value=initial_accumulator_value,
            eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None if closure is None else closure()
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["sum"] = torch.full_like(
                        p, group["initial_accumulator_value"])
                acc = state["sum"]
                acc.addcmul_(p.grad, p.grad)
                scale = torch.where(acc > 0, (acc + group["eps"]).rsqrt(),
                                    torch.zeros_like(acc))
                p.add_(p.grad * scale, alpha=-group["lr"])
        return loss


def parse_keras_optimizer(
        spec: Union[str, dict, None]) -> Callable[..., torch.optim.Optimizer]:
    """keras optimizer name or serialized config → a callable from
    parameters to the optimizer that applies the JAX package's optax
    update for it."""
    if spec is None:
        return lambda p: torch.optim.Adam(p, lr=1e-3)
    if isinstance(spec, dict):
        name = spec.get("class_name", "").lower()
        cfg = spec.get("config", {})
    else:
        name, cfg = str(spec).lower(), {}
    lr = float(cfg.get("learning_rate", cfg.get("lr", 1e-3)))
    if name == "adam":
        betas = (float(cfg.get("beta_1", 0.9)), float(cfg.get("beta_2", 0.999)))
        return lambda p: torch.optim.Adam(p, lr=lr, betas=betas, eps=1e-8)
    if name == "adamw":
        wd = float(cfg.get("weight_decay", 1e-4))
        return lambda p: torch.optim.AdamW(p, lr=lr, weight_decay=wd,
                                           eps=1e-8)
    if name == "sgd":
        momentum = float(cfg.get("momentum", 0.0))
        return lambda p: torch.optim.SGD(p, lr=lr, momentum=momentum)
    if name == "rmsprop":
        decay = float(cfg.get("rho", 0.9))
        return lambda p: OptaxRMSprop(p, lr=lr, decay=decay)
    if name == "adagrad":
        return lambda p: OptaxAdagrad(p, lr=lr)
    raise ValueError(f"unsupported keras optimizer {spec!r}")


class TFEstimator:
    """The reference TFEstimator's configuration surface: keras-format
    model, optimizer, loss and metrics in; ``fit``, ``evaluate``,
    ``predict``, ``get_model``, ``save``, ``restore``, ``shutdown`` and
    ``history`` out, over the port's ``Estimator`` on ``device``.
    ``extra`` passes on to it."""

    def __init__(
        self,
        num_workers: int = 1,
        model: Union[str, dict, list, None] = None,
        optimizer: Union[str, dict, None] = None,
        loss: str = "mse",
        metrics: Sequence[str] = (),
        feature_columns: Optional[List[str]] = None,
        label_column: Optional[str] = None,
        batch_size: int = 128,
        num_epochs: int = 1,
        shuffle: bool = True,
        callbacks: Sequence[TrainingCallback] = (),
        seed: int = 0,
        device: DeviceLike = "cuda",
        **extra,
    ):
        if model is None:
            raise ValueError("model (keras JSON/config) is required")
        self.device = resolve_device(device)
        layers = parse_keras_model(model)
        loss_name, fused = _LOSSES.get(str(loss).lower(), (None, None))
        if loss_name is None:
            raise ValueError(
                f"unsupported keras loss {loss!r}; known: {sorted(_LOSSES)}")
        # Fuse the terminal probability activation into the loss.
        if fused and layers:
            last = layers[-1]
            lc = last.get("config", {})
            if last["class_name"] == "Activation" and \
                    lc.get("activation") == fused:
                layers = layers[:-1]
            elif last["class_name"] == "Dense" and \
                    lc.get("activation") == fused:
                layers = layers[:-1] + [
                    {**last, "config": {**lc, "activation": "linear"}}]
        self.layer_configs = tuple(
            {"class_name": l["class_name"],
             "config": dict(l.get("config", {}))} for l in layers)
        unknown = [m for m in metrics if m not in _METRICS]
        if unknown:
            raise ValueError(f"unsupported keras metrics {unknown}; known: "
                             f"{sorted(_METRICS)}")
        self._estimator_kw = dict(
            optimizer=parse_keras_optimizer(optimizer), loss=loss_name,
            metrics=[_METRICS[m] for m in metrics], num_epochs=num_epochs,
            batch_size=batch_size, feature_columns=feature_columns,
            label_column=label_column,
            label_dtype=np.int32 if loss_name == "softmax_ce" else np.float32,
            shuffle=shuffle, callbacks=callbacks, seed=seed,
            device=self.device, **extra)
        self.num_workers = num_workers
        self.seed = seed
        self._impl: Optional[Estimator] = None
        self._history: List[Dict[str, float]] = []

    def _built(self, in_shape: Optional[Sequence[int]] = None) -> Estimator:
        """The estimator over the keras module, built at first use for
        inputs of ``in_shape`` (default: one value per feature column)."""
        if self._impl is None:
            if in_shape is None:
                cols = self._estimator_kw["feature_columns"]
                if not cols:
                    raise ValueError("feature_columns must be configured")
                in_shape = (len(cols),)
            module = KerasSequential(
                self.layer_configs, in_shape, device=self.device,
                generator=torch.Generator().manual_seed(self.seed))
            self._impl = Estimator(model=module, **self._estimator_kw)
        return self._impl

    def fit(self, train_ds, evaluate_ds=None, num_epochs=None):
        return self._built().fit(train_ds, evaluate_ds, num_epochs)

    def fit_on_df(self, train_df, evaluate_df=None, num_epochs=None):
        return self._built().fit_on_df(
            train_df, evaluate_df, num_epochs,
            num_shards=max(1, self.num_workers))

    fit_on_spark = fit_on_df

    def evaluate(self, ds, prefix: str = "eval_"):
        return self._built().evaluate(ds, prefix=prefix)

    def get_model(self) -> nn.Module:
        return self._built().get_model()

    def predict(self, x):
        x = np.asarray(x)
        return self._built(x.shape[1:]).predict(x)

    def save(self, checkpoint_dir: str, step=None) -> str:
        return self._built().save(checkpoint_dir, step)

    def restore(self, checkpoint_dir: str, step=None, sample_x=None) -> None:
        """Load ``save``'s checkpoint (``step_<step>.pt``, or ``final.pt``
        without a step); ``sample_x`` gives the input width where no
        feature columns are configured."""
        shape = None if sample_x is None else np.asarray(sample_x).shape[1:]
        name = f"step_{step}.pt" if step is not None else "final.pt"
        self._built(shape).restore_path(os.path.join(checkpoint_dir, name))

    def shutdown(self) -> None:
        """Drop the model and optimizer state; the history stays."""
        if self._impl is not None:
            self._history = self._impl.history
        self._impl = None

    @property
    def history(self) -> List[Dict[str, float]]:
        return self._history if self._impl is None else self._impl.history
