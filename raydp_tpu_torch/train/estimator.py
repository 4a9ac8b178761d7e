"""Estimator: scikit-learn-style training of a torch module on one device.

The counterpart of ``JAXEstimator`` (``raydp_tpu/train/estimator.py``): a
configured loss and optimizer, per-epoch history and callbacks,
evaluation, prediction, and checkpoints. Two epoch paths, chosen as the
JAX package chooses them (:meth:`Estimator._use_scan`):

* **stream** (``:717-927``): batches from the dataset's device loader,
  one eager step each, checkpoints every ``save_every_steps`` that carry
  the data position, so ``fit(resume_from=...)`` continues mid-epoch
  exactly. A resumed fit always streams, as in JAX.
* **scan** (``:1047-1144``; ``"auto"`` picks it for a dataset of at most
  ``scan_threshold_bytes``): the whole dataset is uploaded once, padded
  to whole batches by cycling rows; each epoch draws one permutation on
  the device and gathers its batches there. On a card the step is
  captured once per fit into a CUDA graph and replayed
  (``utils/graphed.py``), the counterpart of JAX's one dispatch per
  epoch; on the CPU the same step runs eagerly. Checkpoints and
  callbacks come at epoch ends only.

Both paths run one step function, :meth:`Estimator._train_step`, which
sums the loss on the device: one host sync per epoch.

Differences from the JAX estimator, each deliberate:

* Dropout draws from an explicit ``torch.Generator`` seeded from
  ``seed + 1`` (JAX: ``PRNGKey(seed + 1)``), handed to the model with
  ``set_dropout_generator`` and saved in every checkpoint, so a resumed
  fit draws the masks the uninterrupted one would have. The scan
  shuffle draws from a generator seeded from ``seed`` on the fit's
  device. Neither reproduces ``jax.random``'s bits, so a scan fit
  matches JAX's only unshuffled and without dropout.
* Checkpoints are ``torch.save`` files (model, optimizer, step, data
  position, generator state), not orbax directories.
* One process, one device: the mesh, parameter sharding, multi-process
  fits, step retries, fault and preemption hooks, telemetry and the
  device-phase plane are later slices (ROADMAP Queue A, slice 2 rest).
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from raydp_tpu_torch.models.dropout import set_dropout_generator
from raydp_tpu_torch.train.losses import resolve_loss, resolve_metric
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device
from raydp_tpu_torch.utils.graphed import CapturedStep, capture_refusal

logger = logging.getLogger(__name__)

# Eager steps before the scan path captures its step: real steps of the
# first epoch, counted in its history.
CAPTURE_WARMUP_STEPS = 3


class TrainingCallback:
    """Per-epoch hook."""

    def on_epoch_end(self, epoch: int, metrics: Dict[str, float]) -> None:
        pass

    def on_train_end(self, history: List[Dict[str, float]]) -> None:
        pass


def _default_optimizer(params) -> torch.optim.Optimizer:
    """``optax.adam(1e-3)``'s counterpart."""
    return torch.optim.Adam(params, lr=1e-3)


class Estimator:
    """Trainer for a torch module.

    ``model`` is an ``nn.Module`` or a zero-arg creator of one;
    ``optimizer`` a callable from parameters to a ``torch.optim``
    optimizer. ``epoch_mode`` is ``"auto"``, ``"stream"`` or ``"scan"``
    (the module docstring); the stream path's batches come from a
    dataset's ``to_torch`` loader onto ``device`` (default ``"cuda"``).
    """

    def __init__(
        self,
        model: Union[nn.Module, Callable[[], nn.Module]],
        optimizer: Optional[Callable] = None,
        loss: Union[str, Callable] = "mse",
        metrics: Sequence[Union[str, Callable]] = (),
        metrics_name: Optional[Sequence[str]] = None,
        num_epochs: int = 1,
        batch_size: int = 256,
        feature_columns: Optional[List[str]] = None,
        label_column: Optional[str] = None,
        feature_dtype=np.float32,
        label_dtype=np.float32,
        seed: int = 0,
        shuffle: bool = True,
        callbacks: Sequence[TrainingCallback] = (),
        log_every: int = 0,
        checkpoint_dir: Optional[str] = None,
        save_every_steps: int = 0,
        self_supervised: bool = False,
        prefetch: int = 2,
        drop_last: bool = False,
        epoch_mode: str = "auto",
        scan_threshold_bytes: int = 2 << 30,
        device: DeviceLike = "cuda",
    ):
        if epoch_mode not in ("auto", "stream", "scan"):
            raise ValueError(
                f"epoch_mode must be auto|stream|scan, got {epoch_mode!r}")
        self.device = resolve_device(device)
        if not isinstance(model, nn.Module):
            model = model()
        self._model = model.to(self.device)
        self._make_optimizer = optimizer or _default_optimizer
        self._optimizer: Optional[torch.optim.Optimizer] = None
        self._loss_fn = resolve_loss(loss)
        names = list(metrics_name or [])
        self._metrics = []
        for i, m in enumerate(metrics):
            name = names[i] if i < len(names) else (
                m if isinstance(m, str) else getattr(m, "__name__", f"m{i}"))
            self._metrics.append((name, resolve_metric(m)))
        self.num_epochs = num_epochs
        self.batch_size = batch_size
        self.feature_columns = feature_columns
        self.label_column = label_column
        self.feature_dtype = feature_dtype
        self.label_dtype = label_dtype
        self.seed = seed
        self.shuffle = shuffle
        self.callbacks = list(callbacks)
        self.log_every = log_every
        self.checkpoint_dir = checkpoint_dir
        self.save_every_steps = save_every_steps
        self.self_supervised = self_supervised
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch_mode = epoch_mode
        self.scan_threshold_bytes = scan_threshold_bytes
        # Set by fit(): which epoch path ran ('scan' or 'stream').
        self.effective_epoch_mode: Optional[str] = None
        # The training generator (dropout masks), seeded as JAX seeds its
        # dropout chain: PRNGKey(seed + 1).
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed + 1)
        set_dropout_generator(self._model, self._generator)
        # The epoch's loss, summed on the device by every step.
        self._loss_sum = torch.zeros((), device=self.device)
        self._step = 0
        self._resume_position: Optional[tuple] = None
        self.history: List[Dict[str, float]] = []

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        if self._optimizer is None:
            self._optimizer = self._make_optimizer(self._model.parameters())
        return self._optimizer

    def _loaders(self, ds, columns, label, shuffle: bool, drop_last: bool):
        return [
            ds.to_torch(
                feature_columns=columns, label_column=label,
                batch_size=self.batch_size, rank=rank, shuffle=shuffle,
                seed=self.seed, feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype, prefetch=self.prefetch,
                device=self.device, drop_last=drop_last,
            )
            for rank in range(ds.num_shards)
        ]

    def _batches(self, loaders):
        """``(x, y)`` over every shard's loader in rank order (``y`` is
        None without a label column)."""
        for loader in loaders:
            for item in loader:
                yield item if self.label_column else (item, None)

    def _target(self, x, y):
        return x if self.self_supervised else y

    # -- training -------------------------------------------------------
    def fit(self, train_ds, evaluate_ds=None, num_epochs: Optional[int] = None,
            resume_from: Optional[str] = None) -> List[Dict[str, float]]:
        """Train. ``resume_from`` names a checkpoint (as returned by
        :meth:`save`); one with a mid-epoch data position continues at
        exactly that (epoch, batch): the epoch's shuffle is deterministic
        and the dropout generator's state is restored. A resumed fit runs
        the stream path."""
        if self.feature_columns is None or (
                self.label_column is None and not self.self_supervised):
            raise ValueError(
                "feature_columns and label_column must be configured "
                "(label_column may be omitted with self_supervised=True)")
        epochs = num_epochs if num_epochs is not None else self.num_epochs
        if self._use_scan(train_ds) and resume_from is None:
            self.effective_epoch_mode = "scan"
            self._fit_scan(train_ds, evaluate_ds, epochs)
        else:
            self.effective_epoch_mode = "stream"
            self._fit_stream(train_ds, evaluate_ds, epochs, resume_from)
        for cb in self.callbacks:
            cb.on_train_end(self.history)
        return self.history

    def _train_step(self, x: torch.Tensor,
                    y: Optional[torch.Tensor]) -> torch.Tensor:
        """One optimizer step on the batch ``(x, y)``, its loss added to
        the epoch's sum on the device; returns the loss. Both paths run
        it: the stream path eagerly, the scan path as a CUDA graph on a
        card."""
        opt = self.optimizer
        opt.zero_grad(set_to_none=True)
        loss = self._loss_fn(self._model(x), self._target(x, y))
        loss.backward()
        opt.step()
        loss = loss.detach()
        self._loss_sum += loss
        return loss

    def _fit_stream(self, train_ds, evaluate_ds, epochs: int,
                    resume_from: Optional[str]) -> None:
        loaders = self._loaders(train_ds, self.feature_columns,
                                self.label_column, self.shuffle,
                                self.drop_last)
        start_epoch, skip_batches = 0, 0
        if resume_from is not None:
            self.restore_path(resume_from)
            if self._resume_position is not None:
                start_epoch, skip_batches = self._resume_position
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            self._model.train()
            for loader in loaders:
                loader.set_epoch(epoch)
            to_skip = skip_batches if epoch == start_epoch else 0
            b_idx = to_skip
            self._loss_sum.zero_()
            n_batches = n_samples = 0
            for i, (x, y) in enumerate(self._batches(loaders)):
                if i < to_skip:
                    continue
                loss = self._train_step(x, y)
                n_batches += 1
                b_idx += 1
                self._step += 1
                n_samples += len(x)
                if (self.save_every_steps and self.checkpoint_dir
                        and self._step % self.save_every_steps == 0):
                    self.save(self.checkpoint_dir, step=f"mid_{self._step}",
                              data_position=(epoch, b_idx))
                if self.log_every and n_batches % self.log_every == 0:
                    logger.info("epoch %d step %d loss %.5f", epoch,
                                n_batches, float(loss))  # sync: opt-in
            train_loss = float(self._loss_sum) / max(1, n_batches)  # one sync
            self._finish_epoch(epoch, t0, train_loss, n_samples, evaluate_ds)

    # -- scan path --------------------------------------------------------
    def _use_scan(self, train_ds) -> bool:
        """Whether a fit runs the scan path: the JAX package's rule
        (``raydp_tpu/train/estimator.py:930-974``) for one process, plus
        one of the card's: ``"auto"`` streams where the optimizer's step
        cannot be captured into a CUDA graph
        (:func:`~raydp_tpu_torch.utils.graphed.capture_refusal`)."""
        if self.epoch_mode == "stream":
            return False
        try:
            n_rows = train_ds.total_rows
        except AttributeError:
            n_rows = None
        if n_rows == 0:
            if self.epoch_mode == "scan":
                logger.warning(
                    "epoch_mode='scan' requested but dataset is empty; "
                    "falling back to the stream path")
            return False
        if self.epoch_mode == "scan":
            return True
        if n_rows is None:
            return False
        n_cols = len(self.feature_columns) + 1
        approx = n_rows * n_cols * max(
            np.dtype(self.feature_dtype).itemsize,
            np.dtype(self.label_dtype).itemsize)
        if approx > self.scan_threshold_bytes:
            return False
        # On a card the scan step is a CUDA graph: "auto" keeps an
        # optimizer whose step cannot be captured on the stream path
        # ("scan" asked for raises on it).
        if self.device.type == "cuda":
            refusal = capture_refusal(self.optimizer)
            if refusal is not None:
                logger.info("epoch_mode='auto' streams: %s", refusal)
                return False
        return True

    def _materialize_all(self, ds):
        """Every shard, in rank order, as one ``(x, y)`` pair of host
        arrays (``y`` None without a label column)."""
        wanted = list(self.feature_columns) + (
            [self.label_column] if self.label_column else [])
        xs, ys = [], []
        for rank in range(ds.num_shards):
            cols = ds.shard_columns(rank, wanted)
            xs.append(np.stack(
                [cols[c].astype(self.feature_dtype, copy=False)
                 for c in self.feature_columns], axis=1))
            if self.label_column:
                ys.append(cols[self.label_column].astype(self.label_dtype,
                                                         copy=False))
        x = np.concatenate(xs) if len(xs) > 1 else xs[0]
        y = (np.concatenate(ys) if len(ys) > 1 else ys[0]) if ys else None
        return x, y

    def _captured_train_step(self) -> CapturedStep:
        """The scan path's step on a card: :meth:`_train_step` captured
        after ``CAPTURE_WARMUP_STEPS`` eager steps, with the dropout
        generator registered and the optimizer made capturable."""
        return CapturedStep(self._train_step, warmup=CAPTURE_WARMUP_STEPS,
                            optimizer=self.optimizer,
                            generators=(self._generator,))

    def _fit_scan(self, train_ds, evaluate_ds, epochs: int) -> None:
        x, y = self._materialize_all(train_ds)
        n_true = len(x)
        if n_true == 0:
            # A dataset without total_rows reaches here empty (_use_scan
            # cannot pre-check it): record empty epochs, as JAX does.
            logger.warning("scan-mode dataset is empty; recording empty "
                           "epochs")
            for epoch in range(epochs):
                self._finish_epoch(epoch, time.perf_counter(), 0.0, 0,
                                   evaluate_ds)
            return
        batch = self.batch_size
        n_steps = max(1, -(-n_true // batch))
        pad = n_steps * batch - n_true
        if pad:
            x, y = _pad_cycle(x, y, pad)
        xd = torch.tensor(x, device=self.device)  # uploaded once per fit
        yd = None if y is None else torch.tensor(y, device=self.device)
        shuffle_gen = torch.Generator(device=self.device)
        shuffle_gen.manual_seed(self.seed)
        step = (self._captured_train_step() if self.device.type == "cuda"
                else self._train_step)
        for epoch in range(epochs):
            t0 = time.perf_counter()
            self._model.train()
            xe, ye = xd, yd
            if self.shuffle:
                perm = torch.randperm(len(xd), generator=shuffle_gen,
                                      device=self.device)
                xe = xd.index_select(0, perm)
                ye = None if yd is None else yd.index_select(0, perm)
            self._loss_sum.zero_()
            for i in range(0, n_steps * batch, batch):
                step(xe[i:i + batch], None if ye is None else ye[i:i + batch])
            self._step += n_steps
            # The mean over the fused steps, padded rows included, as
            # JAX's losses.mean(); samples count the true rows.
            train_loss = float(self._loss_sum) / n_steps  # one sync
            metrics = self._finish_epoch(epoch, t0, train_loss, n_true,
                                         evaluate_ds)
            if self.log_every:
                logger.info("epoch %d (%d fused steps) loss %.5f", epoch,
                            n_steps, metrics["train_loss"])

    def _finish_epoch(self, epoch: int, t0: float, train_loss: float,
                      n_samples: int, evaluate_ds) -> Dict[str, float]:
        dt = time.perf_counter() - t0
        metrics: Dict[str, float] = {
            "epoch": epoch,
            "train_loss": train_loss,
            "time_s": dt,
            "samples": n_samples,
            "samples_per_sec": n_samples / max(1e-9, dt),
        }
        if evaluate_ds is not None:
            metrics.update(self.evaluate(evaluate_ds, prefix="eval_"))
        self.history.append(metrics)
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, metrics)
        if self.checkpoint_dir:
            # Epoch-end checkpoints point at the next epoch's first batch.
            self.save(self.checkpoint_dir, step=epoch,
                      data_position=(epoch + 1, 0))
        return metrics

    @torch.no_grad()
    def evaluate(self, ds, prefix: str = "") -> Dict[str, float]:
        """Loss and metrics over ``ds`` in eval mode, each the mean of the
        batch values weighted by the batches' true lengths."""
        model = self._model.eval()
        loaders = self._loaders(ds, self.feature_columns, self.label_column,
                                shuffle=False, drop_last=False)
        totals: Dict[str, torch.Tensor] = {}
        weight = 0
        for x, y in self._batches(loaders):
            preds = model(x)
            target = self._target(x, y)
            out = {"loss": self._loss_fn(preds, target)}
            for name, fn in self._metrics:
                out[name] = fn(preds, target)
            for k, v in out.items():
                vw = v.float() * len(x)
                totals[k] = vw if k not in totals else totals[k] + vw
            weight += len(x)
        return {f"{prefix}{k}": float(v) / max(1e-9, weight)
                for k, v in totals.items()}

    @torch.no_grad()
    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched inference on a host array, ``batch_size`` rows at a
        time; returns the model's outputs as numpy."""
        model = self._model.eval()
        x = np.asarray(x, dtype=self.feature_dtype)
        if len(x) == 0:
            return self._empty_preds(model, x.shape[1:])
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = torch.from_numpy(x[i:i + self.batch_size]).to(self.device)
            outs.append(model(chunk).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    def _empty_preds(self, model: nn.Module, feature_shape) -> np.ndarray:
        """Zero rows of the model's output: its trailing dims and dtype
        from one forward of a single zero row of ``feature_shape``. Falls
        back to ``(0,)`` float32 where that row cannot feed the model (a
        bare ``np.empty((0,))`` for a model that needs a feature dim)."""
        row = np.zeros((1,) + tuple(feature_shape), dtype=self.feature_dtype)
        try:
            out = model(torch.from_numpy(row).to(self.device)).float()
        except Exception:
            return np.empty((0,), dtype=np.float32)
        out = out.cpu().numpy()
        return np.empty((0,) + out.shape[1:], dtype=out.dtype)

    def get_model(self) -> nn.Module:
        return self._model

    # -- checkpoints ----------------------------------------------------
    def save(self, checkpoint_dir: str, step=None,
             data_position: Optional[tuple] = None) -> str:
        """Write ``step_<step>.pt`` (``final.pt`` without a step): model,
        optimizer, step count, ``data_position=(epoch, batch)`` and the
        dropout generator's state. Returns the path."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        name = f"step_{step}.pt" if step is not None else "final.pt"
        path = os.path.abspath(os.path.join(checkpoint_dir, name))
        epoch, batch = data_position if data_position is not None else (-1, -1)
        state = {
            "model": self._model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "step": self._step,
            "data_epoch": epoch,
            "data_batch": batch,
            "generator": self._generator.get_state(),
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)  # a reader never sees half a checkpoint
        return path

    def restore_path(self, path: str) -> None:
        """Restore everything :meth:`save` wrote from exactly ``path``."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self._model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self._step = int(state["step"])
        self._generator.set_state(state["generator"])
        epoch, batch = int(state["data_epoch"]), int(state["data_batch"])
        self._resume_position = (epoch, batch) if epoch >= 0 else None


def _pad_cycle(x: np.ndarray, y: Optional[np.ndarray], pad: int):
    """Pad by ``pad`` rows cycled from the start (the JAX package's one
    padding convention, ``raydp_tpu/train/estimator.py:1495-1503``);
    ``pad`` may exceed ``len(x)``."""
    idx = np.arange(pad) % len(x)
    x = np.concatenate([x, x[idx]])
    if y is not None:
        y = np.concatenate([y, y[idx]])
    return x, y
