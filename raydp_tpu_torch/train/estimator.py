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
sums the loss on the device: one host sync per epoch. With
``aux_losses=True`` its objective adds the model's MoE load-balancing
losses (:func:`~raydp_tpu_torch.models.moe.moe_aux_loss`), as the JAX
train step adds the sown ``losses`` collection; ``evaluate``'s loss and
``predict`` leave them out, as JAX's eval and predict steps do. In a gang
the MoE layers route over the dp group and their loss is the group's
(``models/moe.py``): every rank backpropagates it weighted by the dp
size beside its row-weighted task loss, so the summed gradient over the
global rows adds the loss's gradient once, as JAX's global objective
does.

``fit_on_df``, ``predict_on_ds`` and ``predict_on_df`` take the port's
DataFrames (``raydp_tpu_torch/dataframe``) through
:meth:`MLDataset.from_df`, as the JAX estimator's do.

Differences from the JAX estimator, each deliberate:

* Dropout draws from an explicit ``torch.Generator`` seeded from
  ``seed + 1`` (JAX: ``PRNGKey(seed + 1)``), handed to the model with
  ``set_dropout_generator`` and saved in every checkpoint, so a resumed
  fit draws the masks the uninterrupted one would have. The scan
  shuffle draws from a generator seeded from ``seed`` on the fit's
  device. Neither reproduces ``jax.random``'s bits, so a scan fit
  matches JAX's only unshuffled and without dropout.
* Checkpoints are ``torch.save`` files (model, optimizer, step, data
  position, writing world, generator state), not orbax directories.
* There is no buffer donation. ``donate_state`` keeps the JAX package's
  defaulting rules and says here that a step updates the parameters and
  the optimizer state in place, so only a failure raised before the
  update may be retried (below).
* ``rng_impl`` takes the JAX package's names (``None``,
  ``"threefry2x32"``, ``"rbg"``, ``"unsafe_rbg"``) and raises for any
  other, but changes nothing: the port's random streams come from torch
  generators whatever the name, and no name makes them equal JAX's.
* ``infeed_depth`` is the number of chunk copies the stream path's
  device loader keeps issued ahead of the step (``data/loader.py``), the
  JAX estimator's transfer window; the scan path uploads the dataset
  once and has none.
* ``train_config=`` and ``data_config=`` (``raydp_tpu_torch.config``)
  override the scalar keyword arguments they name, as in the JAX
  package; a ``TrainConfig`` with ``max_failures`` set is an explicit
  budget.

**Device plane** (``raydp_tpu/train/estimator.py:604-613, 787-924,
1085-1130``; ``telemetry/device_profiler.py``; off with
``RAYDP_TPU_DEVICE_PLANE=0``): the stream path splits each epoch's loop
wall into input wait, dispatch, compute and collective from the step
clock's CUDA events (folded as they complete, no sync) and the host's
time in each step, and adds ``phases``, ``bound`` and ``mfu`` to the
epoch's metrics and a ``train/phases`` event to the span shards. The
FLOPs behind ``mfu`` are counted once a process for each model and
input shape, after the first epoch's loop, on the meta device
(``utils/profiling.count_train_step``): no training step runs under a
counter. An
:class:`~raydp_tpu_torch.telemetry.device_profiler.AnomalySentinel`
watches step times and, every ``RAYDP_TPU_SENTINEL_EVERY`` steps (the
only syncs it adds), the step's loss and its global grad norm, computed
on those steps only; every epoch's loss is checked at its sync. The
scan path replays one graph a step, unchanged: only the epoch-loss
check applies there, as in the JAX package. Kernel builds and the
graph capture are the port's compiles: counted, and billed to the job
as ``compile_seconds`` (``utils/profiling.run_compile``).

**Telemetry** (``raydp_tpu/train/estimator.py:594, 649-683, 710,
823-840, 1094-1102, 1399, 1588``): a fit is a ``train/fit`` span, each
epoch a ``train/epoch`` span and, on the stream path, each step a
``train/step`` span inside a watchdog bracket (the first step of an
epoch at the long threshold), its duration observed by the
``train/step`` timer. Both are host-side bookkeeping and add no device
sync: the step span times the step's dispatch, as in the JAX package,
where the device may still be computing. The scan path brackets its
epoch (``train/epoch``, long threshold). Each epoch bills
``chip_seconds`` (its wall time times the one card a process uses),
counts ``train/epochs`` and ``train/samples``, leaves flight records
and flushes the span ring; checkpoints, prunes and a preemption drain
land on the event timeline (``checkpoint/complete``,
``checkpoint/prune``, ``preempt/drain``, ``checkpoint/emergency``).

**Step retries** (``raydp_tpu/train/estimator.py:838-870``): with
``donate_state=False`` (what an explicit ``max_failures > 0`` turns on),
a step that raises before its update begins (forward, loss, backward;
in a gang, before the rank enters the gradient exchange) is run again on
the same batch, with the dropout generator put back, up to
``max_failures`` times a fit: the retried step leaves the parameters a
step that never failed would leave. A failure at or after the exchange
or ``opt.step()`` has touched the state and re-raises at once, as does
every failure with ``donate_state=True`` (the default); the supervisor's
relaunch (:func:`~raydp_tpu_torch.train.spmd_fit.fit_spmd`) recovers
those from the newest checkpoint. The scan path's unit is the step too:
its eager steps (the CPU's, and the card's warm-up steps before the
capture) retry the same way; a failed capture or replay of the CUDA
graph re-raises. Most device faults (an illegal address, a failed
launch) poison the CUDA context, so no retry in the same process can
succeed: the budget helps with host-side and allocation errors, and the
relaunch is the real recovery.

**Preemption** (``:636-683, 902-910``): after each stream step and any
scheduled save, :func:`raydp_tpu_torch.fault.on_train_step` runs when a
fault plan is set, and a pending notice (an injected ``preempt``, a
SIGTERM, a gang rank's ``Preempt`` RPC) drains:
:meth:`Estimator._drain_preemption` writes ``step_emergency_<N>.pt`` at
the exact data position, marks the drain done and raises
:class:`~raydp_tpu_torch.fault.PreemptionError`. A gang's ranks drain
after the same step, since ``save`` is collective: each rank's notice
rides the ``[loss_sum, rows]`` stats of the gradient exchange, and all
drain after the first step whose exchange carried one; a ``preempt``
clause without ``rank=`` reaches every rank at the same step and drains
there.

**Multi-process mode** (``raydp_tpu/train/estimator.py:532-575,
930-949, 1365-1406``): when ``torch.distributed`` is initialised with a
world larger than 1 (a gang rank of
:func:`~raydp_tpu_torch.train.spmd_fit.fit_spmd`), every rank feeds
``batch_size`` rows of its own shard, so the global batch is
``batch_size × world``, and a fit always streams (a CUDA graph cannot
capture a gloo collective). Rank 0's parameters and buffers are
broadcast before the first step. Each step backpropagates its rank's
loss summed over its rows, all-reduces the gradients (in buckets, with
the rows and the loss sum riding the first) and divides by the global
rows, so a ragged last batch weighs by rows, not by ranks, and the
update is the one for the mean over the global batch; the
reported ``train_loss`` is that global mean, the same on every rank.
Dropout draws from a generator seeded from ``seed`` and the rank. Every
rank enters :meth:`Estimator.save`; rank 0 writes the file (with every
rank's generator state) and prunes, then all wait at a barrier. Each
epoch's metrics add ``step_ms`` and ``allreduce_ms`` (means over its
steps: CUDA events on a card, the host clock on the CPU) and
``first_step_at`` (the wall-clock time the fit's first step finished,
epoch 0 only).

**Model parallelism** (``raydp_tpu/train/estimator.py:304-308, 327-400,
532-575``): a ``mesh=MeshSpec(dp, pp, sp, tp)`` with any of pp, sp, tp
above 1 must span the gang's world, one process per mesh position
(``raydp_tpu_torch/parallel/mesh.py``); a dp-only mesh spans the whole
gang, as before. The mesh is built (:meth:`Estimator.param_placements`)
at the fit's start, or at the first evaluate, predict, save or restore,
and with ``shard_params`` each parameter of a model that declares
logical axes is cut to this rank's block by ``logical_rules`` (default:
the transformer's ``LOGICAL_RULES``, as ``JAXEstimator`` uses them), the
modules binding the mesh's groups; Adam's moments follow, since the
optimizer is built on the cut parameters. A model without axes (an
MLP) stays replicated and every rank computes all of it. The data rule:
a gang's shards go to dp indices, not ranks (``fit_spmd``), so the sp,
tp and pp peers of one dp index read the same ``batch_size`` rows, and
the model keeps its sp block of the positions. The gradient rule (JAX's
autodiff sums a replicated parameter's gradient over every axis that
replicates it): each rank backpropagates its loss weighted by 1 on the
first sp rank of the last pp stage and 0 elsewhere (the sp and pp peers
compute the same loss), and every parameter's gradient is summed over
the dp, sp and pp axes that replicate it, in buckets per group; tp
peers need no sum, the layers' own collectives having made their
gradients whole. The rows and loss sum are counted once a dp index.
``save`` gathers full parameters and optimizer state to rank 0, which
writes the one checkpoint file; ``restore`` cuts it onto whatever mesh
restores it, one process included. The device plane's FLOP count
(``mfu``) is skipped on such a mesh: its meta-device pass cannot run the
model's collectives.
"""
from __future__ import annotations

import logging
import os
import re
import time
from collections import deque
from typing import (Callable, Deque, Dict, List, Optional, Sequence,
                    Union)

import numpy as np
import torch
from torch import nn

from raydp_tpu_torch import fault
from raydp_tpu_torch.config import DataConfig, TrainConfig
from raydp_tpu_torch.data.ml_dataset import MLDataset
from raydp_tpu_torch.models.dropout import set_dropout_generator
from raydp_tpu_torch.models.moe import moe_aux_loss
from raydp_tpu_torch.parallel import collectives as _coll
from raydp_tpu_torch.parallel.mesh import (
    Mesh,
    MeshSpec,
    Placement,
    bind_mesh,
    gather_state_dict,
    param_placements,
    shard_module,
)
from raydp_tpu_torch.telemetry import accounting as _acct
from raydp_tpu_torch.telemetry import device_profiler as _devplane
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.telemetry import flight_recorder as _flight
from raydp_tpu_torch.telemetry import flush_spans, span
from raydp_tpu_torch.telemetry.spans import event as _event
from raydp_tpu_torch.telemetry import watchdog as _watchdog
from raydp_tpu_torch.train.losses import resolve_loss, resolve_metric
from raydp_tpu_torch.utils import startup as _startup
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device
from raydp_tpu_torch.utils.graphed import CapturedStep, capture_refusal
from raydp_tpu_torch.utils.profiling import count_train_step
from raydp_tpu_torch.utils.profiling import install_compile_listener
from raydp_tpu_torch.utils.profiling import metrics as _metrics

#: Retention cap for step-encoded checkpoints (``step_mid_<N>.pt`` and
#: ``step_emergency_<N>.pt``), as the JAX package's
#: (``raydp_tpu/train/estimator.py:40-49``): beyond this many, the oldest
#: are pruned after each save. ``0`` disables pruning.
#: Epoch-end (``step_<E>.pt``) and ``final.pt`` checkpoints are never
#: pruned.
CKPT_KEEP_ENV = "RAYDP_TPU_CKPT_KEEP"
_DEFAULT_CKPT_KEEP = 16

logger = logging.getLogger(__name__)

# Cards a training process holds: one (a gang runs a process per card),
# so an epoch bills its wall time once as chip-seconds.
_CARDS_PER_PROCESS = 1

# Eager steps before the scan path captures its step: real steps of the
# first epoch, counted in its history.
CAPTURE_WARMUP_STEPS = 3

# Gradient bytes per all_reduce of a multi-process fit (DDP's default
# bucket size).
BUCKET_CAP_MB = 25

# The JAX estimator's rng_impl names (None: jax's default, threefry).
RNG_IMPLS = (None, "threefry2x32", "rbg", "unsafe_rbg")


def _dist_world() -> "tuple[int, int]":
    """(rank, world size) of an initialised ``torch.distributed`` group,
    else (0, 1)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _data_world() -> int:
    """The world size a checkpoint records and a resume compares with:
    the process group's size, 1 outside a gang."""
    return _dist_world()[1]


def _rank_seed(seed: int, rank: int) -> int:
    """The dropout seed of ``rank``: JAX's ``seed + 1`` on rank 0, a
    distinct stream on every other rank."""
    return seed + 1 + 7919 * rank


class _StepClock:
    """Per-step timestamps of a stream fit: CUDA events on a card, the
    host clock on the CPU. Each step leaves ``(start, exchange start,
    exchange end, end)`` (the exchange marks are None outside a
    multi-process fit) and the host's clock at its start and end and its
    seconds in the exchange. A step is folded into the epoch's totals
    once its end event has completed, polled with ``query()`` at the
    next step's start (no sync), so only the steps the host launched
    ahead of the card are held (the launch queue bounds them); the
    epoch's loss sync completes the rest (:meth:`epoch_totals`).

    On a card the events are put on the host's clock by the epoch's
    first step, which starts on an idle card (after the previous epoch's
    sync). From the card's start of a step until the host's last launch
    of it, the card can only have run what the host had launched: that
    part of the span (less the host's seconds in the exchange) is the
    step's ``paced_ms``, the rest of the span the card's own. A step
    long enough to fill the launch queue blocks the host in its launches
    and reads part of its span as paced."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self._pending: Deque[tuple] = deque()
        self._origin: Optional[tuple] = None  # (host s, event) of step 1
        self._totals = self._zero()

    @staticmethod
    def _zero() -> Dict[str, float]:
        return {"steps": 0, "step_ms": 0.0, "allreduce_ms": 0.0,
                "paced_ms": 0.0}

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def begin(self) -> None:
        """At a step's start: fold the steps the card has finished."""
        self._fold(everything=False)

    def end(self, marks: tuple, host_t0: float, host_t1: float,
            exchange_s: float) -> None:
        if self._origin is None:
            self._origin = (host_t0, marks[0])
        self._pending.append((marks, host_t0, host_t1, exchange_s))

    def _fold(self, everything: bool) -> None:
        t = self._totals
        while self._pending:
            (s0, s1, s2, s3), h0, h1, exchange_s = self._pending[0]
            if self.cuda and not everything and not s3.query():
                break
            self._pending.popleft()
            step = self._ms(s0, s3)
            ar = self._ms(s1, s2) if s1 is not None else 0.0
            t["steps"] += 1
            t["step_ms"] += step
            t["allreduce_ms"] += ar
            if self.cuda:
                origin_h, origin_ev = self._origin
                d0 = max(h0, origin_h + origin_ev.elapsed_time(s0) / 1e3)
                paced = (h1 - d0 - exchange_s) * 1e3
                t["paced_ms"] += min(max(0.0, paced), step - ar)

    def epoch_totals(self) -> Dict[str, float]:
        """``steps``, ``step_ms``, ``allreduce_ms`` (the gradient
        exchange: bucket copies, all_reduce and the division) and
        ``paced_ms`` (the class docstring) summed over the steps since
        the last call. Called after the epoch's loss sync: every event
        has completed."""
        self._fold(everything=True)
        out, self._totals = self._totals, self._zero()
        self._origin = None
        return out


class _GradAllReduce:
    """The gradient exchange of a multi-process fit: one ``all_reduce``
    (sum) per bucket of at most ``BUCKET_CAP_MB`` of gradients of one
    dtype and one reduction group, in parameter order, the rank's loss
    sum, row count and preemption vote riding the first float32 bucket
    over the whole world (a float64 triple of their own where there is
    none). ``groups`` maps a parameter to the group its gradient sums
    over (``None``: no sum; missing: the world); on a data-parallel mesh
    every gradient sums over the world. ``stats_weight`` counts this
    rank's rows and loss (1 on one rank of each dp index). Every rank of
    a group ends with the same bytes, so the same optimizer keeps their
    parameters equal, and every rank reads the same count of votes."""

    _WORLD = object()

    def __init__(self, params, groups: Optional[Dict[int, object]] = None,
                 stats_weight: float = 1.0):
        self.params = [p for p in params if p.requires_grad]
        self.stats_weight = stats_weight
        self.grouped = groups is not None
        groups = groups or {}
        cap = BUCKET_CAP_MB << 20
        # (group, [params]) in parameter order.
        self.buckets: List[tuple] = []
        cur: List[nn.Parameter] = []
        cur_group = None
        cur_bytes = 0
        for p in self.params:
            group = groups.get(id(p), self._WORLD)
            nbytes = p.numel() * p.element_size()
            if cur and (cur[0].dtype != p.dtype or cur_group is not group
                        or cur_bytes + nbytes > cap):
                self.buckets.append((cur_group, cur))
                cur, cur_bytes = [], 0
            cur.append(p)
            cur_group = group
            cur_bytes += nbytes
        if cur:
            self.buckets.append((cur_group, cur))
        self.stats_bucket = next(
            (i for i, (g, b) in enumerate(self.buckets)
             if g is self._WORLD and b[0].dtype == torch.float32), None)
        # The last exchange's count of ranks that had a preemption notice.
        self._votes: Optional[torch.Tensor] = None

    def __call__(self, loss_sum: torch.Tensor, rows: int,
                 preempt: bool = False) -> torch.Tensor:
        """All-reduce the gradients and ``[loss_sum, rows, preempt]``;
        divide the gradients by the global rows. Returns the global mean
        loss."""
        import torch.distributed as dist

        w = self.stats_weight
        stats = torch.cat([loss_sum.float().reshape(1) * w, torch.tensor(
            [float(rows) * w, float(preempt)], device=loss_sum.device)])
        flats = []
        for i, (_, bucket) in enumerate(self.buckets):
            parts = [p.grad.reshape(-1) if p.grad is not None
                     else torch.zeros(p.numel(), dtype=p.dtype,
                                      device=p.device)
                     for p in bucket]
            if i == self.stats_bucket:
                parts.append(stats)
            flats.append(torch.cat(parts))
        if self.stats_bucket is None:
            flats.append(stats.double())
        for i, flat in enumerate(flats):
            group = (self.buckets[i][0] if i < len(self.buckets)
                     else self._WORLD)
            if group is self._WORLD:
                dist.all_reduce(flat)
            elif group is not None:
                dist.all_reduce(flat, group=group)
        total = (flats[self.stats_bucket][-3:] if self.stats_bucket
                 is not None else flats[-1]).clone()
        self._votes = total[2]
        n_global = total[1]
        for i, ((_, bucket), flat) in enumerate(zip(self.buckets, flats)):
            offset = 0
            for p in bucket:
                n = p.numel()
                # On a mesh a parameter may have a gradient on some ranks
                # only (a stage's embedding): every rank takes the sum.
                if p.grad is not None or self.grouped:
                    p.grad = flat[offset:offset + n].view_as(p).div_(
                        n_global.to(flat.dtype))
                offset += n
        return (total[0] / n_global).float()

    def preempt_votes(self) -> int:
        """How many ranks entered the last exchange with a preemption
        notice (the same on every rank). Reading it waits for the step on
        a card: free under gloo, whose exchange already waited for the
        backward on the host; one sync a step under NCCL."""
        return 0 if self._votes is None else int(self._votes.item())


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
        mesh: Optional[MeshSpec] = None,
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
        shard_params: bool = True,
        logical_rules: Optional[Sequence] = None,
        aux_losses: bool = False,
        max_failures: Optional[int] = None,
        donate_state: Optional[bool] = None,
        infeed_depth: int = 2,
        rng_impl: Optional[str] = None,
        train_config: Optional[TrainConfig] = None,
        data_config: Optional[DataConfig] = None,
        device: DeviceLike = "cuda",
    ):
        # Typed-config forms (raydp_tpu/train/estimator.py:191-205): values
        # in a supplied TrainConfig/DataConfig override the scalar kwargs.
        if train_config is not None:
            num_epochs = train_config.num_epochs
            mesh = train_config.mesh
            seed = train_config.seed
            log_every = train_config.log_every_steps
            checkpoint_dir = train_config.checkpoint_dir
            max_failures = train_config.max_failures
            save_every_steps = train_config.save_every_steps
        if data_config is not None:
            batch_size = data_config.batch_size
            shuffle = data_config.shuffle
            prefetch = data_config.prefetch
            drop_last = data_config.drop_last
        if rng_impl not in RNG_IMPLS:
            raise ValueError(
                f"rng_impl must be one of {RNG_IMPLS}, got {rng_impl!r}")
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
        # The mesh is built from the world when first needed
        # (param_placements); the transformer's rules by default, as
        # JAXEstimator uses them (raydp_tpu/train/estimator.py:304-308).
        self.mesh_spec = mesh or MeshSpec()
        self.shard_params = shard_params
        if logical_rules is None:
            from raydp_tpu_torch.models.transformer import LOGICAL_RULES

            logical_rules = LOGICAL_RULES
        self.logical_rules = list(logical_rules)
        self._mesh: Optional[Mesh] = None
        self._placements: Optional[Dict[str, Placement]] = None
        self.seed = seed
        self.shuffle = shuffle
        self.callbacks = list(callbacks)
        self.log_every = log_every
        self.checkpoint_dir = checkpoint_dir
        self.save_every_steps = save_every_steps
        self.self_supervised = self_supervised
        self.prefetch = prefetch
        # Chunk copies the stream path's device loader keeps issued ahead
        # of the step (data/loader.py; the JAX estimator's infeed window).
        self.infeed_depth = max(1, infeed_depth)
        # Accepted for the JAX package's API only (module docstring).
        self.rng_impl = rng_impl
        self.drop_last = drop_last
        self.epoch_mode = epoch_mode
        self.scan_threshold_bytes = scan_threshold_bytes
        self.aux_losses = aux_losses
        # The step retry budget and donate_state, with the JAX package's
        # defaulting rules (raydp_tpu/train/estimator.py:241-273): an
        # explicit budget above 0 with donate_state unset turns "donation"
        # off so the retries happen; unset, the budget is 3 and inert.
        # Here "donation" means the in-place update (module docstring).
        explicit_retries = max_failures is not None
        self.max_failures = 3 if max_failures is None else max_failures
        if donate_state is None:
            donate_state = not (explicit_retries and self.max_failures > 0)
            if not donate_state:
                logger.warning(
                    "max_failures=%d requested: a step that fails before "
                    "its update is retried (pass donate_state=True to "
                    "re-raise every failure at once)", self.max_failures)
        elif donate_state and explicit_retries and self.max_failures > 0:
            logger.warning(
                "donate_state=True makes the max_failures=%d retry budget "
                "inert: a failed step re-raises at once", self.max_failures)
        self.donate_state = bool(donate_state)
        self._failures = 0
        # Set by _train_step once the step starts to change the state (the
        # gradient exchange or opt.step()): a failure after it is final.
        self._update_begun = False
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
        # World size that wrote the restored checkpoint (None: unknown),
        # and the per-rank batches the last resumed fit skipped.
        self._resume_world: Optional[int] = None
        self.resume_skip = 0
        self.history: List[Dict[str, float]] = []
        # Multi-process fits: the gradient exchange and the step clock,
        # live while a fit runs.
        self._allreduce: Optional[_GradAllReduce] = None
        self._loss_weight = 1.0
        self._clock: Optional[_StepClock] = None
        # The device plane, live while a fit runs (the sentinel stays for
        # inspection after it): the stream path's phase accumulator, and
        # the global grad norm of a step the sentinel checks.
        self._phases: Optional[_devplane.StepPhaseAccumulator] = None
        self._sentinel: Optional[_devplane.AnomalySentinel] = None
        self._want_grad_norm = False
        self._grad_norm: Optional[torch.Tensor] = None
        # The fit's first input, on the meta device: the shape whose step
        # the plane counts after the first epoch.
        self._first_input: Optional[torch.Tensor] = None

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        if self._optimizer is None:
            # Built on the parameters as this rank holds them: Adam's
            # moments follow the cut.
            self.param_placements()
            with _startup.part("optimizer"):
                self._optimizer = self._make_optimizer(
                    self._model.parameters())
        return self._optimizer

    # -- mesh -----------------------------------------------------------
    def param_placements(self) -> Dict[str, Placement]:
        """Each parameter's :class:`~raydp_tpu_torch.parallel.mesh.Placement`
        on the estimator's mesh, building the mesh (and cutting the
        parameters, with ``shard_params``) on first use: a data-parallel
        spec spans the whole world; any other must be exactly the world's
        size. Collective the first time in a gang: every rank calls it."""
        if self._placements is not None:
            return self._placements
        rank, world = _dist_world()
        spec = self.mesh_spec
        if spec.size > world:
            # An explicitly requested mesh that doesn't fit is a
            # misconfiguration (the JAX package's _ensure_mesh).
            raise ValueError(
                f"mesh {spec.axis_sizes} needs {spec.size} devices but "
                f"only {world} are visible (one card a process)")
        if spec.data_parallel_only:
            spec = MeshSpec(dp=world)
        elif spec.size != world:
            raise ValueError(
                f"mesh {spec.axis_sizes} must span the world: one process "
                f"a mesh position, but the world has {world}")
        bound = getattr(self._model, "mesh", None)
        if isinstance(bound, Mesh):
            # The model was cut at construction (cfg.mesh).
            if bound.spec != spec:
                raise ValueError(f"the model is sharded over {bound.spec}, "
                                 f"the estimator's mesh is {spec}")
            self._mesh = bound
            self._placements = param_placements(self._model, bound,
                                                self.logical_rules)
        else:
            self._mesh = spec.build()
            if self.shard_params and not spec.data_parallel_only:
                self._placements = shard_module(self._model, self._mesh,
                                                self.logical_rules)
            else:
                self._placements = {
                    n: Placement(self._mesh, ())
                    for n, _ in self._model.named_parameters()}
                if spec.size > 1:
                    # Nothing is cut, but the layers learn their groups
                    # (an MoE layer routes over dp).
                    bind_mesh(self._model, self._mesh)
        return self._placements

    @property
    def mesh(self) -> Optional[Mesh]:
        """The built mesh (None before :meth:`param_placements`)."""
        return self._mesh

    def _model_parallel(self) -> bool:
        return self._mesh is not None and \
            not self._mesh.spec.data_parallel_only

    def _mesh_weights(self) -> "tuple[float, float]":
        """(loss weight, stats weight) of this rank (module docstring):
        the loss is seeded on the first sp rank of the last pp stage, and
        the rows and loss are counted on that rank's tp 0."""
        c, shape = self._mesh.coords, self._mesh.shape
        seed = float(c["sp"] == 0 and c["pp"] == shape["pp"] - 1)
        return seed, seed * float(c["tp"] == 0)

    def _grad_groups(self) -> Dict[int, object]:
        """The group each parameter's gradient sums over: the dp, sp and
        pp axes that replicate it."""
        named = dict(self._model.named_parameters())
        out = {}
        for name, pl in self._placements.items():
            axes = [a for a in ("dp", "pp", "sp") if a in pl.replicated_axes]
            out[id(named[name])] = self._mesh.group(*axes) if axes else None
        return out

    def _data_world_size(self) -> int:
        """The number of data shards a position counts in: the mesh's dp
        size on a model-parallel mesh, else the process group's size."""
        if self._model_parallel():
            return self._mesh.shape["dp"]
        return _data_world()

    def gathered_state_dict(self) -> Dict[str, torch.Tensor]:
        """The model's ``state_dict`` with every sharded parameter gathered
        to its full shape (collective: every rank of a gang calls it)."""
        return gather_state_dict(self._model, self.param_placements())

    def _loaders(self, ds, columns, label, shuffle: bool, drop_last: bool):
        return [
            ds.to_torch(
                feature_columns=columns, label_column=label,
                batch_size=self.batch_size, rank=rank, shuffle=shuffle,
                seed=self.seed, feature_dtype=self.feature_dtype,
                label_dtype=self.label_dtype, prefetch=self.prefetch,
                device=self.device, drop_last=drop_last,
                infeed_depth=self.infeed_depth,
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
        # One root span a fit: epoch and step spans on this thread, ingest
        # spans on the prefetch thread and the workers' task spans parent
        # under it, so a fit reads as one tree in the merged trace.
        with span("train/fit", epochs=epochs):
            self._fit(train_ds, evaluate_ds, epochs, resume_from)
        # The last epoch flushed before the fit span closed.
        flush_spans()
        for cb in self.callbacks:
            cb.on_train_end(self.history)
        return self.history

    def _fit(self, train_ds, evaluate_ds, epochs: int,
             resume_from: Optional[str]) -> None:
        self._failures = 0
        rank, world = _dist_world()
        self.param_placements()
        install_compile_listener()
        plane = _devplane.enabled()
        self._sentinel = _devplane.AnomalySentinel() if plane else None
        if self._use_scan(train_ds) and resume_from is None:
            self.effective_epoch_mode = "scan"
            self._fit_scan(train_ds, evaluate_ds, epochs)
        else:
            self.effective_epoch_mode = "stream"
            if world > 1:
                self._generator.manual_seed(_rank_seed(self.seed,
                                                       self._data_rank()))
                if self._model_parallel():
                    self._loss_weight, stats_w = self._mesh_weights()
                    self._allreduce = _GradAllReduce(
                        self._model.parameters(), self._grad_groups(),
                        stats_weight=stats_w)
                else:
                    self._allreduce = _GradAllReduce(
                        self._model.parameters())
            if world > 1 or plane:
                self._clock = _StepClock(self.device)
            if plane:
                self._phases = _devplane.StepPhaseAccumulator("train_step")
            try:
                self._fit_stream(train_ds, evaluate_ds, epochs, resume_from)
            finally:
                self._allreduce = self._clock = self._phases = None
                self._loss_weight = 1.0

    def _data_rank(self) -> int:
        """This rank's dropout stream: its place among the ranks that see
        different activations (dp and sp; tp and pp peers share one)."""
        if not self._model_parallel():
            return _dist_world()[0]
        c, shape = self._mesh.coords, self._mesh.shape
        return c["dp"] * shape["sp"] + c["sp"]

    def _train_step(self, x: torch.Tensor,
                    y: Optional[torch.Tensor]) -> torch.Tensor:
        """One optimizer step on the batch ``(x, y)``, its loss added to
        the epoch's sum on the device; returns the loss. Both paths run
        it: the stream path eagerly, the scan path as a CUDA graph on a
        card."""
        clock = self._clock
        if clock is not None:
            # Before the optimizer: a fit's first step builds it (imports
            # included), host time inside the step's span.
            clock.begin()
            h0 = time.perf_counter()
            t0 = clock.mark()
        opt = self.optimizer
        exchange_s = 0.0
        opt.zero_grad(set_to_none=True)
        loss = self._loss_fn(self._model(x), self._target(x, y))
        objective = loss
        if self.aux_losses:
            aux = moe_aux_loss(self._model)
            loss = loss + aux
            # The dp group's loss, each rank's tokens' gradient: weighted
            # by the dp size, the global rows' sum adds it once.
            objective = loss if self._allreduce is None else \
                objective + aux * self._data_world_size()
        if self._allreduce is not None:
            # The rank's rows weigh its loss: the reduced gradient over
            # the global rows is the global batch mean's. On a model-
            # parallel mesh one rank of each sp/pp group seeds it.
            (objective * (len(x) * self._loss_weight)).backward()
            t1 = clock.mark()
            self._update_begun = True
            h1 = time.perf_counter()
            loss = self._allreduce(loss.detach() * len(x), len(x),
                                   fault.preemption_requested())
            exchange_s = time.perf_counter() - h1
            t2 = clock.mark()
        else:
            loss.backward()
            self._update_begun = True
            t1 = t2 = None
        if self._want_grad_norm:
            # The sentinel checks this step: the global grad norm (after
            # the exchange), a tensor read at its check.
            self._grad_norm = torch.nn.utils.get_total_norm(
                [p.grad for p in self._model.parameters()
                 if p.grad is not None])
        opt.step()
        if clock is not None:
            clock.end((t0, t1, t2, clock.mark()), h0, time.perf_counter(),
                      exchange_s)
        loss = loss.detach()
        self._loss_sum += loss
        return loss

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run_step(self, step: Callable, x: torch.Tensor,
                  y: Optional[torch.Tensor]) -> torch.Tensor:
        """``step(x, y)`` under the retry budget (the module docstring):
        an eager step that failed before its update runs again on the same
        batch, the dropout generator put back, while the fit's failures
        stay within ``max_failures``; any other failure re-raises."""
        if self.donate_state or self.max_failures <= 0:
            return step(x, y)
        # A capture or replay of the CUDA graph is one launch that holds
        # the update: never retried.
        eager = not isinstance(step, CapturedStep) or (
            step.warmed < step.warmup)
        while True:
            self._update_begun = not eager
            saved = self._generator.get_state() if eager else None
            try:
                return step(x, y)
            except Exception:
                if self._update_begun:
                    raise
                self._failures += 1
                if self._failures > self.max_failures:
                    raise
                logger.warning("train step failed before its update "
                               "(%d/%d); retrying the batch",
                               self._failures, self.max_failures,
                               exc_info=True)
                self._generator.set_state(saved)

    def _preempt_due(self, gang_wide: bool) -> bool:
        """Whether this step boundary drains. One process drains on its
        own notice; a gang's ranks must drain after the same step, so a
        rank drains when the step's exchange counted a notice, or when a
        plan's ``preempt`` clause without ``rank=`` fired (every rank
        gets it at this step)."""
        if self._allreduce is None:
            return fault.preemption_requested()
        return gang_wide or self._allreduce.preempt_votes() > 0

    def _drain_preemption(self, step: int, epoch: int, b_idx: int) -> None:
        """A preemption notice landed: write ``step_emergency_<step>.pt``
        at the data position ``(epoch, b_idx)`` (when ``checkpoint_dir``
        is set), cancel the notice's force-exit deadline and raise
        :class:`~raydp_tpu_torch.fault.PreemptionError`. Runs at a step
        boundary, so the state saved is a finished optimizer step; in a
        gang every rank enters it after the same step (``save`` is
        collective)."""
        t0 = time.perf_counter()
        _events.emit("preempt/drain", step=step, epoch=epoch, batch=b_idx)
        path = None
        if self.checkpoint_dir:
            path = self.save(self.checkpoint_dir, step=f"emergency_{step}",
                             data_position=(epoch, b_idx))
            _events.emit("checkpoint/emergency", path=path, step=step,
                         epoch=epoch, batch=b_idx)
            logger.warning("preemption drain: emergency checkpoint at %s "
                           "(step %d, epoch %d, batch %d)", path, step,
                           epoch, b_idx)
        else:
            logger.warning("preemption drain: no checkpoint_dir "
                           "configured; exiting without an emergency "
                           "checkpoint")
        drain_s = time.perf_counter() - t0
        _flight.record("train", "preempt_drain", step=step, epoch=epoch,
                       batch=b_idx, **({"path": path} if path else {}))
        flush_spans()
        fault.mark_drained()
        raise fault.PreemptionError(
            f"preempted at step {step} (epoch {epoch}, batch {b_idx}); "
            f"emergency checkpoint: {path or 'none'} (drained in "
            f"{drain_s:.3f} s)", checkpoint_path=path)

    def _fit_stream(self, train_ds, evaluate_ds, epochs: int,
                    resume_from: Optional[str]) -> None:
        """The stream epochs. A resume continues at the checkpoint's data
        position; a checkpoint written by another world size has its
        per-rank batch index rescaled by saved/current, as in the JAX
        package (``raydp_tpu/train/estimator.py:761-780``): the same
        global position lands on another per-rank index, rounding to
        the nearest batch, and which rows follow is the new world's
        shard plan, so a resize replays or skips at most about a batch
        (approximate across worlds)."""
        loaders = self._loaders(train_ds, self.feature_columns,
                                self.label_column, self.shuffle,
                                self.drop_last)
        start_epoch, skip_batches = 0, 0
        if resume_from is not None:
            self.restore_path(resume_from)
            if self._resume_position is not None:
                start_epoch, skip_batches = self._resume_position
                saved_world = self._resume_world
                cur_world = self._data_world_size()
                if saved_world and saved_world != cur_world:
                    skip_batches = int(round(skip_batches * saved_world
                                             / cur_world))
                    logger.info("elastic resume: world %d -> %d, per-rank "
                                "skip rescaled to %d batches", saved_world,
                                cur_world, skip_batches)
        self.resume_skip = skip_batches
        if self._allreduce is not None:
            self._broadcast_state()
        first_step_at = None
        step_timer = _metrics.timer("train/step")
        self._first_input = None
        for epoch in range(start_epoch, epochs):
            t0 = time.perf_counter()
            self._model.train()
            for loader in loaders:
                loader.set_epoch(epoch)
            to_skip = skip_batches if epoch == start_epoch else 0
            self._loss_sum.zero_()
            _flight.record("train", "epoch_start", epoch=epoch,
                           mode="stream")
            # The epoch span covers the batch loop only: it closes before
            # _finish_epoch, so the flush there sees it finished.
            loop_t0 = time.perf_counter()
            with span("train/epoch", epoch=epoch, mode="stream"):
                n_batches, n_samples, first_step_at = self._stream_epoch(
                    loaders, epoch, to_skip, step_timer, first_step_at)
            train_loss = float(self._loss_sum) / max(1, n_batches)  # one sync
            loop_wall = time.perf_counter() - loop_t0
            extra: Dict = {}
            if self._clock is not None:
                totals = self._clock.epoch_totals()
                if self._allreduce is not None:
                    n = max(1, totals["steps"])
                    extra["step_ms"] = totals["step_ms"] / n
                    extra["allreduce_ms"] = totals["allreduce_ms"] / n
                    if epoch == start_epoch and first_step_at is not None:
                        extra["first_step_at"] = first_step_at
                if self._phases is not None and self._phases.epoch_steps:
                    self._note_step_cost()
                    summary = self._phases.epoch_summary(
                        loop_wall, totals["step_ms"] / 1e3,
                        totals["allreduce_ms"] / 1e3,
                        totals["paced_ms"] / 1e3)
                    extra["phases"] = summary
                    extra["bound"] = summary["bound"]
                    if "mfu" in summary:
                        extra["mfu"] = summary["mfu"]
                    # analyze's device-plane section reads this event.
                    _event("train/phases", epoch=epoch, **{
                        k: v for k, v in summary.items()
                        if isinstance(v, (int, float, str))})
            if self._sentinel is not None:
                # Every epoch's loss is checked at its one sync (the
                # sampled cadence may miss a short epoch's NaN step).
                self._sentinel.check_loss(train_loss, self._step,
                                          epoch=epoch)
            self._finish_epoch(epoch, t0, train_loss, n_samples, evaluate_ds,
                               extra)

    def _note_step_cost(self) -> None:
        """Register the FLOPs of a step at the fit's first input shape for
        the device plane's ``mfu``, once a fit, after its first epoch's
        loop (out of its wall): counted on the meta device
        (``utils/profiling.count_train_step``), once a process for each
        model and input shape."""
        if self._first_input is None:
            return
        x, self._first_input = self._first_input, None
        if self._model_parallel():
            return  # the meta-device pass cannot run the collectives
        _devplane.note_compiled("train_step",
                                count_train_step(self._model, (x,)))

    def _stream_epoch(self, loaders, epoch: int, to_skip: int, step_timer,
                      first_step_at):
        """One stream epoch's steps; returns ``(batches, samples,
        first_step_at)``."""
        b_idx = to_skip
        n_batches = n_samples = 0
        phases, sentinel = self._phases, self._sentinel
        batches = enumerate(self._batches(loaders))
        while True:
            # Time blocked on the next batch: the step's input wait.
            t_wait = time.perf_counter()
            try:
                i, (x, y) = next(batches)
            except StopIteration:
                break
            if i < to_skip:
                continue
            if phases is not None:
                phases.note_input_wait(time.perf_counter() - t_wait)
                if self._first_input is None and not phases.total_steps:
                    # The shape _note_step_cost counts; no data is kept.
                    self._first_input = torch.empty_like(x, device="meta")
            self._want_grad_norm = (sentinel is not None
                                    and sentinel.wants_check(self._step + 1))
            # A step that never returns (a wedged device or
            # collective) shows in the watchdog as "train/step" with
            # its index; an epoch's first step may build kernels and
            # gets the long threshold.
            with _watchdog.inflight(
                "train/step", epoch=epoch, step=b_idx,
                stall_after_s=(_watchdog.long_stall_s()
                               if n_batches == 0 else None),
            ), span("train/step", epoch=epoch, step=b_idx) as sp, \
                    _startup.part("first_step", sync=self._sync):
                loss = self._run_step(self._train_step, x, y)
            step_timer.observe(sp.duration_s)
            if phases is not None:
                phases.step(sp.duration_s)
            if sentinel is not None:
                sentinel.observe_step(sp.duration_s, b_idx, epoch=epoch)
                if self._want_grad_norm:
                    # The sampled sync: the only one the plane adds.
                    sentinel.check_loss(float(loss), b_idx, epoch=epoch)
                    if self._grad_norm is not None:
                        sentinel.check_grad_norm(float(self._grad_norm),
                                                 b_idx, epoch=epoch)
                    self._want_grad_norm = False
                    self._grad_norm = None
            if self._clock is not None and first_step_at is None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                first_step_at = time.time()
            n_batches += 1
            b_idx += 1
            self._step += 1
            n_samples += len(x)
            if (self.save_every_steps and self.checkpoint_dir
                    and self._step % self.save_every_steps == 0):
                self.save(self.checkpoint_dir, step=f"mid_{self._step}",
                          data_position=(epoch, b_idx))
            # The fault plane fires at this boundary, after the step
            # and any scheduled save, and a notice drains here, so the
            # emergency checkpoint holds a finished step.
            gang_wide = (fault.on_train_step(self._step)
                         if fault.active() else False)
            if self._preempt_due(gang_wide):
                self._drain_preemption(self._step, epoch, b_idx)
            if self.log_every and n_batches % self.log_every == 0:
                logger.info("epoch %d step %d loss %.5f", epoch,
                            n_batches, float(loss))  # sync: opt-in
        return n_batches, n_samples, first_step_at

    def _broadcast_state(self) -> None:
        """Rank 0's parameters and buffers to every rank, before the
        first step of a multi-process fit."""
        import torch.distributed as dist

        with torch.no_grad():
            if self._model_parallel():
                # Each block from the first rank holding it.
                mesh = self._mesh
                for name, p in self._model.named_parameters():
                    axes = self._placements[name].replicated_axes
                    if axes:
                        _coll.broadcast_raw(p.data, mesh.members(*axes)[0],
                                            mesh.group(*axes))
                for t in self._model.buffers():
                    dist.broadcast(t.data, src=0)
                return
            for t in list(self._model.parameters()) + list(
                    self._model.buffers()):
                dist.broadcast(t.data, src=0)

    # -- scan path --------------------------------------------------------
    def _use_scan(self, train_ds) -> bool:
        """Whether a fit runs the scan path: the JAX package's rule
        (``raydp_tpu/train/estimator.py:930-974``) for one process, plus
        one of the card's: ``"auto"`` streams where the optimizer's step
        cannot be captured into a CUDA graph
        (:func:`~raydp_tpu_torch.utils.graphed.capture_refusal`)."""
        if self.epoch_mode == "stream":
            return False
        if _dist_world()[1] > 1:
            # A multi-process fit streams per-rank shards: the scan path
            # would materialize the whole dataset per process, and a
            # CUDA graph cannot capture a gloo collective.
            if self.epoch_mode == "scan":
                logger.warning(
                    "epoch_mode='scan' requested but this is a "
                    "multi-process fit; streaming per-rank shards instead")
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
            _flight.record("train", "epoch_start", epoch=epoch,
                           mode="scan", n_steps=n_steps)
            # The scan path's progress unit is the epoch (the JAX
            # package fuses it into one dispatch): long-op threshold.
            with _watchdog.inflight("train/epoch", epoch=epoch, mode="scan",
                                    stall_after_s=_watchdog.long_stall_s()), \
                    span("train/epoch", epoch=epoch, mode="scan",
                         n_steps=n_steps):
                for i in range(0, n_steps * batch, batch):
                    self._run_step(step, xe[i:i + batch],
                                   None if ye is None else ye[i:i + batch])
            self._step += n_steps
            # The mean over the fused steps, padded rows included, as
            # JAX's losses.mean(); samples count the true rows.
            train_loss = float(self._loss_sum) / n_steps  # one sync
            if self._sentinel is not None:
                # One graph replay a step, no host loop inside the epoch:
                # only the epoch's loss is checked, at its sync.
                self._sentinel.check_loss(train_loss, self._step,
                                          epoch=epoch)
            metrics = self._finish_epoch(epoch, t0, train_loss, n_true,
                                         evaluate_ds)
            if self.log_every:
                logger.info("epoch %d (%d fused steps) loss %.5f", epoch,
                            n_steps, metrics["train_loss"])

    def fit_on_df(self, train_df, evaluate_df=None,
                  num_epochs: Optional[int] = None,
                  num_shards: int = 1) -> List[Dict[str, float]]:
        """The ETL handoff: DataFrame → :class:`MLDataset` → :meth:`fit`.
        Takes a :mod:`raydp_tpu_torch.dataframe` DataFrame or a pandas
        one."""
        train_ds = MLDataset.from_df(_ensure_df(train_df),
                                     num_shards=num_shards,
                                     shuffle=self.shuffle,
                                     shuffle_seed=self.seed)
        eval_ds = (MLDataset.from_df(_ensure_df(evaluate_df),
                                     num_shards=num_shards)
                   if evaluate_df is not None else None)
        return self.fit(train_ds, eval_ds, num_epochs)

    def _finish_epoch(self, epoch: int, t0: float, train_loss: float,
                      n_samples: int, evaluate_ds,
                      extra: Optional[Dict[str, float]] = None
                      ) -> Dict[str, float]:
        dt = time.perf_counter() - t0
        _metrics.counter_add("train/epochs")
        _metrics.meter("train/samples").add(n_samples)
        _metrics.timer("train/epoch").observe(dt)
        # This process held its card the whole epoch: summed over a
        # gang's ranks, the ledger reads in the gang's chip-seconds.
        _acct.add_usage(_acct.CHIP_SECONDS, dt * _CARDS_PER_PROCESS)
        metrics: Dict[str, float] = {
            "epoch": epoch,
            "train_loss": train_loss,
            "time_s": dt,
            "samples": n_samples,
            "samples_per_sec": n_samples / max(1e-9, dt),
        }
        metrics.update(extra or {})
        if evaluate_ds is not None:
            metrics.update(self.evaluate(evaluate_ds, prefix="eval_"))
        self.history.append(metrics)
        for cb in self.callbacks:
            cb.on_epoch_end(epoch, metrics)
        if self.checkpoint_dir:
            # Epoch-end checkpoints point at the next epoch's first batch.
            self.save(self.checkpoint_dir, step=epoch,
                      data_position=(epoch + 1, 0))
        # The epoch boundary is the span ring's flush point (a no-op
        # without RAYDP_TPU_TELEMETRY_DIR).
        flush_spans()
        return metrics

    @torch.no_grad()
    def evaluate(self, ds, prefix: str = "") -> Dict[str, float]:
        """Loss and metrics over ``ds`` in eval mode, each the mean of the
        batch values weighted by the batches' true lengths."""
        self.param_placements()
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
        time; returns the model's outputs as numpy. In a gang every rank
        calls it (the model's collectives)."""
        self.param_placements()
        model = self._model.eval()
        x = np.asarray(x, dtype=self.feature_dtype)
        if len(x) == 0:
            return self._empty_preds(model, x.shape[1:])
        outs = []
        for i in range(0, len(x), self.batch_size):
            chunk = torch.from_numpy(x[i:i + self.batch_size]).to(self.device)
            outs.append(model(chunk).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    @torch.no_grad()
    def predict_on_ds(self, ds: MLDataset,
                      feature_columns: Optional[List[str]] = None
                      ) -> np.ndarray:
        """Inference over every shard of ``ds`` through its device
        loaders; rows come back in dataset order, exactly
        ``ds.total_rows`` of them: the padded per-shard outputs are
        scattered through ``ds.shard_global_indices``, so padding rows
        collapse onto the rows they repeat."""
        self.param_placements()
        model = self._model.eval()
        cols = feature_columns or self.feature_columns
        outs = [model(x).float().cpu().numpy()
                for loader in self._loaders(ds, cols, None, shuffle=False,
                                            drop_last=False)
                for x in loader]
        if not outs:
            return np.empty((0,), dtype=np.float32)
        flat = np.concatenate(outs, axis=0)
        idx = np.concatenate([ds.shard_global_indices(r)
                              for r in range(ds.num_shards)])
        if len(flat) != len(idx):
            raise RuntimeError(
                f"prediction count {len(flat)} does not match the shard "
                f"plan's {len(idx)} samples: loader/plan mismatch")
        out = np.empty((ds.total_rows,) + flat.shape[1:], dtype=flat.dtype)
        out[idx] = flat
        return out

    def predict_on_df(self, df, output_column: str = "prediction",
                      num_shards: int = 1):
        """A pandas DataFrame of ``df``'s rows with a prediction column,
        aligned by position: ``from_df`` keeps partition order, the
        shard loaders run in rank order, and ``to_pandas`` concatenates
        partitions in that order. A multi-output model gets one row
        array per cell."""
        df = _ensure_df(df)
        preds = self.predict_on_ds(MLDataset.from_df(df,
                                                     num_shards=num_shards))
        pdf = df.to_pandas()
        if preds.ndim > 1 and preds.shape[-1] == 1:
            preds = preds[..., 0]
        pdf[output_column] = preds if preds.ndim == 1 else list(preds)
        return pdf

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
        optimizer, step count, ``data_position=(epoch, batch)``, the
        writing world size (``data_world``) and the dropout generator's
        state. Returns the path.

        In a multi-process fit every rank must enter (as every rank
        enters orbax's save in the JAX package): the ranks' generator
        states are gathered, rank 0 writes the file and prunes, and all
        ranks leave together after a barrier, so none reads a file that
        is not there yet. On a model-parallel mesh the parameters and the
        optimizer state are gathered to their full shapes first, so the
        file restores onto any mesh."""
        import torch.distributed as dist

        rank, world = _dist_world()
        model_state = self.gathered_state_dict()
        opt_state = self._gather_optimizer_state()
        name = f"step_{step}.pt" if step is not None else "final.pt"
        path = os.path.abspath(os.path.join(checkpoint_dir, name))
        generators = None
        if world > 1:
            generators = [None] * world
            dist.all_gather_object(generators, self._generator.get_state())
        if rank == 0:
            os.makedirs(checkpoint_dir, exist_ok=True)
            epoch, batch = (data_position if data_position is not None
                            else (-1, -1))
            state = {
                "model": model_state,
                "optimizer": opt_state,
                "step": self._step,
                "data_epoch": epoch,
                "data_batch": batch,
                "data_world": self._data_world_size(),
                "generator": self._generator.get_state(),
            }
            if generators is not None:
                state["rank_generators"] = generators
            tmp = f"{path}.{os.getpid()}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, path)  # a reader never sees half a checkpoint
            _prune_checkpoints(checkpoint_dir)
        if world > 1:
            dist.barrier()
        _events.emit("checkpoint/complete", path=str(path), step=str(step))
        return path

    def restore(self, checkpoint_dir: str, step=None,
                sample_x: Optional[np.ndarray] = None) -> None:
        """Restore ``step_<step>.pt`` under ``checkpoint_dir``
        (``final.pt`` without a step), as the JAX estimator resolves its
        directories. ``sample_x`` is accepted for the JAX signature and
        unused: the port's model exists from construction."""
        del sample_x
        name = f"step_{step}.pt" if step is not None else "final.pt"
        self.restore_path(os.path.abspath(os.path.join(checkpoint_dir,
                                                       name)))

    def _opt_placements(self) -> List[Placement]:
        """The placement of each optimizer parameter index (the optimizer
        is built on ``model.parameters()``, in that order)."""
        placements = self.param_placements()
        return [placements[n] for n, _ in self._model.named_parameters()]

    def _gather_optimizer_state(self) -> dict:
        """The optimizer's ``state_dict`` with each parameter's state
        tensors shaped like it gathered (collective; a no-op without cut
        parameters)."""
        sd = self.optimizer.state_dict()
        placements = self._opt_placements()
        if not any(pl.sharded_axes for pl in placements):
            return sd
        shapes = [p.shape for p in self._model.parameters()]
        for i, st in sd["state"].items():
            pl = placements[i]
            if pl.sharded_axes:
                sd["state"][i] = {
                    k: pl.gather(v) if torch.is_tensor(v)
                    and v.shape == shapes[i] else v for k, v in st.items()}
        return sd

    def _cut_optimizer_state(self, sd: dict) -> dict:
        """A full optimizer ``state_dict`` cut to this rank's blocks."""
        placements = self._opt_placements()
        if not any(pl.sharded_axes for pl in placements):
            return sd
        shapes = [p.shape for p in self._model.parameters()]
        state = {}
        for i, st in sd["state"].items():
            pl = placements[int(i)]
            state[i] = {
                k: pl.shard(v) if pl.sharded_axes and torch.is_tensor(v)
                and v.dim() > 0 and v.shape != shapes[int(i)] else v
                for k, v in st.items()}
        return {**sd, "state": state}

    def shutdown(self) -> None:
        """Drop the model and the optimizer with their device state (the
        JAX estimator's ``shutdown``; a scan fit's captured step lives
        only for its fit). The estimator cannot train or predict
        afterwards."""
        self._model = None
        self._optimizer = None
        self._loss_sum = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()

    def restore_path(self, path: str) -> None:
        """Restore everything :meth:`save` wrote from exactly ``path``.

        The dropout generator: a rank of the world size that wrote the
        file resumes its own stream (``rank_generators`` in a gang, the
        one ``generator`` outside); under another world size each rank
        starts the stream a fresh rank of this world starts
        (``_rank_seed``). A file without ``data_world`` (0: unknown, as
        older files) restores as before: the rank's stream where the
        gang's size matches, else rank 0's."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        placements = self.param_placements()
        self._model.load_state_dict({
            k: placements[k].shard(v) if k in placements else v
            for k, v in state["model"].items()})
        self.optimizer.load_state_dict(
            self._cut_optimizer_state(state["optimizer"]))
        self._step = int(state["step"])
        rank, world = _dist_world()
        saved_world = int(state.get("data_world", 0))
        self._resume_world = saved_world if saved_world > 0 else None
        generators = state.get("rank_generators")
        if self._resume_world not in (None, self._data_world_size()):
            self._generator.manual_seed(_rank_seed(self.seed,
                                                   self._data_rank()))
        elif generators is not None and len(generators) == world:
            # The same gang's rank resumes its own dropout stream.
            self._generator.set_state(generators[rank])
        else:
            self._generator.set_state(state["generator"])
        epoch, batch = int(state["data_epoch"]), int(state["data_batch"])
        self._resume_position = (epoch, batch) if epoch >= 0 else None


def _ckpt_keep() -> int:
    raw = os.environ.get(CKPT_KEEP_ENV, "")
    try:
        return max(0, int(raw)) if raw else _DEFAULT_CKPT_KEEP
    except ValueError:
        return _DEFAULT_CKPT_KEEP


_STEP_RE = re.compile(r"^step_(?:mid|emergency)_(\d+)\.pt$")


def _prune_checkpoints(checkpoint_dir: str) -> None:
    """Remove the oldest step-encoded checkpoints (``step_mid_<N>.pt``
    and ``step_emergency_<N>.pt`` together) beyond the retention cap,
    ordered by the step in the name, so the newest always survives.
    Only complete files count: :meth:`Estimator.save` renames a finished
    file into place, and a ``*.tmp`` never matches. Epoch-end and
    ``final.pt`` files are never pruned."""
    keep = _ckpt_keep()
    if keep <= 0:
        return
    mids = sorted((int(m.group(1)), os.path.join(checkpoint_dir, n))
                  for n in os.listdir(checkpoint_dir)
                  for m in [_STEP_RE.match(n)] if m)
    for step_n, path in mids[:max(0, len(mids) - keep)]:
        try:
            os.remove(path)
        except FileNotFoundError:
            continue  # removed by a concurrent prune
        _events.emit("checkpoint/prune", path=path, step=str(step_n),
                     keep=keep)


def _ensure_df(df):
    """A pandas DataFrame as an engine DataFrame; anything else as is."""
    if df is None:
        return None
    import pandas as pd

    if isinstance(df, pd.DataFrame):
        from raydp_tpu_torch.dataframe.io import from_pandas

        return from_pandas(df)
    return df


def _pad_cycle(x: np.ndarray, y: Optional[np.ndarray], pad: int):
    """Pad by ``pad`` rows cycled from the start (the JAX package's one
    padding convention, ``raydp_tpu/train/estimator.py:1495-1503``);
    ``pad`` may exceed ``len(x)``."""
    idx = np.arange(pad) % len(x)
    x = np.concatenate([x, x[idx]])
    if y is not None:
        y = np.concatenate([y, y[idx]])
    return x, y
