"""TorchEstimator: the reference-API-compatible torch trainer on the card
(the port's copy of ``raydp_tpu/train/torch_estimator.py``).

Migration-path capability (reference C12, python/raydp/torch/estimator.py):
users with existing ``torch.nn.Module`` pipelines keep their estimator
surface — model/optimizer/loss/lr-scheduler as instances or creator
functions, ``fit``/``fit_on_df``/``evaluate``/``get_model``/``save``/
``restore``/``shutdown`` — while the data path is this framework's
DataFrame → MLDataset shards instead of Spark → Ray Datasets.

In the JAX package this estimator runs torch on the host CPU. Here it is
the path on which a user's own ``nn.Module`` trains on the card from the
port's ETL: ``device=`` (default ``"cuda"``) is where the model, the shard
and the sums live, and ``device="cpu"`` runs it on the host.

What stays as in the JAX package, because a fit on the CPU must equal
it: the global ``torch.manual_seed(seed + rank)`` before the model is
built (the user's creator draws from it); the model built on the CPU and
then moved to ``device``; ``DistributedDataParallel`` over gloo for a
world above 1; the ``DataLoader``'s shuffle (the same ``RandomSampler``
draws from the global generator); and the loss and accuracy sums, f32
values summed in f64.

What the card changes (:func:`_train_on_shard`):

* the shard crosses to the device once a fit, not a batch a step;
* each epoch's batch order is drawn on the CPU by a ``DataLoader`` over
  row indices (the reference's draws, in its order), crosses once, and
  the batches are gathered on the device;
* the loss, accuracy and counts are f64 device tensors, read once an
  epoch: no ``.item()`` and no read of the binary-target test per batch.
  Nothing is left per batch.

Other differences from the JAX package:

* ``num_workers > 1`` data-parallelism runs as a gang of processes via
  the port's SPMD job runner with ``torch.distributed`` (gloo)
  allreduce; the ranks share the card (``cuda:<local rank mod cards>``);
  DDP over gloo stages each gradient bucket through the host.
* The config travels to the ranks through the port's closure carrier
  with its classes by value (``cluster/closure.py``), where the JAX
  package uses cloudpickle; a model instance on the card travels as a
  CPU copy.
* The trained state is kept as CPU tensors, not numpy arrays (numpy has
  no bfloat16); ``predict`` returns bfloat16 outputs as float32.
* ``get_model`` returns the module on ``device``.
* Accuracy is argmax/threshold accuracy; the reference's
  ``(outputs == targets)`` exact-float-equality counter
  (reference: torch/estimator.py:237) is a bug not reproduced.
"""
from __future__ import annotations

import copy
import inspect
import os
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from raydp_tpu_torch.cluster import closure
from raydp_tpu_torch.data.ml_dataset import MLDataset, resolve_plan_tables
from raydp_tpu_torch.utils.device import DeviceLike, resolve_device
from raydp_tpu_torch.utils import startup
from raydp_tpu_torch.utils.net import find_free_port

__all__ = ["TorchEstimator"]


def _build_model(spec, config):
    if isinstance(spec, torch.nn.Module):
        return spec
    if callable(spec):
        m = spec(config) if _arity(spec) >= 1 else spec()
        if not isinstance(m, torch.nn.Module):
            raise TypeError("model creator must return a torch.nn.Module")
        return m
    raise TypeError(
        "model must be a torch.nn.Module or a creator function "
        "(reference contract, torch/estimator.py:154-162)"
    )


def _build_optimizer(spec, model, config):
    if isinstance(spec, torch.optim.Optimizer):
        # Instance case: re-bind onto this process's model parameters,
        # keeping hyperparameters (reference rewrites likewise,
        # torch/estimator.py:164-171). The constructor defaults carry
        # lr/momentum/etc; multi-param-group schedules cannot survive a
        # rebind onto a fresh model, so flag that instead of silently
        # training with different hyperparameters.
        if len(spec.param_groups) > 1:
            raise ValueError(
                "optimizer instances with multiple param groups cannot be "
                "re-bound onto worker models; pass a creator function "
                "`lambda model, config: ...` instead"
            )
        hyper = {
            k: spec.param_groups[0].get(k, v) for k, v in spec.defaults.items()
        }
        rebound = spec.__class__(model.parameters(), **hyper)
        # Carry warm-start state (momentum/Adam moments) across the rebind
        # like the reference's load_state_dict transfer
        # (torch/estimator.py:164-171); shape mismatches (different model)
        # fall back to fresh state.
        try:
            rebound.load_state_dict(spec.state_dict())
        except (ValueError, KeyError, RuntimeError):
            pass
        return rebound
    if callable(spec):
        return spec(model, config) if _arity(spec) >= 2 else spec(model)
    if spec is None:
        return torch.optim.Adam(model.parameters(), lr=1e-3)
    raise TypeError("optimizer must be an Optimizer instance or creator")


def _build_loss(spec, config):
    loss_cls = torch.nn.modules.loss._Loss
    # Any nn.Module subclass is a criterion class (custom losses usually
    # subclass nn.Module, not the private _Loss) — instantiate with no
    # args rather than falling through to the creator branch, which would
    # wrongly pass the config dict to the constructor.
    if inspect.isclass(spec) and issubclass(spec, torch.nn.Module):
        return spec()
    # Any Module instance is a criterion to use as-is (custom losses
    # usually subclass nn.Module, not the private _Loss).
    if isinstance(spec, (loss_cls, torch.nn.Module)):
        return spec
    if callable(spec):
        return spec(config) if _arity(spec) >= 1 else spec()
    raise TypeError("loss must be a torch loss class/instance or creator")


def _arity(fn) -> int:
    try:
        return len([
            p for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
        ])
    except (TypeError, ValueError):
        return 1


def _concat_columns(
    shards: List[Dict[str, np.ndarray]]
) -> Dict[str, np.ndarray]:
    if len(shards) == 1:
        return shards[0]
    return {
        k: np.concatenate([s[k] for s in shards]) for k in shards[0]
    }


def _all_rows(ds: MLDataset, columns: Sequence[str]) -> Dict[str, np.ndarray]:
    """Every distinct row once, one column dict. Shards are wrap-padded to
    equal size (sharding.py divide_blocks), so the concat is sliced back to
    ``total_rows`` — keeping the padding would double-count head rows."""
    full = _concat_columns(
        [ds.shard_columns(s, list(columns)) for s in range(ds.num_shards)]
    )
    return {k: v[: ds.total_rows] for k, v in full.items()}


def _clamp_to_true(padded: List[int], total: int) -> List[int]:
    """Rows each padded shard contributes to the original sequence (the
    wrap-around padding excluded). Only correct while divide_blocks
    places its padding exclusively on TRAILING ranks: once a rank is
    clamped short, every later rank must be pure padding (true size 0) —
    asserted."""
    out, seen = [], 0
    for n in padded:
        out.append(min(n, max(0, total - seen)))
        seen += n
    first_short = next(
        (i for i, (n, t) in enumerate(zip(padded, out)) if t < n), None
    )
    if first_short is not None:
        if not all(t == 0 for t in out[first_short + 1:]):
            # A real error, not an assert: under ``python -O`` an assert
            # vanishes and eval rows get silently misattributed.
            raise RuntimeError(
                "divide_blocks padding layout changed; true-size clamp "
                f"misattributes rows: padded={padded} true={out}"
            )
    return out


def _true_shard_sizes(ds: MLDataset) -> List[int]:
    padded = [
        sum(s.num_samples for s in ds.shard_plan[r])
        for r in range(ds.num_shards)
    ]
    return _clamp_to_true(padded, ds.total_rows)


def _materialize_plan(
    master_address: str,
    namespace: str,
    blocks: List[Any],
    plan: List[Any],
    columns: Sequence[str],
    true_rows: Optional[int] = None,
    node_id: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """``resolve_plan_tables`` merged into column arrays; ``true_rows``
    truncates trailing wrap-around padding (eval shards)."""
    import pyarrow as pa

    tables = resolve_plan_tables(
        master_address, namespace, blocks, plan, node_id=node_id
    )
    merged = (
        pa.concat_tables(tables, promote_options="default")
        if len(tables) > 1
        else tables[0]
    )
    if true_rows is not None and true_rows < merged.num_rows:
        merged = merged.slice(0, true_rows)
    return {
        c: merged.column(c).to_numpy(zero_copy_only=False)
        for c in columns
    }


def _rows_range(
    ds: MLDataset,
    columns: Sequence[str],
    start: int,
    count: int,
    cache: Optional[Dict[int, Dict[str, np.ndarray]]] = None,
) -> Dict[str, np.ndarray]:
    """``count`` rows of the shard-concatenated dataset starting at global
    row ``start``, wrapping modulo total (equal-rank-rows top-up). Only the
    shards overlapping the range are materialized; ``cache`` (if given)
    holds the last decoded shard so consecutive ranks sharing a boundary
    shard decode it once."""
    total = ds.total_rows
    sizes = _true_shard_sizes(ds)
    bounds = np.cumsum([0] + sizes)
    pieces: List[Dict[str, np.ndarray]] = []
    pos, need = start % total, count
    while need:
        shard = int(np.searchsorted(bounds, pos, side="right") - 1)
        local = pos - bounds[shard]
        n = min(need, sizes[shard] - local)
        if cache is not None and shard in cache:
            cols = cache[shard]
        else:
            cols = ds.shard_columns(shard, list(columns))
            if cache is not None:
                cache.clear()  # keep at most one shard resident
                cache[shard] = cols
        pieces.append({k: v[local:local + n] for k, v in cols.items()})
        pos = (pos + n) % total
        need -= n
    return _concat_columns(pieces)


def _model_wants_columns(model) -> bool:
    """Reference models take one tensor per feature column
    (model(*cols), torch/estimator.py:233-234); single-arg forwards get
    the feature matrix whole."""
    try:
        sig = inspect.signature(model.forward)
        n = len([
            p for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty
        ])
        return n > 1
    except (TypeError, ValueError):
        return False


def _accuracy(outputs, targets) -> torch.Tensor:
    """The reference's batch accuracy as a float32 scalar on the
    outputs' device, NaN where it is undefined (single-output
    regression), so the caller sums it without reading it back."""
    with torch.no_grad():
        if outputs.ndim > 1 and outputs.shape[-1] > 1:
            pred = outputs.argmax(-1)
            return (pred == targets.long().view(pred.shape)).float().mean()
        flat = outputs.view(-1)
        # Binary accuracy only for genuinely binary targets (values all
        # exactly 0/1, whatever the dtype). Integer targets over a wider
        # range with a single output head are (count/ordinal) regression.
        is_binary = ((targets == 0) | (targets == 1)).all()
        pred = (torch.sigmoid(flat) > 0.5).long()
        acc = (pred == targets.long().view(-1)).float().mean()
        return torch.where(is_binary, acc, torch.full_like(acc, np.nan))


class _RowIndex(torch.utils.data.Dataset):
    """Row indices ``0..n-1``, fetched a batch at a time as a list."""

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n

    def __getitems__(self, indices):
        return indices


def _as_index(indices):
    return indices


def _epoch_order(n: int, config: Dict[str, Any]):
    """One epoch's row order and batch sizes, drawn by a ``DataLoader``
    with the reference's ``batch_size``/``shuffle``/``drop_last``: its
    base seed and ``RandomSampler`` seed come from the global generator
    exactly as they do for the reference's ``TensorDataset`` loader, so
    the permutation is the reference's. Returns ``(order, sizes)``: a
    CPU int64 tensor and a list of batch lengths."""
    loader = torch.utils.data.DataLoader(
        _RowIndex(n),
        batch_size=config["batch_size"],
        shuffle=config["shuffle"],
        drop_last=config["drop_last"],
        collate_fn=_as_index,
    )
    batches = list(loader)
    order = torch.tensor([i for b in batches for i in b], dtype=torch.int64)
    return order, [len(b) for b in batches]


def _feature_matrix(shard, config) -> np.ndarray:
    feats = [shard[c] for c in config["feature_columns"]]
    return np.stack(feats, axis=1).astype(
        config.get("feature_dtype") or np.float32
    )


def _labels(shard, config) -> np.ndarray:
    return shard[config["label_column"]].astype(
        config.get("label_dtype") or np.float32
    )


def _train_on_shard(
    config: Dict[str, Any],
    shard: Dict[str, np.ndarray],
    eval_shard: Optional[Dict[str, np.ndarray]],
    rank: int,
    world_size: int,
    master_addr: str,
    master_port: int,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """One worker's whole fit on ``device``: build everything, train
    epochs, return rank-0 state_dict (CPU tensors) + history. Runs
    in-process (world=1) or inside an SPMD gang rank (world>1, gloo
    allreduce)."""
    dev = resolve_device(device)
    distributed = world_size > 1
    if distributed:
        torch.distributed.init_process_group(
            "gloo",
            init_method=f"tcp://{master_addr}:{master_port}",
            rank=rank,
            world_size=world_size,
        )
    try:
        torch.manual_seed(config["seed"] + rank)
        with startup.part("model"):
            model = _build_model(config["model"], config).to(dev)
        if distributed:
            model = torch.nn.parallel.DistributedDataParallel(
                model, device_ids=[dev] if dev.type == "cuda" else None)
        with startup.part("optimizer"):
            optimizer = _build_optimizer(config["optimizer"], model,
                                         config)
        criterion = _build_loss(config["loss"], config)
        scheduler = None
        if config.get("lr_scheduler_creator"):
            scheduler = config["lr_scheduler_creator"](optimizer, config)

        # The shard crosses to the device once a fit.
        x = torch.from_numpy(_feature_matrix(shard, config)).to(dev)
        y = torch.from_numpy(_labels(shard, config)).to(dev)
        raw_model = model.module if distributed else model
        columns_style = _model_wants_columns(raw_model)

        def forward(inputs):
            if columns_style:
                cols = [
                    inputs[:, i].unsqueeze(1) for i in range(inputs.size(1))
                ]
                return model(*cols)
            return model(inputs)

        history: List[Dict[str, float]] = []
        f64 = dict(dtype=torch.float64, device=dev)
        for epoch in range(config["num_epochs"]):
            model.train()
            order, sizes = _epoch_order(len(y), config)
            order = order.to(dev)
            # [loss sum, accuracy sum, batches with an accuracy]
            sums = torch.zeros(3, **f64)
            lo = 0
            for size in sizes:
                idx = order[lo:lo + size]
                lo += size
                inputs, targets = x[idx], y[idx]
                with startup.part("first_step", sync=(
                        torch.cuda.synchronize if dev.type == "cuda"
                        else None)):
                    outputs = forward(inputs)
                    if outputs.ndim == targets.ndim + 1 and \
                            outputs.shape[-1] == 1:
                        outputs = outputs.squeeze(-1)
                    loss = criterion(outputs, targets)
                    optimizer.zero_grad()
                    loss.backward()
                    optimizer.step()
                if scheduler is not None:
                    scheduler.step()
                a = _accuracy(outputs, targets).to(torch.float64)
                defined = ~torch.isnan(a)
                sums += torch.stack([
                    loss.detach().to(torch.float64),
                    torch.where(defined, a, torch.zeros_like(a)),
                    defined.to(torch.float64),
                ])
            # raydp: ignore[R5] -- one read an epoch, after its steps
            total, correct_sum, acc_batches = sums.tolist()
            metrics = {
                "epoch": epoch,
                "train_loss": total / max(1, len(sizes)),
            }
            if acc_batches:
                metrics["train_acc"] = correct_sum / acc_batches
            if eval_shard is not None:
                metrics.update(
                    _evaluate_shard(
                        raw_model, criterion, eval_shard, config,
                        columns_style,
                        distributed=distributed and config.get(
                            "_eval_distributed", False
                        ),
                        device=dev,
                    )
                )
            history.append(metrics)

        state = {
            k: v.detach().cpu().clone()
            for k, v in raw_model.state_dict().items()
        }
        return {"history": history, "state_dict": state if rank == 0 else None}
    finally:
        if distributed:
            torch.distributed.destroy_process_group()


def _evaluate_shard(model, criterion, shard, config, columns_style,
                    distributed: bool = False,
                    device: DeviceLike = "cuda") -> Dict[str, float]:
    """Evaluate this rank's eval rows on ``device``, in one forward.
    Distributed mode reduces weighted sums over the gang (every rank
    evaluates its own shard — the reference evaluates on one worker only;
    this is strictly better). The sums are read once."""
    dev = resolve_device(device)
    x = torch.from_numpy(_feature_matrix(shard, config)).to(dev)
    y = torch.from_numpy(_labels(shard, config)).to(dev)
    model.eval()
    n = float(len(y))
    with torch.no_grad():
        if n > 0:
            if columns_style:
                cols = [x[:, i].unsqueeze(1) for i in range(x.size(1))]
                out = model(*cols)
            else:
                out = model(x)
            if out.ndim == y.ndim + 1 and out.shape[-1] == 1:
                out = out.squeeze(-1)
            loss_sum = criterion(out, y).to(torch.float64) * n
            a = _accuracy(out, y).to(torch.float64)
        else:
            loss_sum = torch.zeros((), dtype=torch.float64, device=dev)
            a = torch.full((), np.nan, dtype=torch.float64, device=dev)
        defined = ~torch.isnan(a)
        zero = torch.zeros_like(a)
        sums = torch.stack([
            loss_sum,
            torch.where(defined, a * n, zero),
            torch.where(defined, zero + n, zero),
            zero + n,
        ])
        if distributed:
            torch.distributed.all_reduce(sums)
        loss_sum, acc_sum, acc_n, n = sums.tolist()
    metrics = {"eval_loss": loss_sum / max(1.0, n)}
    if acc_n > 0:
        metrics["eval_acc"] = acc_sum / acc_n
    return metrics


def _cpu_module(spec):
    """A model instance as it travels to gang ranks: a CPU copy (each
    rank moves it onto its own device); creators travel as they are."""
    if isinstance(spec, torch.nn.Module) and any(
            t.device.type != "cpu"
            for t in list(spec.parameters()) + list(spec.buffers())):
        return copy.deepcopy(spec).cpu()
    return spec


class TorchEstimator:
    """Reference-compatible constructor surface
    (reference: torch/estimator.py:60-150), plus ``device=``."""

    def __init__(
        self,
        num_workers: int = 1,
        model=None,
        optimizer=None,
        loss=None,
        lr_scheduler_creator: Optional[Callable] = None,
        feature_columns: Optional[List[str]] = None,
        feature_types=None,
        label_column: Optional[str] = None,
        label_type=None,
        batch_size: int = 64,
        num_epochs: int = 1,
        shuffle: bool = True,
        drop_last: bool = False,
        seed: int = 0,
        device: DeviceLike = "cuda",
        **extra_config,
    ):
        if model is None or loss is None:
            raise ValueError("model and loss must be provided")
        self.device = resolve_device(device)
        self.num_workers = max(1, num_workers)
        self.config: Dict[str, Any] = dict(
            model=model,
            optimizer=optimizer,
            loss=loss,
            lr_scheduler_creator=lr_scheduler_creator,
            feature_columns=feature_columns,
            feature_dtype=feature_types,
            label_column=label_column,
            label_dtype=label_type,
            batch_size=batch_size,
            num_epochs=num_epochs,
            shuffle=shuffle,
            drop_last=drop_last,
            seed=seed,
            **extra_config,
        )
        self.history: List[Dict[str, float]] = []
        self._trained_state: Optional[Dict[str, torch.Tensor]] = None

    # -- fitting --------------------------------------------------------
    def fit(
        self,
        train_ds: MLDataset,
        evaluate_ds: Optional[MLDataset] = None,
    ) -> List[Dict[str, float]]:
        cfg = self.config
        if not cfg["feature_columns"] or not cfg["label_column"]:
            raise ValueError("feature_columns and label_column are required")
        wanted = list(cfg["feature_columns"]) + [cfg["label_column"]]
        world = min(self.num_workers, train_ds.num_shards)
        # Equal samples per rank (reference invariant: divide_blocks gives
        # every rank exactly ceil(total/world) rows, wrapping to reuse early
        # rows — utils.py:149-222). Equality matters for DDP: ranks with
        # different batch counts desynchronize the gloo allreduce. Rows are
        # gathered shard-slice by shard-slice so the driver never holds a
        # second full copy of the dataset.
        if world == 1:
            total = train_ds.total_rows
            shard = _rows_range(train_ds, wanted, 0, total)
            eval_shard = (
                _all_rows(evaluate_ds, wanted)
                if evaluate_ds is not None else None
            )
            out = _train_on_shard(
                cfg, shard, eval_shard, 0, 1, "127.0.0.1", 0, self.device
            )
            self.history = out["history"]
            self._trained_state = out["state_dict"]
            return self.history

        store_spec = self._store_feed_spec(train_ds, evaluate_ds, world)
        if store_spec is None:
            # In-memory blocks / no session: the driver materializes each
            # rank's rows and scatters them through the gang RPC.
            total = train_ds.total_rows
            per = -(-total // world)
            shard_cache: Dict[int, Dict[str, np.ndarray]] = {}
            shards = [
                _rows_range(train_ds, wanted, r * per, per, cache=shard_cache)
                for r in range(world)
            ]
            eval_shard = (
                _all_rows(evaluate_ds, wanted)
                if evaluate_ds is not None else None
            )
            per_rank_args = [
                (shards[r], eval_shard if r == 0 else None)
                for r in range(world)
            ]
            work_cfg = dict(cfg)
        else:
            # Store feed (the default under a live session): only block
            # refs + slice plans travel; every rank mmaps/fetches its own
            # shard and evaluates its own eval slice (reduced over gloo).
            per_rank_args = [
                (store_spec["plans"][r],
                 store_spec["eval_plans"][r] if store_spec["eval_plans"]
                 else None,
                 store_spec["eval_true"][r] if store_spec["eval_true"]
                 else None)
                for r in range(world)
            ]
            ep = store_spec["eval_plans"]
            work_cfg = dict(
                cfg,
                # Gang-reduced eval only when EVERY rank holds an eval
                # shard (a lone rank calling all_reduce would deadlock).
                _eval_distributed=ep is not None
                and all(p is not None for p in ep),
            )
        work_cfg["model"] = _cpu_module(cfg["model"])
        # The config travels as bytes whose classes go by value: a user's
        # nn.Module class lives in a script the ranks do not import.
        blob = closure.dumps(work_cfg, classes=True)

        # Gang of processes: gloo allreduce (reference: Ray Train DDP
        # workers, torch/estimator.py:276-297; here the SPMD runner is the
        # process fabric). Each rank trains on its own device.
        from raydp_tpu_torch.spmd import create_spmd_job

        port = find_free_port()
        device = str(self.device)
        job = create_spmd_job(
            job_name="torch-estimator", world_size=world, timeout=60.0
        ).start()
        try:
            if store_spec is None:
                def work(ctx, shard, eval_shard, _blob=blob, _port=port):
                    return _train_on_shard(
                        closure.loads(_blob), shard, eval_shard,
                        ctx.rank, ctx.world_size, "127.0.0.1", _port,
                        ctx.device(device),
                    )
            else:
                master = store_spec["master"]
                namespace = store_spec["namespace"]
                blocks = store_spec["blocks"]
                eval_blocks = store_spec["eval_blocks"]

                def work(ctx, plan, eval_plan, eval_true,
                         _blob=blob, _port=port):
                    shard = _materialize_plan(
                        master, namespace, blocks, plan, wanted
                    )
                    eval_shard = None
                    if eval_plan is not None:
                        eval_shard = _materialize_plan(
                            master, namespace, eval_blocks, eval_plan,
                            wanted, true_rows=eval_true,
                        )
                    return _train_on_shard(
                        closure.loads(_blob), shard, eval_shard,
                        ctx.rank, ctx.world_size, "127.0.0.1", _port,
                        ctx.device(device),
                    )

            results = job.run(
                work, timeout=600.0, per_rank_args=per_rank_args
            )
        finally:
            job.stop()
        self.history = results[0]["history"]
        self._trained_state = results[0]["state_dict"]
        return self.history

    @staticmethod
    def _store_feed_spec(train_ds, evaluate_ds, world: int):
        """Build the ref+plan scatter spec, or None when the datasets are
        not fully object-store-backed (then the legacy driver scatter
        runs)."""
        from raydp_tpu_torch.context import current_session
        from raydp_tpu_torch.store.object_store import ObjectRef
        from raydp_tpu_torch.utils.sharding import BlockSlice, divide_blocks

        session = current_session()
        if session is None:
            return None
        if not all(isinstance(b, ObjectRef) for b in train_ds.blocks):
            return None
        if evaluate_ds is not None and not all(
            isinstance(b, ObjectRef) for b in evaluate_ds.blocks
        ):
            return None
        if len(train_ds.blocks) < world:
            return None
        plans = divide_blocks(train_ds.block_sizes, world)
        eval_plans = eval_true = None
        if evaluate_ds is not None:
            if len(evaluate_ds.blocks) >= world:
                ep = divide_blocks(evaluate_ds.block_sizes, world)
                eval_plans = [ep[r] for r in range(world)]
                padded = [
                    sum(s.num_samples for s in ep[r]) for r in range(world)
                ]
                eval_true = _clamp_to_true(padded, evaluate_ds.total_rows)
            else:
                # Too few eval blocks to split: rank 0 evaluates the whole
                # set (the reference's behavior), no gang reduce.
                full = [
                    BlockSlice(i, n, 0)
                    for i, n in enumerate(evaluate_ds.block_sizes)
                ]
                eval_plans = [full] + [None] * (world - 1)
                eval_true = [evaluate_ds.total_rows] + [None] * (world - 1)
        cluster = session.cluster
        master_addr = getattr(cluster, "master_address", None) or (
            cluster.master.address
        )
        return {
            "master": master_addr,
            "namespace": cluster.namespace,
            "blocks": list(train_ds.blocks),
            "eval_blocks": list(evaluate_ds.blocks) if evaluate_ds else [],
            "plans": [plans[r] for r in range(world)],
            "eval_plans": eval_plans,
            "eval_true": eval_true,
        }

    def fit_on_df(
        self,
        train_df,
        evaluate_df=None,
        num_shards: Optional[int] = None,
    ) -> List[Dict[str, float]]:
        """DataFrame → MLDataset → fit (reference: fit_on_spark,
        torch/estimator.py:300-313). Accepts the port's or pandas frames."""
        from raydp_tpu_torch.train.estimator import _ensure_df

        n = num_shards or self.num_workers
        train_ds = MLDataset.from_df(
            _ensure_df(train_df), num_shards=n,
            shuffle=self.config["shuffle"], shuffle_seed=self.config["seed"],
        )
        eval_ds = (
            MLDataset.from_df(_ensure_df(evaluate_df), num_shards=1)
            if evaluate_df is not None
            else None
        )
        return self.fit(train_ds, eval_ds)

    # -- inference / persistence ---------------------------------------
    def get_model(self):
        """The trained torch module on ``device`` (reference: get_model,
        torch/estimator.py:315-317)."""
        model = _build_model(self.config["model"], self.config)
        if self._trained_state is not None:
            model.load_state_dict(self._trained_state)
        return model.to(self.device)

    def evaluate(self, ds: MLDataset) -> Dict[str, float]:
        cfg = self.config
        wanted = list(cfg["feature_columns"]) + [cfg["label_column"]]
        shard = _all_rows(ds, wanted)
        model = self.get_model()
        criterion = _build_loss(cfg["loss"], cfg)
        return _evaluate_shard(
            model, criterion, shard, cfg, _model_wants_columns(model),
            device=self.device,
        )

    def predict(self, x) -> np.ndarray:
        """Inference on a host feature matrix through the trained module
        on ``device`` (API parity with the estimator's predict — the
        reference exposes only get_model() and leaves the loop to the
        user). Honors the model's column-style forward the same way the
        train loop does. bfloat16 outputs come back as float32."""
        cfg = self.config
        model = self.get_model()
        model.eval()
        xt = torch.from_numpy(
            np.asarray(x).astype(cfg.get("feature_dtype") or np.float32)
        ).to(self.device)
        with torch.no_grad():
            if _model_wants_columns(model):
                cols = [xt[:, i].unsqueeze(1) for i in range(xt.size(1))]
                out = model(*cols)
            else:
                out = model(xt)
        out = out.cpu()
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.numpy()

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(
            {"state_dict": self._trained_state, "history": self.history},
            path,
        )
        return path

    def restore(self, path: str) -> None:
        blob = torch.load(path, weights_only=False, map_location="cpu")
        self._trained_state = blob["state_dict"]
        self.history = blob.get("history", [])

    def shutdown(self) -> None:
        """Reference parity (torch/estimator.py:327-330); gangs are
        per-fit here, so nothing is left running."""
