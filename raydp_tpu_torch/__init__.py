"""raydp_tpu_torch: the PyTorch/CUDA port of raydp_tpu.

The JAX package ``raydp_tpu`` is the reference and stays unchanged; this
package imports nothing of it (nor of JAX) and keeps its own copies of
what it needs. Slice 1 is transformer inference: the BERT-GLUE
classifier forward and the continuous-batching decode server. Slice 2 is
training: the ``Estimator`` over a local ``MLDataset`` and its device
loader (its scan path replays the train step as a CUDA graph on a
card, as the decode engine does its prefill and step), losses, MLP
models, and the flash-attention backward. With
``attention_impl="flash"`` attention runs hand-written Hopper kernels,
forward and backward. Slice 5 is the other device workloads on one card:
DLRM (``models/dlrm.py``), the MoE classifier with the Switch aux loss
(``models/moe.py``, ``Estimator(aux_losses=True)``), block
rematerialisation (``TransformerConfig.remat``), gradient-boosted trees
(``train/gbt.py``) and the keras wire-format ``TFEstimator``
(``train/tf_estimator.py``). Slice 6 is the replica-process serve plane
(``serve/``: ``ReplicaGroup``, ``RequestQueue``, ``ServeFrontend``),
its standard-library RPC layer (``cluster/rpc.py``) and the serve fault
hooks (``fault/``): supervised replica processes on the card serving the
classifier in batches or the decode engine token by token. Slice 7 is
the ETL half in one process: the partitioned Arrow DataFrame engine on
its local executor (``dataframe/``), the native host kernels
(``native/``, g++-built at first use) and the handoff into training,
``fit_on_df`` of ``Estimator``, ``GBTEstimator`` and ``TFEstimator``.
Slice 8 is the session and its ETL worker cluster: ``init()`` starts
the AppMaster and worker processes (``cluster/``), partitions live in
the shared-memory object store (``store/``), the engine's stages ship to
the workers as closures (``cluster/closure.py``), and ``stop()`` tears
it down. Slice 9 is client mode and the SPMD gang runner:
``connect(address)`` attaches a second driver process to a live session
(``cluster/client.py``), ``spmd.create_spmd_job`` starts a gang of rank
processes that run shipped functions and join ``torch.distributed``
(``spmd/``), and ``MLDataset`` plans shards by node over object-store
blocks. Slice 10 completes the engine with window functions
(``dataframe/window.py``) and query profiling (``DataFrame.explain``,
``profile``, ``stage_stats``; ``telemetry/progress.py``), and trains
across the gang: ``train.fit_spmd`` runs an ``Estimator`` in each rank
over its own shard, gradients all-reduced (``parallel.MeshSpec``, data
parallel). Slice 15 is the user surface around them: the submit CLI
(``cli/submit.py``) and ``init``'s ``RAYDP_TPU_*`` handoff, the torch
compat estimator (``train.TorchEstimator``: a user's ``nn.Module`` on
the card, a gloo DDP gang over the object store), the host-side torch
dataset (``MLDataset.to_torch_dataset``), and the typed ``DataConfig``
and ``TrainConfig`` (``config/``).

The package imports its parts lazily (PEP 562): ``import
raydp_tpu_torch`` and the DataFrame engine load no torch, so an ETL
worker process stays light; a name below loads its module at first use.

Entry points that touch a device take ``device=`` (default ``"cuda"``);
without a card they raise unless the caller passes ``device="cpu"``.
"""
import importlib

__version__ = "0.1.0"

# Public name -> the module that defines it, imported at first use.
_EXPORTS = {
    "connect": "raydp_tpu_torch.context",
    "current_session": "raydp_tpu_torch.context",
    "init": "raydp_tpu_torch.context",
    "stop": "raydp_tpu_torch.context",
    "Window": "raydp_tpu_torch.dataframe",
    "WindowSpec": "raydp_tpu_torch.dataframe",
    "asc": "raydp_tpu_torch.dataframe",
    "desc": "raydp_tpu_torch.dataframe",
    "row_number": "raydp_tpu_torch.dataframe",
    "rank": "raydp_tpu_torch.dataframe",
    "dense_rank": "raydp_tpu_torch.dataframe",
    "lag": "raydp_tpu_torch.dataframe",
    "lead": "raydp_tpu_torch.dataframe",
    "window_sum": "raydp_tpu_torch.dataframe",
    "window_min": "raydp_tpu_torch.dataframe",
    "window_max": "raydp_tpu_torch.dataframe",
    "window_mean": "raydp_tpu_torch.dataframe",
    "window_count": "raydp_tpu_torch.dataframe",
    "MLDataset": "raydp_tpu_torch.data",
    "ShardLoader": "raydp_tpu_torch.data",
    "DLRM": "raydp_tpu_torch.models",
    "MLP": "raydp_tpu_torch.models",
    "CausalLM": "raydp_tpu_torch.models",
    "DLRMConfig": "raydp_tpu_torch.models",
    "MoEClassifier": "raydp_tpu_torch.models",
    "MoEConfig": "raydp_tpu_torch.models",
    "PackedDLRM": "raydp_tpu_torch.models",
    "SequenceClassifier": "raydp_tpu_torch.models",
    "TransformerConfig": "raydp_tpu_torch.models",
    "bert_base": "raydp_tpu_torch.models",
    "binary_classifier": "raydp_tpu_torch.models",
    "criteo_dlrm": "raydp_tpu_torch.models",
    "moe_aux_loss": "raydp_tpu_torch.models",
    "params_from_flax": "raydp_tpu_torch.models",
    "set_dropout_generator": "raydp_tpu_torch.models",
    "taxi_fare_regressor": "raydp_tpu_torch.models",
    "tiny_dlrm": "raydp_tpu_torch.models",
    "tiny_moe": "raydp_tpu_torch.models",
    "tiny_transformer": "raydp_tpu_torch.models",
    "cached_decode_attention": "raydp_tpu_torch.ops",
    "flash_attention": "raydp_tpu_torch.ops",
    "flash_attention_backward": "raydp_tpu_torch.ops",
    "flash_attention_backward_plain": "raydp_tpu_torch.ops",
    "flash_attention_forward": "raydp_tpu_torch.ops",
    "flash_attention_plain": "raydp_tpu_torch.ops",
    "reference_attention": "raydp_tpu_torch.ops",
    "DecodeConfig": "raydp_tpu_torch.serve",
    "DecodeLoop": "raydp_tpu_torch.serve",
    "PagedSlotPool": "raydp_tpu_torch.serve",
    "ReplicaGroup": "raydp_tpu_torch.serve",
    "RequestQueue": "raydp_tpu_torch.serve",
    "ServeFrontend": "raydp_tpu_torch.serve",
    "ToyDecodeEngine": "raydp_tpu_torch.serve",
    "TransformerDecodeEngine": "raydp_tpu_torch.serve",
    "build_transformer_engine": "raydp_tpu_torch.serve",
    "reference_decode": "raydp_tpu_torch.serve",
    "Estimator": "raydp_tpu_torch.train",
    "GBTEstimator": "raydp_tpu_torch.train",
    "TFEstimator": "raydp_tpu_torch.train",
    "TorchEstimator": "raydp_tpu_torch.train",
    "TrainingCallback": "raydp_tpu_torch.train",
    "fit_spmd": "raydp_tpu_torch.train",
    "MeshSpec": "raydp_tpu_torch.parallel",
    "metrics": "raydp_tpu_torch.utils",
    "resolve_device": "raydp_tpu_torch.utils",
    "set_exact_float32": "raydp_tpu_torch.utils",
}
_SUBPACKAGES = ("cluster", "config", "context", "data", "dataframe",
                "fault", "models", "native", "ops", "parallel", "serve",
                "spmd", "store", "telemetry", "train", "utils")

__all__ = ["__version__", *sorted(_EXPORTS)]


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is not None:
        value = getattr(importlib.import_module(module), name)
    elif name in _SUBPACKAGES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS) | set(_SUBPACKAGES))
