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

Entry points take ``device=`` (default ``"cuda"``); without a card they
raise unless the caller passes ``device="cpu"``.
"""
from raydp_tpu_torch.data import MLDataset, ShardLoader
from raydp_tpu_torch.models import (
    DLRM,
    MLP,
    CausalLM,
    DLRMConfig,
    MoEClassifier,
    MoEConfig,
    PackedDLRM,
    SequenceClassifier,
    TransformerConfig,
    bert_base,
    binary_classifier,
    criteo_dlrm,
    moe_aux_loss,
    params_from_flax,
    set_dropout_generator,
    taxi_fare_regressor,
    tiny_dlrm,
    tiny_moe,
    tiny_transformer,
)
from raydp_tpu_torch.ops import (
    cached_decode_attention,
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_plain,
    reference_attention,
)
from raydp_tpu_torch.serve import (
    DecodeConfig,
    DecodeLoop,
    PagedSlotPool,
    ReplicaGroup,
    RequestQueue,
    ServeFrontend,
    ToyDecodeEngine,
    TransformerDecodeEngine,
    build_transformer_engine,
    reference_decode,
)
from raydp_tpu_torch.train import (
    Estimator,
    GBTEstimator,
    TFEstimator,
    TrainingCallback,
)
from raydp_tpu_torch.utils import metrics, resolve_device, set_exact_float32

__all__ = [
    "CausalLM",
    "DLRM",
    "DLRMConfig",
    "DecodeConfig",
    "DecodeLoop",
    "Estimator",
    "GBTEstimator",
    "MLDataset",
    "MLP",
    "MoEClassifier",
    "MoEConfig",
    "PackedDLRM",
    "PagedSlotPool",
    "ReplicaGroup",
    "RequestQueue",
    "SequenceClassifier",
    "ServeFrontend",
    "ShardLoader",
    "TFEstimator",
    "ToyDecodeEngine",
    "TransformerConfig",
    "TrainingCallback",
    "TransformerDecodeEngine",
    "bert_base",
    "binary_classifier",
    "build_transformer_engine",
    "cached_decode_attention",
    "criteo_dlrm",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_plain",
    "flash_attention_forward",
    "flash_attention_plain",
    "metrics",
    "moe_aux_loss",
    "params_from_flax",
    "reference_attention",
    "reference_decode",
    "resolve_device",
    "set_dropout_generator",
    "set_exact_float32",
    "taxi_fare_regressor",
    "tiny_dlrm",
    "tiny_moe",
    "tiny_transformer",
]
