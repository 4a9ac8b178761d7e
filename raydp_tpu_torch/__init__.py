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
forward and backward.

Entry points take ``device=`` (default ``"cuda"``); without a card they
raise unless the caller passes ``device="cpu"``.
"""
from raydp_tpu_torch.data import MLDataset, ShardLoader
from raydp_tpu_torch.models import (
    MLP,
    CausalLM,
    SequenceClassifier,
    TransformerConfig,
    bert_base,
    binary_classifier,
    params_from_flax,
    set_dropout_generator,
    taxi_fare_regressor,
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
    ToyDecodeEngine,
    TransformerDecodeEngine,
    build_transformer_engine,
    reference_decode,
)
from raydp_tpu_torch.train import Estimator, TrainingCallback
from raydp_tpu_torch.utils import metrics, resolve_device, set_exact_float32

__all__ = [
    "CausalLM",
    "DecodeConfig",
    "DecodeLoop",
    "Estimator",
    "MLDataset",
    "MLP",
    "PagedSlotPool",
    "SequenceClassifier",
    "ShardLoader",
    "ToyDecodeEngine",
    "TransformerConfig",
    "TrainingCallback",
    "TransformerDecodeEngine",
    "bert_base",
    "binary_classifier",
    "build_transformer_engine",
    "cached_decode_attention",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_plain",
    "flash_attention_forward",
    "flash_attention_plain",
    "metrics",
    "params_from_flax",
    "reference_attention",
    "reference_decode",
    "resolve_device",
    "set_dropout_generator",
    "set_exact_float32",
    "taxi_fare_regressor",
    "tiny_transformer",
]
