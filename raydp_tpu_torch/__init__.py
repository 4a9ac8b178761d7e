"""raydp_tpu_torch: the PyTorch/CUDA port of raydp_tpu.

The JAX package ``raydp_tpu`` is the reference and stays unchanged; this
package imports nothing of it (nor of JAX) and keeps its own copies of
what it needs. This slice is transformer inference: the BERT-GLUE
classifier forward and the continuous-batching decode server, with
``attention_impl="flash"`` running a hand-written Hopper kernel.

Entry points take ``device=`` (default ``"cuda"``); without a card they
raise unless the caller passes ``device="cpu"``.
"""
from raydp_tpu_torch.models import (
    CausalLM,
    SequenceClassifier,
    TransformerConfig,
    bert_base,
    params_from_flax,
    tiny_transformer,
)
from raydp_tpu_torch.ops import (
    cached_decode_attention,
    flash_attention,
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
from raydp_tpu_torch.utils import metrics, resolve_device, set_exact_float32

__all__ = [
    "CausalLM",
    "DecodeConfig",
    "DecodeLoop",
    "PagedSlotPool",
    "SequenceClassifier",
    "ToyDecodeEngine",
    "TransformerConfig",
    "TransformerDecodeEngine",
    "bert_base",
    "build_transformer_engine",
    "cached_decode_attention",
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_plain",
    "metrics",
    "params_from_flax",
    "reference_attention",
    "reference_decode",
    "resolve_device",
    "set_exact_float32",
    "tiny_transformer",
]
