"""Serve plane: the in-process continuous-batching decode server."""
from raydp_tpu_torch.serve.decode import (
    DecodeConfig,
    DecodeLoop,
    PagedSlotPool,
    ToyDecodeEngine,
    TransformerDecodeEngine,
    bucket_for,
    build_transformer_engine,
    kv_buckets,
    reference_decode,
)

__all__ = [
    "DecodeConfig",
    "DecodeLoop",
    "PagedSlotPool",
    "ToyDecodeEngine",
    "TransformerDecodeEngine",
    "bucket_for",
    "build_transformer_engine",
    "kv_buckets",
    "reference_decode",
]
