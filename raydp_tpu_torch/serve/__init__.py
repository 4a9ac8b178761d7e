"""Serve plane: the continuous-batching decode loop and the replica-process
serving plane.

The counterpart of ``raydp_tpu/serve/``. A self-healing
:class:`ReplicaGroup` of replica processes sits behind a bounded
:class:`RequestQueue` with SLO-aware continuous batching, fronted by a
small HTTP server (:class:`ServeFrontend`: ``/predict``, ``/generate``,
``/serve/stats``). The invariant everything here defends: **every
accepted request gets exactly one reply**. Replica death mid-batch
requeues its un-replied requests onto a surviving replica; the
replied-flag dedup keeps delivery at-most-once; overload degrades to 429
with ``Retry-After``. In ``mode="decode"`` the replicas run a
:class:`DecodeLoop` and a killed replica's in-flight sequences re-enter
the queue as prefills, token-index dedup keeping streams at-most-once.
"""
from raydp_tpu_torch.serve.batching import (
    SERVE_BUCKETS_ENV,
    SERVE_MAX_BATCH_ENV,
    SERVE_MAX_QUEUE_ENV,
    SERVE_SLO_MS_ENV,
    SERVE_TIMEOUT_ENV,
    DecodeState,
    QueueFullError,
    RequestCancelled,
    RequestQueue,
    ServeRequest,
)
from raydp_tpu_torch.serve.decode import (
    DECODE_MAX_NEW_ENV,
    DECODE_PAGE_TOKENS_ENV,
    DECODE_PAGES_ENV,
    DECODE_ROUND_LINGER_ENV,
    DECODE_SLOTS_ENV,
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
from raydp_tpu_torch.serve.frontend import SERVE_PORT_ENV, ServeFrontend
from raydp_tpu_torch.serve.group import (
    SERVE_DISPATCH_TIMEOUT_ENV,
    SERVE_MAX_RESTARTS_ENV,
    SERVE_REPLICAS_ENV,
    SERVE_RESTART_BACKOFF_ENV,
    ReplicaGroup,
    ServeError,
)
from raydp_tpu_torch.serve.replica_main import default_model

__all__ = [
    "DECODE_MAX_NEW_ENV",
    "DECODE_PAGES_ENV",
    "DECODE_PAGE_TOKENS_ENV",
    "DECODE_ROUND_LINGER_ENV",
    "DECODE_SLOTS_ENV",
    "DecodeConfig",
    "DecodeLoop",
    "DecodeState",
    "PagedSlotPool",
    "QueueFullError",
    "ReplicaGroup",
    "RequestCancelled",
    "RequestQueue",
    "SERVE_BUCKETS_ENV",
    "SERVE_DISPATCH_TIMEOUT_ENV",
    "SERVE_MAX_BATCH_ENV",
    "SERVE_MAX_QUEUE_ENV",
    "SERVE_MAX_RESTARTS_ENV",
    "SERVE_PORT_ENV",
    "SERVE_REPLICAS_ENV",
    "SERVE_RESTART_BACKOFF_ENV",
    "SERVE_SLO_MS_ENV",
    "SERVE_TIMEOUT_ENV",
    "ServeError",
    "ServeFrontend",
    "ServeRequest",
    "ToyDecodeEngine",
    "TransformerDecodeEngine",
    "bucket_for",
    "build_transformer_engine",
    "default_model",
    "kv_buckets",
    "reference_decode",
]
