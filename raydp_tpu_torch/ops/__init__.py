"""Attention ops: plain torch attention and the flash-attention kernels."""
from raydp_tpu_torch.ops.attention import (
    cached_decode_attention,
    reference_attention,
)
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_attention_plain,
    flash_bwd_delta,
    flash_bwd_dkv,
    flash_bwd_dq,
)

__all__ = [
    "cached_decode_attention",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_backward_plain",
    "flash_attention_forward",
    "flash_attention_plain",
    "flash_bwd_delta",
    "flash_bwd_dkv",
    "flash_bwd_dq",
    "reference_attention",
]
