"""Attention ops: plain torch attention and the flash-attention kernel."""
from raydp_tpu_torch.ops.attention import (
    cached_decode_attention,
    reference_attention,
)
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_forward,
    flash_attention_plain,
)

__all__ = [
    "cached_decode_attention",
    "flash_attention",
    "flash_attention_forward",
    "flash_attention_plain",
    "reference_attention",
]
