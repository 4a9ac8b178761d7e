"""Model families of the port."""
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.transformer import (
    CausalLM,
    MultiHeadAttention,
    SequenceClassifier,
    TransformerBlock,
    TransformerConfig,
    TransformerEncoder,
    bert_base,
    tiny_transformer,
)

__all__ = [
    "CausalLM",
    "MultiHeadAttention",
    "SequenceClassifier",
    "TransformerBlock",
    "TransformerConfig",
    "TransformerEncoder",
    "bert_base",
    "params_from_flax",
    "tiny_transformer",
]
