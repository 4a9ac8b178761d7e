"""Model families of the port."""
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.dropout import Dropout, set_dropout_generator
from raydp_tpu_torch.models.mlp import (
    MLP,
    binary_classifier,
    taxi_fare_regressor,
)
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
    "Dropout",
    "MLP",
    "MultiHeadAttention",
    "SequenceClassifier",
    "TransformerBlock",
    "TransformerConfig",
    "TransformerEncoder",
    "bert_base",
    "binary_classifier",
    "params_from_flax",
    "set_dropout_generator",
    "taxi_fare_regressor",
    "tiny_transformer",
]
