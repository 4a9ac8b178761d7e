"""Model families of the port."""
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.dlrm import (
    DLRM,
    DLRMConfig,
    DotInteraction,
    PackedDLRM,
    ShardedEmbedding,
    criteo_dlrm,
    dlrm_shardings,
    tiny_dlrm,
)
from raydp_tpu_torch.models.dropout import Dropout, set_dropout_generator
from raydp_tpu_torch.models.mlp import (
    MLP,
    binary_classifier,
    taxi_fare_regressor,
)
from raydp_tpu_torch.models.moe import (
    MoEBlock,
    MoEClassifier,
    MoEConfig,
    MoELayer,
    moe_aux_loss,
    tiny_moe,
)
from raydp_tpu_torch.models.transformer import (
    CausalLM,
    MultiHeadAttention,
    SequenceClassifier,
    TransformerBlock,
    TransformerConfig,
    TransformerEncoder,
    bert_base,
    param_shardings,
    tiny_transformer,
)

from raydp_tpu_torch.models.pipelined import PipelinedClassifier

__all__ = [
    "CausalLM",
    "DLRM",
    "DLRMConfig",
    "DotInteraction",
    "Dropout",
    "MLP",
    "MoEBlock",
    "MoEClassifier",
    "MoEConfig",
    "MoELayer",
    "MultiHeadAttention",
    "PackedDLRM",
    "PipelinedClassifier",
    "SequenceClassifier",
    "ShardedEmbedding",
    "TransformerBlock",
    "TransformerConfig",
    "TransformerEncoder",
    "bert_base",
    "binary_classifier",
    "criteo_dlrm",
    "dlrm_shardings",
    "moe_aux_loss",
    "param_shardings",
    "params_from_flax",
    "set_dropout_generator",
    "taxi_fare_regressor",
    "tiny_dlrm",
    "tiny_moe",
    "tiny_transformer",
]
