from raydp_tpu_torch.config.config import (
    ClusterConfig,
    DataConfig,
    TrainConfig,
    validate_config,
)

__all__ = ["ClusterConfig", "DataConfig", "TrainConfig", "validate_config"]
