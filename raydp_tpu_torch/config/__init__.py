from raydp_tpu_torch.config.config import ClusterConfig, validate_config

__all__ = ["ClusterConfig", "validate_config"]
