"""Data plane: the local sharded dataset and its device loader."""
from raydp_tpu_torch.data.loader import ShardLoader
from raydp_tpu_torch.data.ml_dataset import MLDataset

__all__ = ["MLDataset", "ShardLoader"]
