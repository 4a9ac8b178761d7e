"""Parallelism specification: the data-parallel ``MeshSpec``."""
from raydp_tpu_torch.parallel.mesh import AXIS_ORDER, DEFAULT_LOGICAL_RULES, MeshSpec

__all__ = ["AXIS_ORDER", "DEFAULT_LOGICAL_RULES", "MeshSpec"]
