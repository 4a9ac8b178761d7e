"""Parallelism: the ``MeshSpec`` of dp/pp/sp/tp, the port's mesh (one
process per position), its collectives and the GPipe pipeline. The mesh
module imports no torch (a worker that reads a ``MeshSpec`` from a
config stays torch-free); the pipeline's names load on first use."""
from raydp_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    DEFAULT_LOGICAL_RULES,
    Mesh,
    MeshSpec,
    Placement,
    factor_devices,
    logical_to_spec,
    named_sharding,
)

_PIPELINE = ("pipeline_bubble_fraction", "spmd_pipeline", "stack_stages",
             "stage_sharding", "unstack_stages")


def __getattr__(name):
    if name in _PIPELINE:
        from raydp_tpu_torch.parallel import pipeline

        return getattr(pipeline, name)
    raise AttributeError(name)


__all__ = [
    "AXIS_ORDER",
    "DEFAULT_LOGICAL_RULES",
    "Mesh",
    "MeshSpec",
    "Placement",
    "factor_devices",
    "logical_to_spec",
    "named_sharding",
    "pipeline_bubble_fraction",
    "spmd_pipeline",
    "stack_stages",
    "stage_sharding",
    "unstack_stages",
]
