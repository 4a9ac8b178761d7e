"""Device-mesh specification (the port's copy of the ``MeshSpec``
dataclass of ``raydp_tpu/parallel/mesh.py``).

One ``MeshSpec`` names every parallelism axis:

  * ``dp`` — data parallel (batch dimension; gradients are all-reduced
    over it). In the port a data-parallel world is a gang of processes
    with one card each (``torch.distributed``), so ``dp`` counts the
    gang's processes.
  * ``pp``, ``sp``, ``tp`` — pipeline, sequence and tensor parallel.
    They wait for ROADMAP Queue A item 9 (DTensor meshes, ring and
    Ulysses attention, GPipe over P2P): a spec with any of them above 1
    raises ``NotImplementedError``.

The logical-axis rules are kept for the estimator's ``logical_rules``
argument; with a dp-only mesh they shard nothing, as in the JAX
package, whose rules name axes a dp-only mesh lacks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "sp", "tp")

# Logical dimension → mesh axis, as the JAX package's transformer maps
# them (``raydp_tpu/models/transformer.py:39-50``). None replicates.
DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("seq", "sp"),
    ("vocab", None),
    ("embed", None),
    ("heads", "tp"),
    ("kv", None),
    ("mlp", "tp"),
    ("pooled", None),
    ("stage", "pp"),
    ("expert", "dp"),
)


@dataclass(frozen=True)
class MeshSpec:
    """Named sizes for each parallelism axis; ``auto_from(n)`` puts
    ``n`` processes on one axis."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        for name in AXIS_ORDER:
            if getattr(self, name) < 1:
                raise ValueError(f"mesh axis {name} must be >= 1")
        wide = {a: getattr(self, a) for a in ("pp", "sp", "tp")
                if getattr(self, a) > 1}
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide}: pipeline, sequence and tensor "
                "parallelism are not ported yet (ROADMAP Queue A item 9); "
                "the port's meshes are data parallel only")

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    @staticmethod
    def auto_from(n_devices: int, prefer: str = "dp") -> "MeshSpec":
        """All devices on one axis (default data-parallel)."""
        return MeshSpec(**{prefer: n_devices})
