"""Device-mesh specification (the port's ``raydp_tpu/parallel/mesh.py``).

One ``MeshSpec`` names every parallelism axis:

  * ``dp`` — data parallel (batch dimension; gradients are summed here)
  * ``pp`` — pipeline parallel (layer stages; microbatches ride a ring)
  * ``sp`` — sequence parallel (ring or Ulysses attention over this axis)
  * ``tp`` — tensor parallel (weight shards; activations all-reduced)

The JAX package runs one process over many devices and lays them out
with ``jax.sharding.Mesh``. The port keeps its own rule, one process per
mesh position: ``MeshSpec.size`` is the size of a ``torch.distributed``
world (a ``fit_spmd`` gang or an ``SPMDJob``), rank ``r`` sits where
``np.arange(size).reshape(dp, pp, sp, tp)`` puts it (as ``MeshSpec.build``
lays out devices in the JAX package, so tp peers are adjacent ranks), and
:meth:`MeshSpec.build` returns a :class:`Mesh`: this rank's coordinates
and one process group for every combination of axes wider than 1
(``dist.new_group``, created in the same order on every rank). A world
of one process needs no ``torch.distributed``: its mesh has no groups
and every collective over it is the identity.

Where JAX has a ``PartitionSpec``, the port has a tuple of axis names
(or ``None``) per dimension (:func:`logical_to_spec`), and where JAX has
a ``NamedSharding`` the port has a :class:`Placement`: that tuple on a
mesh, which cuts a full tensor into this rank's shard and gathers the
shards back (:func:`named_sharding`).
"""
from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "sp", "tp")

# Canonical logical-dimension → mesh-axis rules, the JAX package's
# (raydp_tpu/parallel/mesh.py:33-44). The transformer's own rules are
# ``raydp_tpu_torch.models.transformer.LOGICAL_RULES``.
DEFAULT_LOGICAL_RULES: Tuple[Tuple[str, Optional[str]], ...] = (
    ("batch", "dp"),
    ("sequence", "sp"),
    ("hidden", None),
    ("embed", None),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("expert", "dp"),
    ("stage", "pp"),
)


@dataclass(frozen=True)
class MeshSpec:
    """Named sizes for each parallelism axis.

    ``auto_from(n)`` puts ``n`` processes on one axis; :meth:`build`
    joins this process's place in an initialised world."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def __post_init__(self):
        for name in AXIS_ORDER:
            if getattr(self, name) < 1:
                raise ValueError(f"mesh axis {name} must be >= 1")

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.sp * self.tp

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return {name: getattr(self, name) for name in AXIS_ORDER}

    @property
    def data_parallel_only(self) -> bool:
        return self.pp == self.sp == self.tp == 1

    @staticmethod
    def auto_from(n_devices: int, prefer: str = "dp") -> "MeshSpec":
        """All devices on one axis (default data-parallel)."""
        return MeshSpec(**{prefer: n_devices})

    def coords_of(self, rank: int) -> Dict[str, int]:
        """Where ``rank`` sits: its index on every axis."""
        grid = np.arange(self.size).reshape(
            tuple(getattr(self, a) for a in AXIS_ORDER))
        where = np.argwhere(grid == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is outside mesh {self.axis_sizes}")
        return dict(zip(AXIS_ORDER, (int(i) for i in where[0])))

    def build(self) -> "Mesh":
        """This process's :class:`Mesh`. The world must be exactly
        ``size`` processes (one per mesh position); a size-1 mesh also
        builds without ``torch.distributed``. Collective over the world:
        every rank calls it, in the same order as any other group
        creation."""
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            rank, world = 0, 1
        if world != self.size:
            raise ValueError(
                f"mesh {self.axis_sizes} needs {self.size} processes (one "
                f"a mesh position) but the world has {world}")
        return Mesh(self, rank)


class Mesh:
    """One rank's view of a mesh: its coordinates and the process group
    of every combination of axes wider than 1 (:meth:`group`). ``shape``
    reads as a JAX mesh's does."""

    def __init__(self, spec: MeshSpec, rank: int):
        import torch.distributed as dist

        self.spec = spec
        self.rank = rank
        self.coords = spec.coords_of(rank)
        self.backend: Optional[str] = None
        self._groups: Dict[Tuple[str, ...], object] = {}
        self._members: Dict[Tuple[str, ...], Tuple[int, ...]] = {}
        if spec.size == 1:
            return
        self.backend = dist.get_backend()
        grid = np.arange(spec.size).reshape(
            tuple(getattr(spec, a) for a in AXIS_ORDER))
        wide = [a for a in AXIS_ORDER if getattr(spec, a) > 1]
        # Every rank creates every group, in one order: new_group is
        # collective over the whole world.
        for n in range(1, len(wide) + 1):
            for axes in combinations(wide, n):
                moved = np.moveaxis(
                    grid, [AXIS_ORDER.index(a) for a in axes],
                    range(4 - len(axes), 4))
                peers = moved.reshape(-1, int(np.prod(
                    [getattr(spec, a) for a in axes])))
                for row in peers:
                    members = tuple(int(r) for r in row)
                    if len(members) == spec.size:
                        group = dist.group.WORLD
                    else:
                        group = dist.new_group(list(members))
                    if rank in members:
                        self._groups[axes] = group
                        self._members[axes] = members

    @property
    def shape(self) -> Dict[str, int]:
        return self.spec.axis_sizes

    def group(self, *axes: str):
        """The process group of this rank's peers over ``axes`` (None
        where they span one rank: collectives over it are the
        identity)."""
        return self._groups.get(self._key(axes))

    def members(self, *axes: str) -> Tuple[int, ...]:
        """The global ranks of :meth:`group`, in group-rank order."""
        return self._members.get(self._key(axes), (self.rank,))

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in AXIS_ORDER if a in axes and self.shape[a] > 1)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank}, coords={self.coords})"


def _axis_sizes(mesh) -> Dict[str, int]:
    if mesh is None:
        return {}
    if isinstance(mesh, MeshSpec):
        return mesh.axis_sizes
    return dict(mesh.shape)


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Sequence[Tuple[str, Optional[str]]] = DEFAULT_LOGICAL_RULES,
    mesh=None,
) -> Tuple[Optional[str], ...]:
    """Map logical dimension names to mesh axis names via the rule table
    (the JAX package's ``PartitionSpec``, as a tuple).

    If ``mesh`` (a :class:`Mesh` or a :class:`MeshSpec`) is given, axes
    whose size is 1 are dropped. Trailing ``None`` entries are trimmed,
    as a ``PartitionSpec`` compares."""
    table = dict(rules)
    sizes = _axis_sizes(mesh)
    out = []
    for name in logical_axes:
        axis = table.get(name) if name is not None else None
        if axis is not None and mesh is not None and sizes.get(axis, 1) == 1:
            axis = None
        out.append(axis)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def factor_devices(n: int) -> MeshSpec:
    """Factor ``n`` devices into a (dp, pp, sp, tp) mesh exercising every
    axis that fits. Greedy: give tp and sp a factor of 2 first when
    available, pp next, rest to dp."""
    remaining = n
    sizes = {"tp": 1, "sp": 1, "pp": 1, "dp": 1}
    for axis in ("tp", "sp", "pp"):
        if remaining % 2 == 0 and remaining >= 2:
            sizes[axis] = 2
            remaining //= 2
    sizes["dp"] = remaining
    spec = MeshSpec(**sizes)
    assert spec.size == n
    return spec


@dataclass(frozen=True)
class Placement:
    """Where a tensor's shards live on a mesh: one mesh axis (or None)
    per dimension. Dimension ``d`` placed on axis ``a`` is cut into
    ``mesh.shape[a]`` equal blocks, and this rank holds block
    ``mesh.coords[a]``; every other axis replicates the tensor. With a
    ``view`` (the full tensor's shape regrouped, e.g. a fused q/k/v
    weight ``[3·H·D, E]`` seen as ``[3, H, D, E]``) the spec names the
    view's dimensions and the cut is taken there."""

    mesh: object
    spec: Tuple[Optional[str], ...]
    view: Optional[Tuple[int, ...]] = None

    @property
    def sharded_axes(self) -> Tuple[str, ...]:
        return tuple(a for a in self.spec if a is not None
                     and self.mesh.shape[a] > 1)

    @property
    def replicated_axes(self) -> Tuple[str, ...]:
        """Mesh axes wider than 1 over which every rank holds the same
        block."""
        return tuple(a for a in AXIS_ORDER if self.mesh.shape[a] > 1
                     and a not in self.spec)

    def _local(self, shape: Sequence[int]) -> Tuple[int, ...]:
        out = list(shape)
        for d, axis in enumerate(self.spec):
            if axis is not None:
                n = self.mesh.shape[axis]
                if out[d] % n:
                    raise ValueError(
                        f"dimension {d} of {tuple(shape)} does not divide "
                        f"over {axis}={n}")
                out[d] //= n
        return tuple(out)

    def shard(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's block of ``full`` (a contiguous copy where cut)."""
        if not self.sharded_axes:
            return full
        view = self.view or tuple(full.shape)
        groups = _view_groups(full.shape, view)
        out = full.reshape(view)
        for d, axis in enumerate(self.spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                out = out.chunk(self.mesh.shape[axis],
                                dim=d)[self.mesh.coords[axis]]
        return out.reshape(_regroup(out.shape, groups)).contiguous()

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The full tensor from every rank's block (collective over the
        sharded axes' groups: every rank of them calls it)."""
        from raydp_tpu_torch.parallel import collectives as C

        if not self.sharded_axes:
            return local
        view = self.view
        local_view = self._local(view) if view else tuple(local.shape)
        groups = _view_groups(local.shape, local_view)
        out = local.reshape(local_view)
        for d, axis in enumerate(self.spec):
            if axis is not None and self.mesh.shape[axis] > 1:
                out = C.all_gather_raw(out, d, self.mesh.group(axis))
        return out.reshape(_regroup(out.shape, groups))


def named_sharding(mesh, *spec: Optional[str]) -> Placement:
    """The port's ``NamedSharding``: a :class:`Placement` of ``spec`` on
    ``mesh``."""
    return Placement(mesh, tuple(spec))


def _view_groups(stored: Sequence[int], view: Sequence[int]) -> list:
    """How many consecutive ``view`` dimensions make each ``stored``
    dimension (their products match)."""
    groups, i = [], 0
    for size in stored:
        n, prod = 1, view[i] if i < len(view) else -1
        while prod < size and i + n < len(view):
            prod *= view[i + n]
            n += 1
        if prod != size:
            raise ValueError(f"view {tuple(view)} does not regroup into "
                             f"{tuple(stored)}")
        groups.append(n)
        i += n
    if i != len(view):
        raise ValueError(f"view {tuple(view)} does not regroup into "
                         f"{tuple(stored)}")
    return groups


def _regroup(shape: Sequence[int], groups: Sequence[int]) -> Tuple[int, ...]:
    out, i = [], 0
    for n in groups:
        out.append(int(np.prod(shape[i:i + n])))
        i += n
    return tuple(out)


def param_placements(module: "torch.nn.Module", mesh, rules
                     ) -> Dict[str, "Placement"]:
    """Each parameter's :class:`Placement` on ``mesh`` from the logical
    axes its module declares (``module.logical_axes``: parameter name →
    ``(logical axes, view)``, the axes naming the dimensions of ``view``,
    the full parameter's shape regrouped, or of the parameter itself
    where ``view`` is None), lowered through ``rules``. A parameter
    without axes is replicated, as a flax parameter without metadata."""
    out: Dict[str, Placement] = {}
    for mname, m in module.named_modules():
        table = getattr(m, "logical_axes", None) or {}
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            logical, view = table.get(pname, ((), None))
            spec = logical_to_spec(logical, rules, mesh)
            out[name] = Placement(mesh, spec, view)
    return out


def shard_module(module: "torch.nn.Module", mesh, rules
                 ) -> Dict[str, "Placement"]:
    """Cut every parameter of ``module`` (full, the same on every rank)
    to this rank's block of its placement, in place, and bind the mesh to
    every submodule that runs collectives (``bind_mesh``). Returns the
    placements, also kept as ``module.placements`` beside
    ``module.mesh``. Build the optimizer afterwards: the parameters'
    storage changes."""
    import torch

    placements = param_placements(module, mesh, rules)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if placements[name].sharded_axes:
                p.data = placements[name].shard(p.data)
    bind_mesh(module, mesh)
    module.placements = placements
    module.mesh = mesh
    return placements


def bind_mesh(module: "torch.nn.Module", mesh) -> None:
    """``bind_mesh`` on every submodule, depth first, skipping the trees
    marked ``mesh_opaque`` (a stacked template applied slice by slice)."""
    if getattr(module, "mesh_opaque", False):
        return
    if hasattr(module, "bind_mesh"):
        module.bind_mesh(mesh)
    for child in module.children():
        bind_mesh(child, mesh)


def gather_state_dict(module: "torch.nn.Module",
                      placements: Dict[str, "Placement"]
                      ) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded parameter gathered to
    its full shape (collective over the sharded axes: every rank calls
    it)."""
    state = module.state_dict()
    for name, pl in placements.items():
        if pl.sharded_axes and name in state:
            state[name] = pl.gather(state[name])
    return state
