"""Carry the JAX package's flax parameters into the port's modules.

``params_from_flax`` takes the flax ``params`` tree of a
``SequenceClassifier``, ``CausalLM``, ``MLP``, ``MoEClassifier``,
``DLRM``/``PackedDLRM`` or ``KerasSequential`` (from ``raydp_tpu``) with
its leaves already turned into numpy arrays, and returns a ``state_dict``
for the port's module of the same name. It imports no JAX.

* Dense kernel ``[in, out]`` → Linear weight ``[out, in]``.
* qkv DenseGeneral kernel ``[E, 3, H, D]`` / bias ``[3, H, D]`` → Linear
  ``[3·H·D, E]`` / ``[3·H·D]`` (row order q, k, v, then head, then dim).
* out DenseGeneral kernel ``[H, D, E]`` → Linear ``[E, H·D]``.
* Embed ``embedding`` → ``weight``; LayerNorm ``scale`` → ``weight``.
* ``block_<i>`` → ``blocks.<i>``; an auto-named ``Dense_<i>`` (the MLP's,
  a keras layer's without a name) → ``layers.<i>``; DLRM's ``bottom_<i>``,
  ``top_<i>`` and ``emb_<t>`` → ``bottom.<i>``, ``top.<i>``, ``emb.<t>``;
  a named keras layer keeps its name.
* Parameters that are tensors of their own, not a layer's kernel, keep
  their layout and name: the MoE's ``pos`` table and stacked expert
  weights (``w_up`` ``[E, D, F]``, ``b_up``, ``w_down``, ``b_down``) and
  DLRM's embedding ``table``. Any other leaf name raises.
* The ``stages`` subtree of a ``PipelinedClassifier`` holds each block
  leaf stacked on a leading stage axis: each stage's slice converts as a
  block's leaf and the slices stack again (``stages.attn.qkv.weight``
  ``[n_stages, 3·H·D, E]``).

With ``mesh=`` (a :class:`~raydp_tpu_torch.parallel.MeshSpec` or a built
mesh) and ``coords=`` (the rank's place, a built mesh's own by default)
each parameter is cut to that rank's block, by the logical axes its
module declares (the transformer family's ``layer_axes``, a leading
``stage`` axis for ``stages``; the MoE layer's stacked experts and
router; DLRM's tables, MLP layers and logit) lowered through ``rules``
(the transformer's ``LOGICAL_RULES`` by default; DLRM's tables cut under
``models/dlrm.LOGICAL_RULES``); :func:`gather_shards` is the inverse,
from every rank's blocks.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from raydp_tpu_torch.models import dlrm, moe
from raydp_tpu_torch.models.transformer import (
    LOGICAL_RULES,
    TransformerConfig,
    layer_axes,
)
from raydp_tpu_torch.parallel.mesh import (
    MeshSpec,
    Placement,
    logical_to_spec,
)


def _flatten(tree: Mapping[str, Any], prefix=()) -> Dict[tuple, np.ndarray]:
    out: Dict[tuple, np.ndarray] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flatten(val, prefix + (key,)))
        else:
            out[prefix + (key,)] = np.asarray(val)
    return out


# Parameters kept as they are, under their own name.
_TENSOR_LEAVES = ("pos", "w_up", "b_up", "w_down", "b_down", "table")


def _convert(path: tuple, arr: np.ndarray,
             cfg: Optional[TransformerConfig]) -> np.ndarray:
    if path[-1] in _TENSOR_LEAVES:
        return arr
    module, leaf = path[-2], path[-1]
    if leaf == "kernel":
        if module == "qkv" and arr.ndim == 4:
            want = (cfg.d_model, 3, cfg.n_heads, cfg.head_dim)
            if arr.shape != want:
                raise ValueError(f"{'/'.join(path)}: {arr.shape} != {want}")
            return arr.reshape(arr.shape[0], -1).T
        if module == "out" and arr.ndim == 3:
            want = (cfg.n_heads, cfg.head_dim, cfg.d_model)
            if arr.shape != want:
                raise ValueError(f"{'/'.join(path)}: {arr.shape} != {want}")
            return arr.reshape(-1, arr.shape[-1]).T
        return arr.T
    if leaf == "bias":
        return arr.reshape(-1)
    return arr


_LEAF_NAMES = {"kernel": "weight", "embedding": "weight", "scale": "weight",
               "bias": "bias"}
# flax module-name prefix → the port's ModuleList attribute.
_LISTS = {"block_": "blocks", "Dense_": "layers", "bottom_": "bottom",
          "top_": "top", "emb_": "emb"}


def _torch_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        prefix = next((k for k in _LISTS if p.startswith(k)
                       and p[len(k):].isdigit()), None)
        if prefix is None:
            parts.append(p)
        else:
            parts += [_LISTS[prefix], p[len(prefix):]]
    leaf = path[-1]
    if leaf in _TENSOR_LEAVES:
        parts.append(leaf)
    elif leaf in _LEAF_NAMES:
        parts.append(_LEAF_NAMES[leaf])
    else:
        raise ValueError(f"no port parameter for flax leaf {'/'.join(path)}")
    return ".".join(parts)


def _convert_leaf(path: tuple, arr: np.ndarray,
                  cfg: Optional[TransformerConfig]) -> np.ndarray:
    if path[0] == "stages":
        return np.stack([_convert(path[1:], a, cfg) for a in arr])
    return _convert(path, arr, cfg)


def _port_name(path: tuple) -> str:
    if path[0] == "stages":
        return "stages." + _torch_name(path[1:])
    return _torch_name(path)


class _Position:
    """A place on a mesh without its process groups: enough to cut."""

    def __init__(self, spec: MeshSpec, coords: Mapping[str, int]):
        self.shape = spec.axis_sizes
        self.coords = dict(coords)


def _declared_axes(name: str, cfg: Optional[TransformerConfig]):
    """The logical axes and view the port's module declares for the
    parameter ``name`` (no axes: replicated)."""
    parts = name.split(".")
    leaf = parts[-1]
    layer = parts[-2] if len(parts) >= 2 else ""
    if leaf in moe.LOGICAL_AXES:
        return moe.LOGICAL_AXES[leaf]
    if layer == "router":
        return moe.ROUTER_AXES[leaf]
    if leaf in dlrm.TABLE_AXES:
        return dlrm.TABLE_AXES[leaf]
    if len(parts) >= 3 and parts[-3] in ("bottom", "top") \
            and parts[0] in ("dlrm", "bottom", "top"):
        return dlrm.MLP_AXES[leaf]
    if layer == "logit":
        return dlrm.LOGIT_AXES.get(leaf, ((), None))
    if cfg is None:
        return (), None
    return layer_axes(cfg).get(layer, {}).get(leaf, ((), None))


def placement_of(name: str, cfg: Optional[TransformerConfig], mesh,
                 rules=LOGICAL_RULES) -> Placement:
    """The placement of the port parameter ``name`` on ``mesh``
    (replicated where its module declares no axes)."""
    stacked = name.split(".")[0] == "stages"
    logical, view = _declared_axes(name, cfg)
    if stacked:
        # The JAX package boxes stacked leaves ("stage", None, ...).
        logical, view = ("stage",), None
    return Placement(mesh, logical_to_spec(logical, rules, mesh), view)


def _position(mesh, coords) -> Any:
    if isinstance(mesh, MeshSpec):
        if coords is None:
            raise ValueError("a MeshSpec needs the rank's coords")
        return _Position(mesh, coords)
    return mesh if coords is None else _Position(mesh.spec, coords)


def params_from_flax(tree: Mapping[str, Any],
                     cfg: Optional[TransformerConfig] = None, *,
                     mesh=None, coords: Optional[Mapping[str, int]] = None,
                     rules=LOGICAL_RULES) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's module from a flax params tree of
    numpy arrays (unboxed, without the outer ``{"params": ...}``).
    ``cfg`` is the transformer's config; an MLP needs none. With
    ``mesh`` each parameter is this rank's block (the module
    docstring)."""
    state = {
        _port_name(path): torch.from_numpy(
            np.array(_convert_leaf(path, arr, cfg), order="C")
        )
        for path, arr in _flatten(tree).items()
    }
    if mesh is None:
        return state
    pos = _position(mesh, coords)
    return {name: placement_of(name, cfg, pos, rules).shard(t)
            for name, t in state.items()}


def gather_shards(shards: Sequence[Mapping[str, torch.Tensor]],
                  cfg: Optional[TransformerConfig], spec: MeshSpec,
                  rules=LOGICAL_RULES) -> Dict[str, torch.Tensor]:
    """The full ``state_dict`` from every rank's blocks (``shards[r]`` is
    rank ``r``'s), the inverse of ``params_from_flax(..., mesh=)``."""
    out: Dict[str, torch.Tensor] = {}
    shards = [{k: torch.as_tensor(v) for k, v in st.items()} for st in shards]
    for name in shards[0]:
        pl = placement_of(name, cfg, _Position(spec, spec.coords_of(0)),
                          rules)
        axes = pl.sharded_axes
        if not axes:
            out[name] = shards[0][name]
            continue
        # Rank r's block sits at its coords on the sharded axes: lay the
        # blocks out on a grid of those axes and concatenate.
        view = pl.view or tuple(np.multiply(
            shards[0][name].shape,
            [spec.axis_sizes[a] if a else 1 for a in pl.spec]
            + [1] * (shards[0][name].dim() - len(pl.spec))))
        local_view = pl._local(view)
        blocks = {}
        for r, st in enumerate(shards):
            c = spec.coords_of(r)
            blocks.setdefault(tuple(c[a] for a in axes),
                              st[name].reshape(local_view))
        full = _concat_grid(blocks, axes, pl.spec, spec)
        out[name] = full.reshape(_stored_shape(shards[0][name].shape,
                                               local_view, view))
    return out


def _concat_grid(blocks, axes, placement_spec, spec):
    """Concatenate blocks keyed by their indices on ``axes`` along the
    dimensions the placement puts those axes on."""
    def build(prefix):
        depth = len(prefix)
        if depth == len(axes):
            return blocks[prefix]
        axis = axes[depth]
        dim = placement_spec.index(axis)
        return torch.cat([build(prefix + (i,))
                          for i in range(spec.axis_sizes[axis])], dim=dim)
    return build(())


def _stored_shape(local_stored, local_view, view):
    from raydp_tpu_torch.parallel.mesh import _regroup, _view_groups

    return _regroup(view, _view_groups(local_stored, local_view))
