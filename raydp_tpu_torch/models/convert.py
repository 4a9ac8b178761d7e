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
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from raydp_tpu_torch.models.transformer import TransformerConfig


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
        if module == "qkv":
            want = (cfg.d_model, 3, cfg.n_heads, cfg.head_dim)
            if arr.shape != want:
                raise ValueError(f"{'/'.join(path)}: {arr.shape} != {want}")
            return arr.reshape(arr.shape[0], -1).T
        if module == "out":
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


def params_from_flax(tree: Mapping[str, Any],
                     cfg: Optional[TransformerConfig] = None
                     ) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's module from a flax params tree of
    numpy arrays (unboxed, without the outer ``{"params": ...}``).
    ``cfg`` is the transformer's config; an MLP needs none."""
    return {
        _torch_name(path): torch.from_numpy(
            np.array(_convert(path, arr, cfg), order="C")
        )
        for path, arr in _flatten(tree).items()
    }
