"""Carry the JAX package's flax parameters into the port's modules.

``params_from_flax`` takes the flax ``params`` tree of a
``SequenceClassifier`` or ``CausalLM`` (from ``raydp_tpu``) with its
leaves already turned into numpy arrays, and returns a ``state_dict`` for
the port's module of the same name. It imports no JAX.

* Dense kernel ``[in, out]`` → Linear weight ``[out, in]``.
* qkv DenseGeneral kernel ``[E, 3, H, D]`` / bias ``[3, H, D]`` → Linear
  ``[3·H·D, E]`` / ``[3·H·D]`` (row order q, k, v, then head, then dim).
* out DenseGeneral kernel ``[H, D, E]`` → Linear ``[E, H·D]``.
* Embed ``embedding`` → ``weight``; LayerNorm ``scale`` → ``weight``.
* ``block_<i>`` → ``blocks.<i>``.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

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


def _convert(path: tuple, arr: np.ndarray,
             cfg: TransformerConfig) -> np.ndarray:
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


def _torch_name(path: tuple) -> str:
    parts = []
    for p in path[:-1]:
        if p.startswith("block_"):
            parts += ["blocks", p[len("block_"):]]
        else:
            parts.append(p)
    parts.append(_LEAF_NAMES[path[-1]])
    return ".".join(parts)


def params_from_flax(tree: Mapping[str, Any],
                     cfg: TransformerConfig) -> Dict[str, torch.Tensor]:
    """A ``state_dict`` for the port's module from a flax params tree of
    numpy arrays (unboxed, without the outer ``{"params": ...}``)."""
    return {
        _torch_name(path): torch.from_numpy(
            np.array(_convert(path, arr, cfg), order="C")
        )
        for path, arr in _flatten(tree).items()
    }
