"""Pipeline parallelism: the GPipe schedule over the mesh's ``pp`` axis
(the port's ``raydp_tpu/parallel/pipeline.py``).

The JAX package runs the schedule as one XLA program under
``shard_map``; the port runs one process per mesh position, so each
``pp`` rank holds its stage's parameters and runs the same tick loop in
Python:

* at tick ``t`` stage 0 takes microbatch ``min(t, n-1)``, every other
  stage what the ring shift handed it last tick
  (:func:`~raydp_tpu_torch.parallel.collectives.ring_shift`, the
  ``lax.ppermute`` of ``(i, i+1 mod pp)``);
* only the last stage's valid ticks are written, and the output is
  summed over ``pp``
  (:func:`~raydp_tpu_torch.parallel.collectives.reduce_from_region`), so
  every pp rank holds it;
* the backward is autograd's through the shifts: each shift's backward
  is the reverse shift, so the gradients ride the ring back.

One difference: a stage skips the ticks whose input is a bubble (stage
``s`` works at ticks ``s .. s+n-1`` only) and passes the bubble on
unchanged; JAX computes them and never writes the result. The outputs
and gradients are the same, and each stage runs its ``stage_fn`` exactly
``n_microbatches`` times a pass. Every tensor that feeds nothing (what
stage 0 receives, each stage's last output) is tied into the output with
a zero weight, so every rank runs every shift's backward (a shift is a
send/recv pair: a rank that skipped one would leave its peer waiting).

Cost model: a GPipe schedule has bubble fraction
``(n_stages - 1) / (n_microbatches + n_stages - 1)``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence

import torch

from raydp_tpu_torch.parallel import collectives as C
from raydp_tpu_torch.parallel.mesh import AXIS_ORDER, Placement

__all__ = [
    "spmd_pipeline",
    "stack_stages",
    "unstack_stages",
    "stage_sharding",
    "microbatch",
    "pipeline_bubble_fraction",
]


def microbatch(x: torch.Tensor, n: int) -> torch.Tensor:
    """[B, ...] → [n, B/n, ...] (microbatch-major)."""
    if x.shape[0] % n != 0:
        raise ValueError(
            f"batch {x.shape[0]} not divisible by {n} microbatches")
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


def stack_stages(stage_params: Sequence[Dict[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """Stack per-stage parameter dicts along a new leading stage axis."""
    return {k: torch.stack([p[k] for p in stage_params])
            for k in stage_params[0]}


def unstack_stages(stacked: Dict[str, torch.Tensor],
                   n_stages: int) -> list:
    """Inverse of :func:`stack_stages`."""
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_stages)]


def stage_sharding(mesh, stacked_params: Dict[str, torch.Tensor],
                   axis: str = "pp",
                   inner_specs: Optional[Dict[str, tuple]] = None
                   ) -> Dict[str, Placement]:
    """Placements putting the leading stage axis on ``axis``: pp rank
    ``i`` holds stage ``i``. ``inner_specs`` optionally gives each
    unstacked parameter's spec (e.g. tp-cut kernels)."""
    return {k: Placement(mesh, (axis,) + tuple((inner_specs or {}).get(k)
                                               or ()))
            for k in stacked_params}


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """Idle fraction of the GPipe schedule."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def spmd_pipeline(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    mesh,
    n_microbatches: int,
    axis: str = "pp",
):
    """Build ``run(stacked_params, x) -> y`` running ``stage_fn`` as an
    ``n_stages``-deep pipeline over the ``axis`` ranks of ``mesh``.

    ``stage_fn(params_i, mb)`` applies stage ``i`` to one microbatch and
    must keep its shape and dtype. ``stacked_params`` holds each leaf
    with a leading stage axis: this rank's stage alone (length 1, as
    :func:`stage_sharding` places it) or every stage. ``x`` is this
    rank's batch ``[B, ...]`` (its dp rows); it is cut into
    ``n_microbatches`` microbatches. Every pp rank returns the whole
    output batch."""
    if axis not in AXIS_ORDER:
        raise ValueError(f"mesh has no axis {axis!r}")
    n_stages = mesh.shape[axis]
    stage = mesh.coords[axis]
    group = mesh.group(axis)
    n_mb = n_microbatches
    n_ticks = n_mb + n_stages - 1

    def local(stacked):
        def pick(v):
            if v.shape[0] == 1:
                return v[0]
            if v.shape[0] == n_stages:
                return v[stage]
            raise ValueError(f"stacked leaf with {v.shape[0]} stages on a "
                             f"{n_stages}-stage pipeline")
        return {k: pick(v) for k, v in stacked.items()}

    def run(stacked_params, x: torch.Tensor) -> torch.Tensor:
        params = local(stacked_params)
        xm = microbatch(x, n_mb)
        grad = torch.is_grad_enabled()
        state = xm[0] * 0
        outputs = [None] * n_mb
        unused = []
        for t in range(n_ticks):
            if stage == 0:
                if t:
                    unused.append(state)
                inp = xm[min(t, n_mb - 1)]
            else:
                inp = state
            # A bubble tick passes its input on unchanged.
            out = stage_fn(params, inp) if stage <= t < stage + n_mb else inp
            i_out = t - (n_stages - 1)
            if stage == n_stages - 1 and i_out >= 0:
                outputs[i_out] = out
            if t < n_ticks - 1:
                if grad and not out.requires_grad:
                    # Every rank records every shift (module docstring).
                    out = out.detach().requires_grad_()
                state = C.ring_shift(out, group)
        # The last tick's output is shifted to nobody.
        unused.append(out)
        if stage == n_stages - 1:
            y = torch.stack(outputs)
        else:
            y = torch.zeros_like(xm)
        y = C.reduce_from_region(y, group)
        if unused:
            y = y + sum(u.sum() for u in unused) * 0.0
        return y.reshape(x.shape[0], *y.shape[2:])

    return run
