"""A step function captured once into a CUDA graph and replayed.

The counterpart of one jitted XLA program dispatched once (the JAX
package's scan epoch, ``raydp_tpu/train/estimator.py:1003-1045``, and its
decode engine's jitted prefill and step, ``raydp_tpu/serve/decode.py``).
Eager PyTorch dispatches every op of a step from Python; a
:class:`CapturedStep` records the step's kernels once and then launches
them all with one ``CUDAGraph.replay``.

Life of a :class:`CapturedStep`:

1. ``warmup`` eager calls on a side stream (cuBLAS workspaces, an
   optimizer's lazily created state, the kernels' libraries). They are
   real calls: their results are returned and their effects kept.
2. The next call captures ``fn`` over static copies of its arguments,
   then replays. Capturing launches nothing, so the flash wrappers'
   launch counts taken while capturing are put back and added on every
   replay instead (``ops/flash_attention.py``, ``recording_launches``).
3. Every later call copies its arguments into the static buffers and
   replays.

What is baked in at capture, and how each is kept honest:

* Random draws from an explicit ``torch.Generator`` (the dropout
  generator) are registered with the graph, so each replay draws the
  next masks from the generator's current offset and advances it, as an
  eager call would. An unregistered generator would replay the captured
  masks on every step.
* An optimizer runs in its ``capturable`` mode (its step count and bias
  corrections on the device), or as it is where it keeps no state on the
  host (SGD: the warm-up steps create its momentum buffers, so the
  capture records the steady-state update); any other raises. A
  Python-float learning rate is a constant of the graph: a replay after
  a param group's ``lr`` changed raises.
* Gradients are set to None before capture, so the captured backward
  allocates them once from the graph's pool and every replay writes the
  same storage.

A capture is one compile (``utils/profiling.run_compile``: counted in
``compile/*`` and billed as ``compile_seconds``). A failure to capture
raises a ``CompileError`` chained to the cause, one to replay raises as
it is; nothing falls back to eager.
CUDA only: the CPU runs the same function eagerly (the callers decide).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from raydp_tpu_torch.ops.flash_attention import (
    count_replay,
    recording_launches,
)
from raydp_tpu_torch.utils.profiling import run_compile


# Optimizers without a capturable mode whose step keeps no state on the
# host (SGD: its momentum buffers are tensors beside the parameters,
# created by the first eager step), so they are captured as they are.
_NO_HOST_STATE = (torch.optim.SGD,)


def capture_refusal(optimizer: torch.optim.Optimizer) -> Optional[str]:
    """Why ``optimizer``'s step cannot be captured into a CUDA graph, or
    None where it can: it has a capturable mode (Adam, AdamW, RMSprop,
    ...) or keeps no state on the host (SGD)."""
    if ("capturable" in optimizer.defaults
            or isinstance(optimizer, _NO_HOST_STATE)):
        return None
    return (f"{type(optimizer).__name__} has no capturable mode and is not "
            "known to keep all its step state on the device (a step count "
            "on the host would be frozen into the graph)")


def make_capturable(optimizer: torch.optim.Optimizer) -> None:
    """Switch ``optimizer`` to its capturable mode where it has one,
    moving any step counts it already holds onto their parameters'
    device; leave one that keeps no host state as it is. Raises for any
    other (:func:`capture_refusal`)."""
    refusal = capture_refusal(optimizer)
    if refusal is not None:
        raise TypeError(f"{refusal}, so its step cannot be captured into a "
                        "CUDA graph; use epoch_mode='stream'")
    if "capturable" not in optimizer.defaults:
        return
    # Its warm-up steps run uncaptured on purpose: silence the warning
    # torch gives for a capturable optimizer stepping outside a capture.
    optimizer._warned_capturable_if_run_uncaptured = True
    for group in optimizer.param_groups:
        group["capturable"] = True
        for p in group["params"]:
            state = optimizer.state.get(p, {})
            step = state.get("step")
            if torch.is_tensor(step) and step.device != p.device:
                state["step"] = step.to(p.device)


class CapturedStep:
    """``fn(*args)`` on CUDA tensors as one CUDA graph (see the module
    docstring). ``args`` may hold None (passed through as is); the other
    arguments must keep their shape and dtype from call to call.

    ``optimizer``: made capturable now, before its first step
    (:func:`make_capturable`; it needs ``warmup`` of at least 1), and its
    learning rates checked before each replay. ``generators``: explicit
    generators ``fn`` draws from, registered with the graph. ``pool``: a
    ``torch.cuda.graph_pool_handle()`` shared with other graphs that are
    never replayed concurrently with this one.
    """

    def __init__(self, fn: Callable, *, warmup: int = 0,
                 optimizer: Optional[torch.optim.Optimizer] = None,
                 generators: Sequence[torch.Generator] = (),
                 pool=None):
        if optimizer is not None and warmup < 1:
            # A first step creates the optimizer's state; captured, every
            # replay would create it afresh.
            raise ValueError("a captured optimizer step needs at least one "
                             "eager warm-up call before capture")
        self._fn = fn
        self.warmup = warmup
        self.warmed = 0
        self._optimizer = optimizer
        self._generators = tuple(generators)
        self._pool = pool
        self._stream = torch.cuda.Stream()
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._static = None
        self._out = None
        self._lrs = None
        self._launches = None
        if optimizer is not None:
            make_capturable(optimizer)

    @property
    def captured(self) -> bool:
        return self._graph is not None

    def _warm_up(self, *args):
        """One eager call of ``fn`` on the side stream; returns its result."""
        main = torch.cuda.current_stream()
        self._stream.wait_stream(main)
        with torch.cuda.stream(self._stream):
            out = self._fn(*args)
        main.wait_stream(self._stream)
        self.warmed += 1
        return out

    def __call__(self, *args):
        """The next step: eager while warming up, else a replay (capturing
        first if this is the first). Returns ``fn``'s result; after capture
        that is the graph's static output, rewritten by each replay."""
        if self._graph is None:
            if self.warmed < self.warmup:
                return self._warm_up(*args)
            run_compile(self._capture, "cuda_graph_capture", args)
        self._replay(args)
        return self._out

    def _lr_values(self):
        return [g["lr"] for g in self._optimizer.param_groups]

    def _capture(self, args) -> None:
        self._static = tuple(None if a is None else a.clone() for a in args)
        if self._optimizer is not None:
            self._optimizer.zero_grad(set_to_none=True)
            self._lrs = self._lr_values()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators:
            graph.register_generator_state(gen)
        with recording_launches() as launched:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                self._out = self._fn(*self._static)
        self._launches = launched
        self._graph = graph

    def _replay(self, args) -> None:
        if self._optimizer is not None and self._lr_values() != self._lrs:
            raise RuntimeError(
                f"a param group's learning rate changed from {self._lrs} to "
                f"{self._lr_values()} after the step was captured into a "
                "CUDA graph, which holds the old value; set it before the "
                "fit or use epoch_mode='stream'")
        for static, a in zip(self._static, args):
            if static is None:
                continue
            if a.shape != static.shape or a.dtype != static.dtype:
                raise ValueError(
                    f"captured step takes {static.dtype} "
                    f"{tuple(static.shape)}, got {a.dtype} {tuple(a.shape)}")
            static.copy_(a)
        self._graph.replay()
        count_replay(self._launches)
