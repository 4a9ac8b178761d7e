"""Collectives over a mesh's process groups: the port's counterpart of
the XLA collectives that ``shard_map`` code calls in the JAX package
(``lax.psum``, ``lax.all_gather``, ``lax.all_to_all``, ``lax.ppermute``).

**Routes.** A mesh on one card puts several ranks on one device, and NCCL
refuses that, so such a gang runs gloo
(:func:`~raydp_tpu_torch.spmd.worker_main.collective_backend`). Gloo takes
CUDA tensors for ``all_reduce`` and ``broadcast`` only: every other op on
a CUDA tensor under gloo (send/recv, all_gather, all_to_all) is staged
through pinned host buffers here, in one place, and its bytes are counted
(:func:`stats`). Under NCCL every op goes direct. Any other pairing of
backend and device (NCCL with a CPU tensor, another backend) raises,
naming the op, the backend and the device: nothing falls back.

**Autograd.** Each op that model code calls is a
``torch.autograd.Function`` whose backward is the op's transpose:

* :func:`copy_to_region` — identity forward, all_reduce backward
  (Megatron's ``f``: the input of a column-parallel layer);
* :func:`reduce_from_region` — all_reduce forward, identity backward
  (Megatron's ``g``: the output of a row-parallel layer);
* :func:`all_gather` — gathers blocks along a dimension; backward
  all-reduces the gradient and keeps this rank's block (the
  reduce-scatter; gloo has none). That is the transpose where each
  rank's copy of the gathered tensor feeds its own part of the loss (a
  rank's queries against gathered keys); where the peers compute the
  same loss from it, one of them seeds it (the estimator's gradient
  rule);
* :func:`reduce_scatter` — sums over the group and keeps this rank's
  block along a dimension (``lax.psum_scatter``); backward is the
  all_gather. Gloo has no reduce-scatter: it runs as one all_to_all of
  the blocks and a local float32 sum (on a card, staged: the tensor to
  the host, the summed block back, ``(1 + 1/n)`` times its bytes);
* :func:`gather_from_region` — all_gather forward, this rank's block of
  the gradient backward (Megatron's gather of a column-parallel layer's
  output, which every peer then uses whole: each computes the same
  gradient of it);
* :func:`all_to_all` — JAX's tiled ``all_to_all``; backward is the
  inverse all_to_all;
* :func:`ring_shift` — ``lax.ppermute`` of ``(i, i+offset mod n)``;
  backward is the reverse shift.

A group of ``None`` spans one rank: every op over it is the identity.
Every rank of a group must call its ops in the same order; model code
that builds the same graph on every rank does, forward and backward.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch
import torch.distributed as dist

# Ops gloo runs on CUDA tensors itself; the rest are staged.
_GLOO_CUDA_DIRECT = ("all_reduce", "broadcast")

_stats: Dict[str, float] = {"staged_bytes": 0, "calls": 0,
                            "collective_ms": 0.0}
_timing = {"on": False, "pending": []}
_pinned: Dict[tuple, torch.Tensor] = {}


def stats() -> Dict[str, float]:
    """Counts since the last :func:`reset_stats`: ``calls`` (collective
    ops), ``staged_bytes`` (bytes copied through host buffers, both
    ways) and, while :func:`set_timing` is on, ``collective_ms`` (their
    time: CUDA events on a card, read here with one sync; the host clock
    on the CPU)."""
    _fold_timing()
    return dict(_stats)


def reset_stats() -> None:
    _fold_timing()
    _stats.update(staged_bytes=0, calls=0, collective_ms=0.0)


def set_timing(on: bool) -> None:
    """Time every collective op (CUDA events around each on a card)."""
    _timing["on"] = bool(on)


def _fold_timing() -> None:
    pending = _timing["pending"]
    if not pending:
        return
    if any(isinstance(a, torch.cuda.Event) for a, _ in pending):
        torch.cuda.synchronize()
    for a, b in pending:
        _stats["collective_ms"] += (a.elapsed_time(b)
                                    if isinstance(a, torch.cuda.Event)
                                    else (b - a) * 1e3)
    pending.clear()


def _mark(device: torch.device):
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _route(op: str, t: torch.Tensor, group) -> str:
    """``"direct"`` or ``"staged"`` for ``op`` on ``t`` over ``group``'s
    backend; raises for a pairing no route serves."""
    backend = dist.get_backend(group)
    dev = t.device.type
    if backend == "gloo" and dev == "cpu":
        return "direct"
    if backend == "gloo" and dev == "cuda":
        return "direct" if op in _GLOO_CUDA_DIRECT else "staged"
    if backend == "nccl" and dev == "cuda":
        return "direct"
    raise RuntimeError(
        f"collective {op}: the {backend} backend cannot run it on a "
        f"{dev} tensor")


def _pinned_view(like: torch.Tensor, tag: str) -> torch.Tensor:
    """A pinned host buffer shaped like ``like`` (one grown-on-demand
    buffer per tag and dtype; the ops here are synchronous, so a buffer
    is free again when its op returns)."""
    key = (tag, like.dtype)
    buf = _pinned.get(key)
    if buf is None or buf.numel() < like.numel():
        buf = torch.empty(like.numel(), dtype=like.dtype, pin_memory=True)
        _pinned[key] = buf
    return buf[:like.numel()].view(like.shape)


def _host(t: torch.Tensor, tag: str) -> torch.Tensor:
    """``t``'s values in the pinned buffer of ``tag``."""
    view = _pinned_view(t, tag)
    view.copy_(t)
    _stats["staged_bytes"] += t.numel() * t.element_size()
    return view


def _back(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    _stats["staged_bytes"] += host.numel() * host.element_size()
    return host.to(device, copy=True)


class _Op:
    """Counts and (when on) times one collective op."""

    def __init__(self, device: torch.device):
        self.device = device

    def __enter__(self):
        _stats["calls"] += 1
        self.t0 = _mark(self.device) if _timing["on"] else None
        return self

    def __exit__(self, *exc):
        if self.t0 is not None and exc[0] is None:
            _timing["pending"].append((self.t0, _mark(self.device)))
        return False


# ---------------------------------------------------------------- raw ops

def all_reduce_raw(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of ``t`` over ``group``, in a new tensor. Half-precision
    tensors are summed in float32 (gloo's sums of them are not portable,
    and f32 partial sums keep a row-parallel layer's rounding to one
    cast)."""
    if group is None:
        return t.clone()
    _route("all_reduce", t, group)
    low = t.dtype in (torch.bfloat16, torch.float16)
    out = t.float() if low else t.clone()
    with _Op(t.device):
        dist.all_reduce(out, group=group)
    return out.to(t.dtype) if low else out


def broadcast_raw(t: torch.Tensor, src_global: int, group) -> None:
    """``t`` from global rank ``src_global`` to every rank of ``group``,
    in place."""
    if group is None:
        return
    _route("broadcast", t, group)
    with _Op(t.device):
        dist.broadcast(t, src=src_global, group=group)


def all_gather_raw(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank
    order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    route = _route("all_gather", t, group)
    with _Op(t.device):
        src = t.contiguous()
        if route == "staged":
            h = _host(src, "gather_in")
            outs = [torch.empty_like(h) for _ in range(n)]
            dist.all_gather(outs, h, group=group)
            return _back(torch.cat(outs, dim=dim), t.device)
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=group)
        return torch.cat(outs, dim=dim)


def all_to_all_raw(t: torch.Tensor, split_dim: int, concat_dim: int,
                   group) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``t`` cut into ``n`` blocks along
    ``split_dim``, block ``j`` sent to group rank ``j``, the received
    blocks concatenated along ``concat_dim`` in source order."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dimension {split_dim} of "
                         f"{tuple(t.shape)} does not divide over {n} ranks")
    route = _route("all_to_all", t, group)
    with _Op(t.device):
        # Block j to rank j: move split_dim to the front so the blocks are
        # contiguous rows of one buffer.
        x = t.movedim(split_dim, 0)
        x = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
        if route == "staged":
            h = _host(x, "a2a_in")
            out = torch.empty_like(h)
            dist.all_to_all_single(out, h, group=group)
            out = _back(out, t.device)
        else:
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=group)
        # out[j] is rank j's block: put the source index next to concat_dim.
        out = out.reshape(n * out.shape[1], *out.shape[2:]).movedim(
            0, split_dim)
        blocks = out.chunk(n, dim=split_dim)
        return torch.cat(blocks, dim=concat_dim)


def reduce_scatter_raw(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's block of it along
    ``dim`` (``n`` equal blocks in group-rank order): the transpose of
    :func:`all_gather_raw`. Half-precision tensors are summed in float32
    and cast once, as :func:`all_reduce_raw` does."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dimension {dim} of "
                         f"{tuple(t.shape)} does not divide over {n} ranks")
    route = _route("reduce_scatter", t, group)
    low = t.dtype in (torch.bfloat16, torch.float16)
    with _Op(t.device):
        # Block j to rank j: split_dim to the front, blocks contiguous.
        x = t.movedim(dim, 0)
        x = x.reshape(n, x.shape[0] // n, *x.shape[1:]).contiguous()
        if dist.get_backend(group) == "nccl":
            src = x.float() if low else x
            out = torch.empty(src.shape[1:], dtype=src.dtype,
                              device=src.device)
            dist.reduce_scatter_tensor(out, src.reshape(-1, *src.shape[2:]),
                                       group=group)
        else:
            # Gloo: every rank's block j reaches rank j, summed here.
            src = _host(x, "rs_in") if route == "staged" else x
            recv = torch.empty_like(src)
            dist.all_to_all_single(recv, src, group=group)
            out = recv.sum(dim=0, dtype=torch.float32 if low else None)
        out = out.to(t.dtype)
        if route == "staged":
            out = _back(out, t.device)
        return out.movedim(0, dim).contiguous()


def ring_shift_raw(t: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """``lax.ppermute`` with ``(i, (i + offset) % n)``: group rank ``i``
    sends ``t`` to rank ``i + offset`` and returns what rank
    ``i - offset`` sent."""
    if group is None:
        return t
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + offset) % n)
    src = dist.get_global_rank(group, (me - offset) % n)
    if dst == src == dist.get_rank():
        return t
    route = _route("send_recv", t, group)
    with _Op(t.device):
        send = t.contiguous()
        if route == "staged":
            send = _host(send, "send")
            recv = _pinned_view(send, "recv")
        else:
            recv = torch.empty_like(send)
        reqs: List = [dist.isend(send, dst, group=group),
                      dist.irecv(recv, src, group=group)]
        for r in reqs:
            r.wait()
        if route == "staged":
            return _back(recv, t.device)
        return recv


# --------------------------------------------------------- autograd ops

class _CopyToRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_raw(g, ctx.group), None


class _ReduceFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_raw(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        full = all_reduce_raw(g.contiguous(), ctx.group)
        mine = full.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
        return mine.contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return reduce_scatter_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g.contiguous(), ctx.dim, ctx.group), None, None


class _GatherFromRegion(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_raw(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        mine = g.chunk(n, dim=ctx.dim)[dist.get_rank(ctx.group)]
        return mine.contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, group):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return all_to_all_raw(x, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return (all_to_all_raw(g.contiguous(), concat_dim, split_dim,
                               ctx.group), None, None, None)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return ring_shift_raw(x, group, offset)

    @staticmethod
    def backward(ctx, g):
        return ring_shift_raw(g.contiguous(), ctx.group, -ctx.offset), \
            None, None


def copy_to_region(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, all_reduce (sum) of the gradient over ``group``."""
    return x if group is None else _CopyToRegion.apply(x, group)


def reduce_from_region(x: torch.Tensor, group) -> torch.Tensor:
    """All_reduce (sum) over ``group`` forward, identity backward."""
    return x if group is None else _ReduceFromRegion.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block concatenated along ``dim`` (group-rank order)."""
    return x if group is None else _AllGather.apply(x, dim, group)


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over ``group``, this rank's block along ``dim``; backward
    all_gathers the gradient."""
    return x if group is None else _ReduceScatter.apply(x, dim, group)


def gather_from_region(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's block concatenated along ``dim``; backward keeps this
    rank's block of the gradient (every peer uses the whole output)."""
    return x if group is None else _GatherFromRegion.apply(x, dim, group)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int,
               group) -> torch.Tensor:
    """Tiled all_to_all: split along ``split_dim``, concatenate the
    received blocks along ``concat_dim``."""
    if group is None:
        return x
    return _AllToAll.apply(x, split_dim, concat_dim, group)


def ring_shift(x: torch.Tensor, group, offset: int = 1) -> torch.Tensor:
    """Send to group rank ``i + offset``, receive from ``i - offset``."""
    return x if group is None else _RingShift.apply(x, group, offset)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)
