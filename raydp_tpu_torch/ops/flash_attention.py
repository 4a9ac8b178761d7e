"""Flash attention: hand-written Hopper kernels and their plain versions.

The counterpart of ``raydp_tpu/ops/flash_attention.py``: the forward
(``_flash_kernel`` launched by ``_flash_forward``) and the backward
(``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` launched by
``_flash_bwd_rule``, with its delta pre-pass). Shapes are ``[B, S, H, D]``
in and out; ``lse`` is the f32 row logsumexp of the scaled scores and
``delta`` the f32 row sum of ``dO * O``, both ``[B, H, S, 1]`` as the TPU
launchers keep them.

Dispatch goes by the tensors' device: CUDA tensors launch the kernels in
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` (or raise), CPU tensors
take the plain versions, which compute the same tile-by-tile function
with the JAX package's block sizes and casts. Each kernel wrapper counts
its launches in an integer ``launches`` attribute: ``flash_attention``,
``flash_bwd_delta``, ``flash_bwd_dq`` and ``flash_bwd_dkv``. The wgmma
kernels (the forward, dq and dk/dv, bf16 and f32) read their inputs with
16-byte copies, so a CUDA tensor of either dtype that
:func:`async_copy_aligned` refuses raises ``ValueError``. The autograd
backward hands them autograd's upstream gradient in a dense copy where
it comes in another layout (the expanded gradient of ``.sum()``).
"""
from __future__ import annotations

import contextlib
import ctypes
import math
from typing import List, Sequence, Tuple

import torch

NEG_INF = -1e30

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _blocks(s: int, block_q: int, block_kv: int) -> Tuple[int, int]:
    block_q, block_kv = min(block_q, s), min(block_kv, s)
    if s % block_q or s % block_kv:
        raise ValueError(f"seq len {s} not divisible by blocks "
                         f"({block_q}, {block_kv})")
    return block_q, block_kv


def _pos_mask(q0: int, bq: int, k0: int, bkv: int, device) -> torch.Tensor:
    """Where query rows [q0, q0+bq) may see key rows [k0, k0+bkv)."""
    qpos = torch.arange(q0, q0 + bq, device=device)
    kpos = torch.arange(k0, k0 + bkv, device=device)
    return qpos[:, None] >= kpos[None, :]


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 128,
    block_kv: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same blockwise online
    softmax, tile by tile, in f32 with P rounded to V's dtype before P·V.
    Returns ``(out [B,S,H,D], lse [B,H,S,1] f32)``."""
    b, s, h, d = q.shape
    block_q, block_kv = _blocks(s, block_q, block_kv)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2).float() for x in (q, k, v))
    outs, lses = [], []
    for q0 in range(0, s, block_q):
        qb = qt[:, :, q0:q0 + block_q]
        m = torch.full((b, h, block_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, h, block_q, 1), device=q.device)
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for k0 in range(0, s, block_kv):
            if causal and q0 + block_q - 1 < k0:
                continue  # tile strictly above the diagonal
            sc = qb @ kt[:, :, k0:k0 + block_kv].transpose(-1, -2) * scale
            if causal:
                live = _pos_mask(q0, block_q, k0, block_kv, q.device)
                sc = sc.masked_fill(~live, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            pv = p.to(v.dtype).float() @ vt[:, :, k0:k0 + block_kv]
            acc = acc * corr + pv
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l).to(q.dtype))
        lses.append(m + torch.log(l))
    out = torch.cat(outs, dim=2).transpose(1, 2).contiguous()
    return out, torch.cat(lses, dim=2)


def _tile_grads(qt, kt, vt, gt, lse, delta, q0, bq, k0, bkv, scale, causal):
    """The backward's tile math, shared by the plain dq and dk/dv (as
    ``_masked_scores`` is on the TPU): p = exp(s - lse) and
    ds = p * (dO·vᵀ - delta) for one (q tile, kv tile), in f32."""
    qb, kb = qt[:, :, q0:q0 + bq], kt[:, :, k0:k0 + bkv]
    sc = qb @ kb.transpose(-1, -2) * scale
    if causal:
        sc = sc.masked_fill(~_pos_mask(q0, bq, k0, bkv, qt.device), NEG_INF)
    p = torch.exp(sc - lse[:, :, q0:q0 + bq])
    dp = gt[:, :, q0:q0 + bq] @ vt[:, :, k0:k0 + bkv].transpose(-1, -2)
    return p, p * (dp - delta[:, :, q0:q0 + bq])


def _to_bhsd_f32(*xs):
    return [x.transpose(1, 2).float() for x in xs]


def flash_bwd_delta_plain(out: torch.Tensor,
                          grad_out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO ⊙ O)`` in f32, ``[B, H, S, 1]``."""
    prod = (grad_out.float() * out.float()).sum(dim=-1)  # [B, S, H]
    return prod.transpose(1, 2).contiguous().unsqueeze(-1)


def flash_bwd_dq_plain(q, k, v, grad_out, lse, delta, causal=False,
                       block_q: int = 128, block_kv: int = 128):
    """The plain version of the dq kernel: for each q tile, over the live
    kv tiles, ``dq += scale · (ds cast to k's dtype)·k`` in f32; cast to
    q's dtype at the end."""
    b, s, h, d = q.shape
    block_q, block_kv = _blocks(s, block_q, block_kv)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, gt = _to_bhsd_f32(q, k, v, grad_out)
    tiles = []
    for q0 in range(0, s, block_q):
        acc = torch.zeros((b, h, block_q, d), device=q.device)
        for k0 in range(0, s, block_kv):
            if causal and q0 + block_q - 1 < k0:
                continue  # tile strictly above the diagonal
            _, ds = _tile_grads(qt, kt, vt, gt, lse, delta, q0, block_q, k0,
                                block_kv, scale, causal)
            kb = kt[:, :, k0:k0 + block_kv]
            acc = acc + (ds.to(k.dtype).float() @ kb) * scale
        tiles.append(acc.to(q.dtype))
    return torch.cat(tiles, dim=2).transpose(1, 2).contiguous()


def flash_bwd_dkv_plain(q, k, v, grad_out, lse, delta, causal=False,
                        block_q: int = 128, block_kv: int = 128):
    """The plain version of the dk/dv kernel: for each kv tile, over the
    live q tiles, ``dv += (p cast to dO's dtype)ᵀ·dO`` and
    ``dk += scale · (ds cast to q's dtype)ᵀ·q`` in f32."""
    b, s, h, d = q.shape
    block_q, block_kv = _blocks(s, block_q, block_kv)
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt, gt = _to_bhsd_f32(q, k, v, grad_out)
    dks, dvs = [], []
    for k0 in range(0, s, block_kv):
        dk = torch.zeros((b, h, block_kv, d), device=q.device)
        dv = torch.zeros((b, h, block_kv, d), device=q.device)
        for q0 in range(0, s, block_q):
            if causal and q0 + block_q - 1 < k0:
                continue
            p, ds = _tile_grads(qt, kt, vt, gt, lse, delta, q0, block_q, k0,
                                block_kv, scale, causal)
            gb, qb = gt[:, :, q0:q0 + block_q], qt[:, :, q0:q0 + block_q]
            dv = dv + p.to(grad_out.dtype).float().transpose(-1, -2) @ gb
            dk = dk + (ds.to(q.dtype).float().transpose(-1, -2) @ qb) * scale
        dks.append(dk.to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return (torch.cat(dks, dim=2).transpose(1, 2).contiguous(),
            torch.cat(dvs, dim=2).transpose(1, 2).contiguous())


def flash_attention_backward_plain(q, k, v, out, lse, grad_out,
                                   causal=False, block_q: int = 128,
                                   block_kv: int = 128):
    """``(dq, dk, dv)``: the plain versions of the three backward kernels,
    composed as the kernels are."""
    delta = flash_bwd_delta_plain(out, grad_out)
    dq = flash_bwd_dq_plain(q, k, v, grad_out, lse, delta, causal, block_q,
                            block_kv)
    dk, dv = flash_bwd_dkv_plain(q, k, v, grad_out, lse, delta, causal,
                                 block_q, block_kv)
    return dq, dk, dv


# ------------------------------------------------------------ CUDA launches

# ctypes signatures: (pointers, ints, has a float scale, [B,S,H,D] tensors
# whose (b, s, h) strides follow). Every entry ends with a stream pointer.
_SIGNATURES = {
    "raydp_flash_fwd": ("flash_fwd.cu", 5, 6, True, 4),
    "raydp_flash_fwd_resources": ("flash_fwd.cu", 1, 2, False, 0),
    "raydp_flash_bwd_delta": ("flash_bwd.cu", 3, 5, False, 2),
    "raydp_flash_bwd_dq": ("flash_bwd.cu", 7, 6, True, 5),
    "raydp_flash_bwd_dkv": ("flash_bwd.cu", 8, 6, True, 6),
    "raydp_flash_bwd_resources": ("flash_bwd.cu", 1, 3, False, 0),
}

_FNS = {}  # symbol -> its ctypes function, configured once


def _kernel_fn(symbol: str):
    """The C entry ``symbol``, loaded and given its ctypes signature on
    first use and reused after, so a launch adds no per-call setup."""
    fn = _FNS.get(symbol)
    if fn is None:
        from raydp_tpu_torch.ops import _build

        source, n_ptrs, n_ints, has_scale, n_strided = _SIGNATURES[symbol]
        fn = getattr(_build.load(source), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
            + [ctypes.c_float] * has_scale
            + [ctypes.c_longlong] * (3 * n_strided) + [ctypes.c_void_p]
        )
        _FNS[symbol] = fn
    return fn


def _launch(symbol: str, ptrs, ints, scale, strided, device) -> None:
    """Call a kernel's C entry on ``device``'s current stream and raise on
    the ``cudaError_t`` it returns."""
    fn = _kernel_fn(symbol)
    has_scale = _SIGNATURES[symbol][3]
    strides = []
    for x in strided:
        strides += [x.stride(0), x.stride(1), x.stride(2)]
    args = [x.data_ptr() for x in ptrs] + list(ints)
    if has_scale:
        args.append(scale)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, *strides, stream)
    if err != 0:
        raise RuntimeError(f"{symbol} launch failed: cudaError {err}")


def _check_kernel_inputs(name: str, *xs: torch.Tensor) -> None:
    """Raise on [B, S, H, D] tensors the kernels do not take."""
    q = xs[0]
    b, s, h, d = q.shape
    if any(x.shape != q.shape for x in xs):
        raise ValueError(f"{name}: shapes differ: "
                         f"{[tuple(x.shape) for x in xs]}")
    if any(x.dtype != q.dtype for x in xs) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 tensors of one "
                        f"dtype, got {[x.dtype for x in xs]}")
    if any(x.device != q.device for x in xs):
        raise ValueError(f"{name}: tensors must be on one device")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not in {KERNEL_HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in xs):
        raise ValueError(f"{name} needs a contiguous head dimension")
    for x in xs:
        if not async_copy_aligned(x.data_ptr(), x.shape, x.stride(),
                                  x.element_size()):
            raise ValueError(
                f"{name}: tensors are read with 16-byte copies and need a "
                f"16-byte aligned base and (b, s, h) strides of 16 bytes' "
                f"multiples; got address {x.data_ptr()} and strides "
                f"{tuple(x.stride())}")


def async_copy_aligned(address: int, shape, strides, itemsize: int) -> bool:
    """Whether a ``[B, S, H, D]`` tensor with a contiguous last dimension
    can be read in 16-byte chunks: a 16-byte aligned base and, for every
    leading dimension of size above 1, a stride of a multiple of 16 bytes
    (8 bf16 or 4 f32 elements). The fused-qkv views of
    ``models/transformer.py`` pass in both dtypes (strides 3·H·D, H·D and
    D elements of a D in ``KERNEL_HEAD_DIMS``)."""
    if address % 16:
        return False
    return all(size <= 1 or (stride * itemsize) % 16 == 0
               for size, stride in zip(shape[:3], strides[:3]))


def _dense(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernels can read it (a contiguous last
    dimension and :func:`async_copy_aligned`), else a fresh contiguous
    copy: of an expanded or strided tensor, and of a contiguous view at a
    misaligned address, which ``.contiguous()`` would return unchanged.
    A change of layout only; the wrappers still launch or raise."""
    if x.stride(-1) == 1 and async_copy_aligned(
            x.data_ptr(), x.shape, x.stride(), x.element_size()):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def kernel_resources(kernel: str, dtype: torch.dtype, head_dim: int) -> dict:
    """What one CTA of a kernel holds on the card: ``registers`` a thread,
    ``smem_bytes`` a CTA, ``ctas_per_sm`` resident on one SM and
    ``spill_bytes`` of local memory a thread. ``kernel`` is ``"fwd"``,
    ``"dq"`` or ``"dkv"``. Needs the card."""
    out = torch.zeros(4, dtype=torch.int32)  # filled by the C entry
    ints = (_KERNEL_DTYPES[dtype], head_dim)
    if kernel == "fwd":
        symbol = "raydp_flash_fwd_resources"
    else:
        symbol = "raydp_flash_bwd_resources"
        ints = ({"dq": 0, "dkv": 1}[kernel],) + ints
    _launch(symbol, (out,), ints, None, (), torch.device("cuda"))
    return dict(zip(("registers", "smem_bytes", "ctas_per_sm",
                     "spill_bytes"), out.tolist()))


def _check_rows(name: str, q: torch.Tensor, *rows: torch.Tensor) -> None:
    """lse and delta: contiguous f32 ``[B, H, S, 1]`` on q's device."""
    b, s, h, _ = q.shape
    for x in rows:
        if (x.shape != (b, h, s, 1) or x.dtype != torch.float32
                or not x.is_contiguous() or x.device != q.device):
            raise ValueError(f"{name}: row statistics must be contiguous "
                             f"float32 {(b, h, s, 1)} on {q.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")


def _flash_fwd_cuda(q, k, v, causal, block_q, block_kv):
    """Launch ``raydp_flash_fwd``; raise on anything the kernel does not
    take or on a launch error."""
    b, s, h, d = q.shape
    _blocks(s, block_q, block_kv)  # the JAX launcher's contract on S
    _check_kernel_inputs("flash kernel", q, k, v)
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    _launch("raydp_flash_fwd", (q, k, v, out, lse),
            (_KERNEL_DTYPES[q.dtype], b, s, h, d, int(causal)),
            1.0 / math.sqrt(d), (q, k, v, out), q.device)
    flash_attention.launches += 1
    return out, lse


def _on_cpu(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor, False for a CUDA one; raise otherwise."""
    if x.is_cuda:
        return False
    if x.device.type == "cpu":
        return True
    raise ValueError(f"{name} has no path for {x.device}")


def flash_bwd_delta(out: torch.Tensor, grad_out: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO ⊙ O)``, f32 ``[B, H, S, 1]``: the kernel on CUDA
    tensors, :func:`flash_bwd_delta_plain` on CPU ones."""
    if _on_cpu("flash_bwd_delta", out):
        return flash_bwd_delta_plain(out, grad_out)
    _check_kernel_inputs("flash_bwd_delta", out, grad_out)
    b, s, h, d = out.shape
    delta = torch.empty((b, h, s, 1), dtype=torch.float32, device=out.device)
    _launch("raydp_flash_bwd_delta", (out, grad_out, delta),
            (_KERNEL_DTYPES[out.dtype], b, s, h, d), None, (out, grad_out),
            out.device)
    flash_bwd_delta.launches += 1
    return delta


def flash_bwd_dq(q, k, v, grad_out, lse, delta, causal=False,
                 block_q: int = 128, block_kv: int = 128) -> torch.Tensor:
    """dq ``[B, S, H, D]``: the kernel on CUDA tensors,
    :func:`flash_bwd_dq_plain` on CPU ones."""
    if _on_cpu("flash_bwd_dq", q):
        return flash_bwd_dq_plain(q, k, v, grad_out, lse, delta, causal,
                                  block_q, block_kv)
    b, s, h, d = q.shape
    _blocks(s, block_q, block_kv)
    _check_kernel_inputs("flash_bwd_dq", q, k, v, grad_out)
    _check_rows("flash_bwd_dq", q, lse, delta)
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    _launch("raydp_flash_bwd_dq", (q, k, v, grad_out, lse, delta, dq),
            (_KERNEL_DTYPES[q.dtype], b, s, h, d, int(causal)),
            1.0 / math.sqrt(d), (q, k, v, grad_out, dq), q.device)
    flash_bwd_dq.launches += 1
    return dq


def flash_bwd_dkv(q, k, v, grad_out, lse, delta, causal=False,
                  block_q: int = 128, block_kv: int = 128):
    """``(dk, dv)``, each ``[B, S, H, D]``: the kernel on CUDA tensors,
    :func:`flash_bwd_dkv_plain` on CPU ones."""
    if _on_cpu("flash_bwd_dkv", q):
        return flash_bwd_dkv_plain(q, k, v, grad_out, lse, delta, causal,
                                   block_q, block_kv)
    b, s, h, d = q.shape
    _blocks(s, block_q, block_kv)
    _check_kernel_inputs("flash_bwd_dkv", q, k, v, grad_out)
    _check_rows("flash_bwd_dkv", q, lse, delta)
    dk = torch.empty((b, s, h, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, h, d), dtype=v.dtype, device=q.device)
    _launch("raydp_flash_bwd_dkv", (q, k, v, grad_out, lse, delta, dk, dv),
            (_KERNEL_DTYPES[q.dtype], b, s, h, d, int(causal)),
            1.0 / math.sqrt(d), (q, k, v, grad_out, dk, dv), q.device)
    flash_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_backward(q, k, v, out, lse, grad_out, causal=False,
                             block_q: int = 128, block_kv: int = 128):
    """``(dq, dk, dv)`` through the three backward wrappers: the delta
    pre-pass, then dq, then dk/dv."""
    delta = flash_bwd_delta(out, grad_out)
    dq = flash_bwd_dq(q, k, v, grad_out, lse, delta, causal, block_q,
                      block_kv)
    dk, dv = flash_bwd_dkv(q, k, v, grad_out, lse, delta, causal, block_q,
                           block_kv)
    return dq, dk, dv


class _FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        if _on_cpu("flash attention", q):
            out, lse = flash_attention_plain(q, k, v, causal, block_q,
                                             block_kv)
        else:
            out, lse = _flash_fwd_cuda(q, k, v, causal, block_q, block_kv)
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.config = (causal, block_q, block_kv)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if not _on_cpu("flash attention", grad_out):
            grad_out = _dense(grad_out)
        dq, dk, dv = flash_attention_backward(q, k, v, out, lse, grad_out,
                                              *ctx.config)
        return dq, dk, dv, None, None, None


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 128,
    block_kv: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,S,H,D], lse [B,H,S,1] f32)``, differentiable in q, k and
    v. S must divide by ``min(block, S)`` for both blocks, as the TPU
    launcher requires."""
    return _FlashAttentionFunction.apply(q, k, v, causal, block_q, block_kv)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 128,
    block_kv: int = 128,
) -> torch.Tensor:
    """Shapes [B, S, H, D] → [B, S, H, D]."""
    return flash_attention_forward(q, k, v, causal, block_q, block_kv)[0]


# Kernel launches, counted where they happen.
flash_attention.launches = 0
flash_bwd_delta.launches = 0
flash_bwd_dq.launches = 0
flash_bwd_dkv.launches = 0
_COUNTED = (flash_attention, flash_bwd_delta, flash_bwd_dq, flash_bwd_dkv)


@contextlib.contextmanager
def recording_launches():
    """Around a CUDA graph capture, where a wrapper's increment records
    a launch that each replay will make, not one made now. Yields a list
    that is filled on exit with what each counter gained (in the order
    forward, delta, dq, dk/dv), and puts the counters back."""
    before = [fn.launches for fn in _COUNTED]
    gained: List[int] = []
    try:
        yield gained
    finally:
        for fn, b in zip(_COUNTED, before):
            gained.append(fn.launches - b)
            fn.launches = b


def count_replay(launches: Sequence[int]) -> None:
    """Add one replay's launches, as :func:`recording_launches` gave
    them, to the counters."""
    for fn, n in zip(_COUNTED, launches):
        fn.launches += n
