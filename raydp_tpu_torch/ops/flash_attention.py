"""Flash-attention forward: a hand-written Hopper kernel and its plain version.

The counterpart of the forward of ``raydp_tpu/ops/flash_attention.py``
(``_flash_kernel`` launched by ``_flash_forward``). Shapes are
``[B, S, H, D]`` in and out; ``lse`` is the f32 row logsumexp of the
scaled scores, ``[B, H, S, 1]``, as the TPU launcher returns it.

Dispatch goes by the tensors' device: CUDA tensors launch the kernel in
``csrc/flash_fwd.cu`` (or raise), CPU tensors take
:func:`flash_attention_plain`. ``flash_attention.launches`` counts kernel
launches. The backward kernels are not ported yet: gradients raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

NEG_INF = -1e30

KERNEL_HEAD_DIMS = (16, 32, 64, 128)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_BACKWARD_TODO = (
    "flash attention backward is not ported yet: the dq/dkv kernels "
    "(_bwd_dq_kernel, _bwd_dkv_kernel) and the delta pre-pass are ROADMAP "
    "Queue B items 2 and 3 (the training slice)"
)


def _blocks(s: int, block_q: int, block_kv: int) -> Tuple[int, int]:
    block_q, block_kv = min(block_q, s), min(block_kv, s)
    if s % block_q or s % block_kv:
        raise ValueError(f"seq len {s} not divisible by blocks "
                         f"({block_q}, {block_kv})")
    return block_q, block_kv


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
    pos = torch.arange(s, device=q.device)
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
                live = pos[q0:q0 + block_q, None] >= pos[None, k0:k0 + block_kv]
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


def _flash_fwd_cuda(q, k, v, causal, block_q, block_kv):
    """Launch ``raydp_flash_fwd`` on the tensors' stream; raise on anything
    the kernel does not take or on a launch error."""
    b, s, h, d = q.shape
    _blocks(s, block_q, block_kv)  # the JAX launcher's contract on S
    if not (k.shape == q.shape and v.shape == q.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16 q/k/v, "
                        f"got {q.dtype} {k.dtype} {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim {d} not in {KERNEL_HEAD_DIMS}")
    if any(x.stride(-1) != 1 for x in (q, k, v)):
        raise ValueError("flash kernel needs a contiguous head dimension")

    from raydp_tpu_torch.ops import _build

    lib = _build.load("flash_fwd.cu")
    fn = lib.raydp_flash_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
        + [ctypes.c_longlong] * 12 + [ctypes.c_void_p]
    )
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s, 1), dtype=torch.float32, device=q.device)
    strides = []
    for x in (q, k, v, out):
        strides += [x.stride(0), x.stride(1), x.stride(2)]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), _KERNEL_DTYPES[q.dtype], b, s, h, d, int(causal),
            1.0 / math.sqrt(d), *strides, stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
    flash_attention.launches += 1
    return out, lse


class _FlashAttentionFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, block_q, block_kv):
        if q.is_cuda:
            out, lse = _flash_fwd_cuda(q, k, v, causal, block_q, block_kv)
        elif q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal, block_q,
                                             block_kv)
        else:
            raise ValueError(f"flash attention has no path for {q.device}")
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, grad_out, grad_lse):
        raise NotImplementedError(_BACKWARD_TODO)


def flash_attention_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    block_q: int = 128,
    block_kv: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,S,H,D], lse [B,H,S,1] f32)``. S must divide by
    ``min(block, S)`` for both blocks, as the TPU launcher requires."""
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


flash_attention.launches = 0  # kernel launches, counted where they happen
