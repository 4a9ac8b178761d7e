"""The port's flash-attention forward against the JAX package's.

On the CPU the port's wrapper runs its plain version; the JAX side runs
the Pallas forward in interpret mode, as the JAX package's own tests do.
Inputs come from numpy with a fixed seed and go to both frameworks.
Tolerances are the JAX package's own (tests/test_attention.py): f32
rtol 2e-4 / atol 2e-5, bf16 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.ops.flash_attention import _flash_forward
from raydp_tpu_torch.ops.attention import reference_attention
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_forward,
    flash_attention_plain,
)

TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}

# (B, S, H, D, block): blocks of 32 over S 128, and the default block
# (clamped to S) at S 16.
SHAPES = [(2, 128, 2, 32, 32), (1, 16, 2, 16, 128)]


def _qkv(b, s, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(3)]


def _both(arrays, dtype):
    """The same (bf16-quantised, where asked) inputs for JAX and torch."""
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    jq = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in tq]
    return jq, tq


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_jax_out_and_lse(shape, causal, dtype):
    b, s, h, d, block = shape
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, s, h, d), dtype)
    j_out, j_lse, _, _, _ = _flash_forward(
        jq, jk, jv, causal, block, block, True
    )
    t_out, t_lse = flash_attention_forward(
        tq, tk, tv, causal=causal, block_q=block, block_kv=block
    )
    assert t_out.shape == (b, s, h, d) and t_out.dtype == tq.dtype
    assert t_lse.shape == (b, h, s, 1) and t_lse.dtype == torch.float32
    np.testing.assert_allclose(
        t_out.float().numpy(),
        np.asarray(jnp.einsum("bhsd->bshd", j_out), dtype=np.float32),
        **TOL[dtype],
    )
    np.testing.assert_allclose(
        t_lse.numpy(), np.asarray(j_lse), **TOL["float32"]
    )


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_dense_attention(causal):
    """Blockwise online softmax equals one dense softmax."""
    _, (q, k, v) = _both(_qkv(2, 64, 2, 16, seed=1), "float32")
    out = flash_attention(q, k, v, causal=causal, block_q=16, block_kv=32)
    ref = reference_attention(q, k, v, causal=causal)
    torch.testing.assert_close(out, ref, **TOL["float32"])


def test_strided_views_of_fused_qkv():
    """q/k/v as views of one [B,S,3,H,D] projection give the same result
    as contiguous copies (the transformer passes views)."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 32, 3, 2, 16), dtype=np.float32)
    )
    q, k, v = qkv.unbind(dim=2)
    got = flash_attention(q, k, v, causal=True)
    want = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_rejects_indivisible_seq():
    _, (q, k, v) = _both(_qkv(1, 48, 2, 16), "float32")
    with pytest.raises(ValueError, match="divisible"):
        flash_attention(q, k, v, block_q=32, block_kv=32)
    with pytest.raises(ValueError, match="divisible"):
        flash_attention_plain(q, k, v, block_q=32, block_kv=32)


def test_backward_raises_not_implemented():
    _, (q, k, v) = _both(_qkv(1, 16, 2, 16), "float32")
    q.requires_grad_(True)
    out = flash_attention(q, k, v)
    with pytest.raises(NotImplementedError, match="Queue B"):
        out.sum().backward()


def test_cpu_path_launches_no_kernel():
    _, (q, k, v) = _both(_qkv(1, 16, 2, 16), "float32")
    before = flash_attention.launches
    flash_attention(q, k, v)
    assert flash_attention.launches == before
