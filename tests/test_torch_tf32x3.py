"""The arithmetic of the f32 wgmma kernels, emulated on the CPU.

The f32 forward (``flash_fwd_f32_kernel``), dq
(``flash_bwd_dq_f32_kernel``) and dk/dv (``flash_bwd_dkv_f32_kernel``)
take every matrix product on the tensor cores in TF32 x3: each operand x
is split into big = x with its 13 low mantissa bits cleared (a TF32
value) and small = x - big, and a.b is a_big.b_big + a_big.b_small +
a_small.b_big, each product reading its operands as TF32 (the low 13
bits of small dropped as well). Here the same tile loops (64 query rows
by 32 kv rows forward; 64 query rows by 16 kv rows, 32 at D 16, in dq;
64 kv rows by 32 query rows, 16 at D 128, in the transposed frame of
dk/dv) run in torch with every product emulated that way, and once more
with a single TF32 product, and both are held against the JAX package's
Pallas flash attention in interpret mode and its ``jax.vjp`` on the same
numpy inputs.
TF32 x3 has to meet the f32 bounds the JAX package holds itself to
(forward rtol 2e-4 / atol 2e-5, gradients 1e-3 / 1e-4); one TF32 product
does not, and TF32 x3 has to be at least 50 times closer to the reference.
The emulation is this file's own; the port has no such mode.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.ops.flash_attention import flash_attention as jax_flash

NEG_INF = -1e30
FWD_TOL = dict(rtol=2e-4, atol=2e-5)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
GAIN = 50  # TF32 x3 worst error at least this many times below one TF32's


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) as the tensor cores read it in TF32: 13 low bits cleared."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def mm_tf32x3(a, b):
    big_a, big_b = tf32(a), tf32(b)
    small_a, small_b = tf32(a - big_a), tf32(b - big_b)
    return (big_a @ small_b + small_a @ big_b) + big_a @ big_b


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def forward(q, k, v, causal, mm):
    """The f32 forward kernel's loop: 64 query rows a CTA, 32-row kv
    tiles, online softmax; ``[B, S, H, D]`` in, (out, lse [B, H, S])."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    out = torch.empty_like(qt)
    lse = torch.empty((b, h, s))
    for q0 in range(0, s, 64):
        qb = qt[:, :, q0:q0 + 64]
        rows = qb.shape[2]
        m = torch.full((b, h, rows, 1), NEG_INF)
        l = torch.zeros((b, h, rows, 1))
        acc = torch.zeros((b, h, rows, d))
        kv_end = min(s, q0 + 64) if causal else s
        for k0 in range(0, kv_end, 32):
            kb, vb = kt[:, :, k0:k0 + 32], vt[:, :, k0:k0 + 32]
            sc = mm(qb, kb.transpose(-1, -2)) * scale
            if causal:
                qpos = torch.arange(q0, q0 + rows)[:, None]
                kpos = torch.arange(k0, k0 + kb.shape[2])[None, :]
                sc = sc.masked_fill(qpos < kpos, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
            p = torch.exp(sc - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + mm(p, vb)
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        out[:, :, q0:q0 + rows] = acc / l
        lse[:, :, q0:q0 + rows] = (m + torch.log(l))[..., 0]
    return out.transpose(1, 2), lse


def dkv(q, k, v, g, lse, delta, causal, mm):
    """The f32 dk/dv kernel's loop in its transposed frame: 64 kv rows a
    CTA, q tiles of 32 rows (16 at D 128) from the first live one,
    S^T = K.Q^T, dP^T = V.dO^T, dV += P^T.dO, dK += dS^T.Q, dK's scale
    once at the end. lse and delta are [B, H, S]."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bq = 16 if d == 128 else 32
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    dk, dv = torch.empty_like(kt), torch.empty_like(vt)
    for k0 in range(0, s, 64):
        kb, vb = kt[:, :, k0:k0 + 64], vt[:, :, k0:k0 + 64]
        rows = kb.shape[2]
        dk_acc = torch.zeros((b, h, rows, d))
        dv_acc = torch.zeros((b, h, rows, d))
        for q0 in range((k0 // bq) * bq if causal else 0, s, bq):
            qb, gb = qt[:, :, q0:q0 + bq], gt[:, :, q0:q0 + bq]
            cols = qb.shape[2]
            st = mm(kb, qb.transpose(-1, -2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + rows)[:, None]
                qpos = torch.arange(q0, q0 + cols)[None, :]
                st = st.masked_fill(qpos < kpos, NEG_INF)
            p = torch.exp(st - lse[:, :, None, q0:q0 + cols])
            ds = p * (mm(vb, gb.transpose(-1, -2))
                      - delta[:, :, None, q0:q0 + cols])
            dv_acc = dv_acc + mm(p, gb)
            dk_acc = dk_acc + mm(ds, qb)
        dk[:, :, k0:k0 + rows] = dk_acc * scale
        dv[:, :, k0:k0 + rows] = dv_acc
    return dk.transpose(1, 2), dv.transpose(1, 2)


def dq(q, k, v, g, lse, delta, causal, mm):
    """The f32 dq kernel's loop: 64 query rows a CTA, kv tiles of 16 rows
    (32 at D 16) up to the last live one, S = Q.K^T, dP = dO.V^T,
    dQ += dS.K, dQ's scale once at the end. lse and delta are [B, H, S]."""
    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    bkv = 32 if d == 16 else 16
    qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, g))
    dq = torch.empty_like(qt)
    for q0 in range(0, s, 64):
        qb, gb = qt[:, :, q0:q0 + 64], gt[:, :, q0:q0 + 64]
        rows = qb.shape[2]
        acc = torch.zeros((b, h, rows, d))
        kv_end = min(s, q0 + 64) if causal else s
        for k0 in range(0, kv_end, bkv):
            kb, vb = kt[:, :, k0:k0 + bkv], vt[:, :, k0:k0 + bkv]
            sc = mm(qb, kb.transpose(-1, -2)) * scale
            if causal:
                qpos = torch.arange(q0, q0 + rows)[:, None]
                kpos = torch.arange(k0, k0 + kb.shape[2])[None, :]
                sc = sc.masked_fill(qpos < kpos, NEG_INF)
            p = torch.exp(sc - lse[:, :, q0:q0 + rows, None])
            ds = p * (mm(gb, vb.transpose(-1, -2))
                      - delta[:, :, q0:q0 + rows, None])
            acc = acc + mm(ds, kb)
        dq[:, :, q0:q0 + rows] = acc * scale
    return dq.transpose(1, 2)


def _emulate_dq(q, k, v, g, causal, mm):
    out, lse = forward(q, k, v, causal, mm)
    delta = (g * out).sum(dim=-1).transpose(1, 2)  # the f32 delta pass
    return dq(q, k, v, g, lse, delta, causal, mm)


def _emulate(q, k, v, g, causal, mm):
    out, lse = forward(q, k, v, causal, mm)
    delta = (g * out).sum(dim=-1).transpose(1, 2)  # the f32 delta pass
    return (out,) + dkv(q, k, v, g, lse, delta, causal, mm)


def _worst(got, want):
    return max(float(np.abs(a.numpy() - np.asarray(w)).max())
               for a, w in zip(got, want))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 48, 128])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tf32x3_meets_the_f32_bounds_and_one_tf32_does_not(d, s, causal):
    rng = np.random.default_rng(d * 1000 + s)
    arrays = [rng.standard_normal((1, s, 2, d), dtype=np.float32)
              for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    want_out, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True),
        jq, jk, jv)
    _, want_dk, want_dv = vjp(jg)
    want = (want_out, want_dk, want_dv)

    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    x3 = _emulate(q, k, v, g, causal, mm_tf32x3)
    x1 = _emulate(q, k, v, g, causal, mm_tf32)

    np.testing.assert_allclose(x3[0].numpy(), np.asarray(want_out),
                               err_msg="out", **FWD_TOL)
    for got, ref, name in zip(x3[1:], want[1:], ("dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   err_msg=name, **GRAD_TOL)
    for part in (slice(0, 1), slice(1, 3)):  # the forward; dk and dv
        err3, err1 = _worst(x3[part], want[part]), _worst(x1[part],
                                                         want[part])
        assert err3 * GAIN <= err1, (part, err3, err1)
    assert not np.allclose(x1[0].numpy(), np.asarray(want_out), **FWD_TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", [16, 48, 128])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_tf32x3_dq_meets_the_f32_bounds_and_one_tf32_does_not(d, s, causal):
    """The f32 dq kernel's loop, its lse and delta from the emulated
    forward as the card's come from the forward and delta kernels,
    against ``jax.vjp``'s dq."""
    rng = np.random.default_rng(d * 1000 + s + 7)
    arrays = [rng.standard_normal((1, s, 2, d), dtype=np.float32)
              for _ in range(4)]
    jq, jk, jv, jg = (jnp.asarray(a) for a in arrays)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True),
        jq, jk, jv)
    want = np.asarray(vjp(jg)[0])

    q, k, v, g = (torch.from_numpy(a) for a in arrays)
    x3 = _emulate_dq(q, k, v, g, causal, mm_tf32x3)
    x1 = _emulate_dq(q, k, v, g, causal, mm_tf32)

    np.testing.assert_allclose(x3.numpy(), want, err_msg="dq", **GRAD_TOL)
    err3, err1 = _worst([x3], [want]), _worst([x1], [want])
    assert err3 * GAIN <= err1, (err3, err1)
    assert not np.allclose(x1.numpy(), want, **GRAD_TOL)


def test_split_is_exact_and_big_is_tf32():
    """big + small == x in f32, big has no bit below TF32's 10-bit
    mantissa, and |small| < 2^-10 |x|."""
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        4096, dtype=np.float32) * 100)
    big = tf32(x)
    small = x - big
    assert torch.equal(big + small, x)
    assert torch.equal(big.view(torch.int32) & 8191,
                       torch.zeros_like(big, dtype=torch.int32))
    assert bool((small.abs() < x.abs() * 2.0 ** -10).all())
