"""The port's sequence-parallel attention (``raydp_tpu_torch/ops/
attention.py``: ``ring_attention``, ``ulysses_attention``) against the
JAX package's (``raydp_tpu/ops/attention.py:73-194``), mirroring
``tests/test_attention.py``'s ring and Ulysses cases.

The same numpy q/k/v go through the JAX functions on the conftest's
virtual CPU devices and through the port's on a gang of 4 gloo CPU
ranks, each holding its rows (dp) and its block of positions (sp); the
blocks are put back together and held at the JAX package's bounds:
forward 2e-4 / 2e-5, gradients 1e-3 / 1e-4 (5e-3 / 5e-4 for the 2k-token
case, as ``test_attention.py`` holds it). Also: Ulysses' refusal of
heads that do not divide over sp, and a ``CausalLM`` with ring attention
over sp against the JAX model's dense logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raydp_tpu.ops import reference_attention as jax_reference
from raydp_tpu.ops import ring_attention as jax_ring
from raydp_tpu.ops import ulysses_attention as jax_ulysses
from raydp_tpu.parallel import MeshSpec as JaxMeshSpec
from torch_mesh_gang import gang, run

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)


@pytest.fixture(scope="module")
def job():
    with gang(4, "t-ring") as j:
        yield j


def _qkv(b=2, s=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda: (rng.standard_normal((b, s, h, d)) / np.sqrt(d)).astype(
        np.float32)
    return mk(), mk(), mk()


def _port_attention(ctx, impl, axes, q, k, v, causal, grad):
    """This rank's block of the port's attention (and, with ``grad``,
    the gradients of the sum of its squares)."""
    import torch

    from raydp_tpu_torch.ops.attention import (
        ring_attention,
        ulysses_attention,
    )
    from raydp_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(**axes).build()
    dp, sp = mesh.coords["dp"], mesh.coords["sp"]
    b_l, s_l = q.shape[0] // mesh.shape["dp"], q.shape[1] // mesh.shape["sp"]
    blk = (slice(dp * b_l, (dp + 1) * b_l), slice(sp * s_l, (sp + 1) * s_l))
    ts = [torch.from_numpy(np.ascontiguousarray(x[blk])).requires_grad_()
          for x in (q, k, v)]
    fn = ring_attention if impl == "ring" else ulysses_attention
    out = fn(*ts, mesh, causal=causal)
    grads = None
    if grad:
        (out ** 2).sum().backward()
        grads = [t.grad.numpy() for t in ts]
    return dp, sp, out.detach().numpy(), grads


def _assemble(parts, axes, shape, pick):
    full = np.zeros(shape, np.float32)
    b_l = shape[0] // axes.get("dp", 1)
    s_l = shape[1] // axes.get("sp", 1)
    for dp, sp, out, grads in parts:
        full[dp * b_l:(dp + 1) * b_l, sp * s_l:(sp + 1) * s_l] = pick(
            out, grads)
    return full


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_jax(job, eight_cpu_devices, causal):
    q, k, v = _qkv(s=64)
    mesh = JaxMeshSpec(sp=4).build(jax.devices()[:4])
    want = jax_ring(*map(jnp.asarray, (q, k, v)), mesh, causal=causal,
                    batch_axis=None)
    parts = run(job, _port_attention, "ring", dict(sp=4), q, k, v, causal,
                False)
    got = _assemble(parts, dict(sp=4), q.shape, lambda o, g: o)
    np.testing.assert_allclose(got, np.asarray(want), **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_dp_sp_mesh_matches_jax(job, eight_cpu_devices,
                                               causal):
    q, k, v = _qkv(b=4, s=32)
    axes = dict(dp=2, sp=2)
    mesh = JaxMeshSpec(**axes).build(jax.devices()[:4])
    want = jax_ring(*map(jnp.asarray, (q, k, v)), mesh, causal=causal)
    parts = run(job, _port_attention, "ring", axes, q, k, v, causal, False)
    got = _assemble(parts, axes, q.shape, lambda o, g: o)
    np.testing.assert_allclose(got, np.asarray(want), **FWD)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_jax(job, eight_cpu_devices, causal):
    q, k, v = _qkv(b=2, s=32, h=8)
    mesh = JaxMeshSpec(sp=4).build(jax.devices()[:4])
    want = jax_ulysses(*map(jnp.asarray, (q, k, v)), mesh, causal=causal,
                       batch_axis=None)
    parts = run(job, _port_attention, "ulysses", dict(sp=4), q, k, v,
                causal, True)
    got = _assemble(parts, dict(sp=4), q.shape, lambda o, g: o)
    np.testing.assert_allclose(got, np.asarray(want), **FWD)


def _bad_heads(ctx):
    import torch

    from raydp_tpu_torch.ops.attention import ulysses_attention
    from raydp_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(sp=4).build()
    q = torch.zeros(1, 8, 2, 4)
    try:
        ulysses_attention(q, q, q, mesh)
    except ValueError as exc:
        return str(exc)
    return "no error"


def test_ulysses_rejects_bad_heads(job):
    for msg in run(job, _bad_heads):
        assert "divisible" in msg and "heads (2)" in msg and "sp (4)" in msg


def _jax_ring_grads(q, k, v, n):
    mesh = JaxMeshSpec(sp=n).build(jax.devices()[:n])

    def loss(q, k, v):
        return (jax_ring(q, k, v, mesh, causal=True,
                         batch_axis=None) ** 2).sum()

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_grads_match_jax(job, eight_cpu_devices, impl):
    """The port's backward (autograd through the ring shifts; the inverse
    all_to_all for Ulysses) against JAX's gradients of its ring."""
    q, k, v = _qkv(b=1, s=32, h=4, d=8)
    want = _jax_ring_grads(q, k, v, 4)
    parts = run(job, _port_attention, impl, dict(sp=4), q, k, v, True, True)
    for i, name in enumerate("qkv"):
        got = _assemble(parts, dict(sp=4), q.shape, lambda o, g: g[i])
        np.testing.assert_allclose(got, np.asarray(want[i]), err_msg=name,
                                   **GRAD)


def test_long_context_ring_attention_2k(job, eight_cpu_devices):
    """``test_attention.py``'s 2k-token case at its own length: seq 2048
    over sp=4 here (512-token blocks; the JAX case splits it over 8
    devices), forward against the JAX ring and gradients against JAX's
    dense attention, at that test's bounds."""
    q, k, v = _qkv(b=1, s=2048, h=2, d=16, seed=3)
    mesh = JaxMeshSpec(sp=8).build()
    jq = tuple(map(jnp.asarray, (q, k, v)))
    want = jax_ring(*jq, mesh, causal=True, batch_axis=None)
    g_dense = jax.jit(jax.grad(lambda a, b, c: jnp.sum(
        jax_reference(a, b, c, causal=True) ** 2), argnums=(0, 1, 2)))(*jq)
    parts = run(job, _port_attention, "ring", dict(sp=4), q, k, v, True,
                True)
    got = _assemble(parts, dict(sp=4), q.shape, lambda o, g: o)
    np.testing.assert_allclose(got, np.asarray(want), **FWD)
    for i in range(3):
        g = _assemble(parts, dict(sp=4), q.shape, lambda o, gr: gr[i])
        np.testing.assert_allclose(g, np.asarray(g_dense[i]), rtol=5e-3,
                                   atol=5e-4)


def _lm_ring(ctx, tree, ids, cfg_kw):
    import torch

    from raydp_tpu_torch.models.convert import params_from_flax
    from raydp_tpu_torch.models.transformer import (
        CausalLM,
        tiny_transformer,
    )
    from raydp_tpu_torch.parallel import MeshSpec

    mesh = MeshSpec(sp=4).build()
    cfg = tiny_transformer(dtype=torch.float32, mesh=mesh, **cfg_kw)
    model = CausalLM(cfg, device="cpu")
    model.load_state_dict(params_from_flax(tree, cfg, mesh=mesh))
    with torch.no_grad():
        return model(torch.from_numpy(ids)).numpy()


def test_causal_lm_ring_over_sp_matches_jax_dense(job, eight_cpu_devices):
    """``test_attention.py``'s long-context LM case on the port: seq 1024
    over sp=4 with ring attention through the model stack, against the
    JAX model's dense logits at that test's bound."""
    import flax.linen as nn

    from raydp_tpu.models.transformer import CausalLM, tiny_transformer

    kw = dict(max_len=1024, vocab_size=128, n_layers=1, dropout_rate=0.0,
              causal=True)
    jmodel = CausalLM(cfg=tiny_transformer(attention_impl="dense",
                                           dtype=jnp.float32, **kw))
    ids = np.random.default_rng(0).integers(0, 128, (2, 1024)).astype(
        np.int32)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids)))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(ids)))
    tree = jax.tree_util.tree_map(np.asarray, params["params"])
    for got in run(job, _lm_ring, tree, ids,
                   dict(attention_impl="ring", **kw)):
        assert got.shape == (2, 1024, 128)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
