"""The port's flash-attention backward against the JAX package's.

On the CPU the port's autograd runs the plain backward (the same tile
math as the card's dq and dk/dv kernels, with the JAX package's block
sizes and casts); the JAX side is ``jax.vjp`` of the Pallas flash
attention in interpret mode, as the JAX package's own tests run it.
Inputs and cotangents come from numpy with a fixed seed and go to both
frameworks. Tolerances are the JAX package's own gradient bounds
(``tests/test_attention.py``): f32 rtol 1e-3 / atol 1e-4, bf16 6e-2.

Then the whole slice: parameter gradients of a tiny ``SequenceClassifier``
and a tiny ``CausalLM`` (flash, f32, dropout 0) through ``.backward()``
against ``jax.grad``, from the same converted parameters.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from raydp_tpu.models import transformer as jt
from raydp_tpu.ops.flash_attention import flash_attention as jax_flash
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.ops.attention import reference_attention
from raydp_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_backward_plain,
    flash_attention_forward,
    flash_bwd_delta,
    flash_bwd_dkv,
    flash_bwd_dq,
)

GRAD_TOL = {"float32": dict(rtol=1e-3, atol=1e-4),
            "bfloat16": dict(rtol=6e-2, atol=6e-2)}

# (B, S, H, D, block): blocks of 32 over S 96, the default block over
# S 64, and S 16 at the default block (clamped to S).
SHAPES = [(2, 96, 2, 32, 32), (1, 64, 2, 16, 128), (1, 16, 2, 16, 128)]


def _arrays(b, s, h, d, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d), dtype=np.float32)
            for _ in range(n)]


def _both(arrays, dtype):
    """The same (bf16-quantised, where asked) arrays for torch and JAX."""
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    js = [jnp.asarray(t.float().numpy()).astype(getattr(jnp, dtype))
          for t in ts]
    return ts, js


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_gradients_match_jax_vjp(shape, causal, dtype):
    b, s, h, d, block = shape
    (tq, tk, tv, tg), (jq, jk, jv, jg) = _both(_arrays(b, s, h, d), dtype)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, block_q=block,
                                  block_kv=block, interpret=True),
        jq, jk, jv,
    )
    want = vjp(jg)
    leaves = [x.requires_grad_(True) for x in (tq, tk, tv)]
    flash_attention(*leaves, causal=causal, block_q=block,
                    block_kv=block).backward(tg)
    for leaf, w, name in zip(leaves, want, "qkv"):
        assert leaf.grad.dtype == leaf.dtype, name
        np.testing.assert_allclose(
            leaf.grad.float().numpy(), np.asarray(w, dtype=np.float32),
            err_msg=f"d{name}", **GRAD_TOL[dtype],
        )


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_matches_dense_autograd(causal):
    """The blockwise backward equals autograd through one dense softmax."""
    (q, k, v, g), _ = _both(_arrays(2, 64, 2, 16, seed=1), "float32")
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_attention(*leaves, causal=causal, block_q=16,
                    block_kv=32).backward(g)
    dense = [x.clone().requires_grad_(True) for x in (q, k, v)]
    reference_attention(*dense, causal=causal).backward(g)
    for a, b in zip(leaves, dense):
        torch.testing.assert_close(a.grad, b.grad, **GRAD_TOL["float32"])


def test_autograd_runs_the_plain_pieces_in_order():
    """``.backward()`` on CPU tensors equals the composed plain
    delta → dq → dk/dv, bit for bit, and launches no kernel."""
    (q, k, v, g), _ = _both(_arrays(1, 32, 2, 16, seed=2), "bfloat16")
    out, lse = flash_attention_forward(q, k, v, causal=True)
    want = flash_attention_backward_plain(q, k, v, out, lse, g, causal=True)
    counts = (flash_bwd_delta.launches, flash_bwd_dq.launches,
              flash_bwd_dkv.launches)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    flash_attention(*leaves, causal=True).backward(g)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
    assert (flash_bwd_delta.launches, flash_bwd_dq.launches,
            flash_bwd_dkv.launches) == counts


def test_strided_views_of_fused_qkv_backward():
    """Gradients through views of one [B,S,3,H,D] projection equal those
    through contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(
        rng.standard_normal((2, 32, 3, 2, 16), dtype=np.float32)
    ).requires_grad_(True)
    flash_attention(*qkv.unbind(dim=2), causal=True).pow(2).sum().backward()
    parts = [x.detach().contiguous().requires_grad_(True)
             for x in qkv.unbind(dim=2)]
    flash_attention(*parts, causal=True).pow(2).sum().backward()
    torch.testing.assert_close(
        qkv.grad, torch.stack([p.grad for p in parts], dim=2),
        rtol=0, atol=0,
    )


# ----------------------------------------------------------- whole slice

B, S = 2, 32


def _ids(seed, vocab=1024, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


def _assert_grads_close(model, jax_grads, cfg):
    want = params_from_flax(_numpy_tree(jax_grads), cfg)
    got = {n: p.grad for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **GRAD_TOL["float32"])


def test_classifier_parameter_gradients_match_jax():
    kw = dict(attention_impl="flash", dropout_rate=0.0)
    jcfg = jt.tiny_transformer(dtype=jnp.float32, **kw)
    tcfg = tt.tiny_transformer(dtype=torch.float32, **kw)
    ids, seg = _ids(0), _ids(1, vocab=2)
    labels = np.array([0, 1], np.int32)
    jmodel = jt.SequenceClassifier(jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(ids),
                                  jnp.asarray(seg)))["params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids),
                              jnp.asarray(seg))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(labels)).mean()

    jax_grads = jax.grad(loss)(params)
    model = tt.SequenceClassifier(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(_numpy_tree(params), tcfg))
    logits = model(torch.from_numpy(ids).long(), torch.from_numpy(seg).long())
    F.cross_entropy(logits, torch.from_numpy(labels).long()).backward()
    _assert_grads_close(model, jax_grads, tcfg)


def test_causal_lm_parameter_gradients_match_jax():
    kw = dict(attention_impl="flash", dropout_rate=0.0, causal=True)
    jcfg = jt.tiny_transformer(dtype=jnp.float32, **kw)
    tcfg = tt.tiny_transformer(dtype=torch.float32, **kw)
    ids = _ids(2)
    jmodel = jt.CausalLM(jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(1),
                                  jnp.asarray(ids)))["params"]

    def loss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(ids))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits[:, :-1], jnp.asarray(ids)[:, 1:]).mean()

    jax_grads = jax.grad(loss)(params)
    model = tt.CausalLM(tcfg, device="cpu")
    model.load_state_dict(params_from_flax(_numpy_tree(params), tcfg))
    logits = model(torch.from_numpy(ids).long())
    F.cross_entropy(logits[:, :-1].reshape(-1, tcfg.vocab_size),
                    torch.from_numpy(ids[:, 1:]).long().reshape(-1)).backward()
    _assert_grads_close(model, jax_grads, tcfg)


def test_build_key_covers_sources_and_shared_headers(tmp_path, monkeypatch):
    """An edited ``.cuh`` must change every library's build key, or a
    stale library would be loaded (the build itself runs on the card)."""
    from raydp_tpu_torch.ops import _build

    assert set(_build.SOURCES) == {"flash_fwd.cu", "flash_bwd.cu"}
    for name in ("a.cu", "b.cu", "common.cuh"):
        (tmp_path / name).write_text(f"// {name}\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    before = {src: _build._target(src) for src in ("a.cu", "b.cu")}
    (tmp_path / "common.cuh").write_text("// edited\n")
    after = {src: _build._target(src) for src in ("a.cu", "b.cu")}
    assert all(before[s] != after[s] for s in before)
    (tmp_path / "a.cu").write_text("// a edited\n")
    assert _build._target("a.cu") != after["a.cu"]
    assert _build._target("b.cu") == after["b.cu"]
