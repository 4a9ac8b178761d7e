"""The port's transformer family against the JAX package's, from the same
parameters.

Flax parameters of ``tiny_transformer`` are initialised once, turned into
numpy and carried over with ``params_from_flax``. Token ids come from
numpy with a fixed seed. JAX runs on the CPU (flash in interpret mode,
which ``MultiHeadAttention`` picks there); the port runs with
``device="cpu"`` (flash through its plain version). Tolerances: f32
rtol/atol 1e-4 (the same f32 arithmetic in another order, through two
layers); bf16 2e-2 (bf16 rounds at other places in the two frameworks).
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models import transformer as jt
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax

B, S = 2, 32
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _ids(seed=0, vocab=1024, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _numpy_tree(variables):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(variables)["params"])


@pytest.fixture(scope="module")
def classifier_params():
    cfg = jt.tiny_transformer(dtype=jnp.float32)
    ids = jnp.asarray(_ids())
    return _numpy_tree(jt.SequenceClassifier(cfg).init(
        jax.random.PRNGKey(0), ids, jnp.zeros_like(ids)
    ))


@pytest.fixture(scope="module")
def lm_params():
    cfg = jt.tiny_transformer(causal=True, dtype=jnp.float32)
    return _numpy_tree(jt.CausalLM(cfg).init(
        jax.random.PRNGKey(1), jnp.asarray(_ids())
    ))


def _configs(dtype, **kw):
    return (jt.tiny_transformer(dtype=getattr(jnp, dtype), **kw),
            tt.tiny_transformer(dtype=getattr(torch, dtype), **kw))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        np.asarray(got.float()), np.asarray(want, dtype=np.float32),
        **TOL[dtype],
    )


def test_state_dict_covers_every_parameter(classifier_params, lm_params):
    _, tcfg = _configs("float32")
    clf = tt.SequenceClassifier(tcfg, device="cpu")
    sd = params_from_flax(classifier_params, tcfg)
    assert set(sd) == set(clf.state_dict())
    for name, t in clf.state_dict().items():
        assert sd[name].shape == t.shape, name
    _, lcfg = _configs("float32", causal=True)
    lm = tt.CausalLM(lcfg, device="cpu")
    assert set(params_from_flax(lm_params, lcfg)) == set(lm.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_classifier_logits_match_jax(classifier_params, impl, dtype):
    jcfg, tcfg = _configs(dtype, attention_impl=impl)
    ids, seg = _ids(), _ids(seed=1, vocab=2)
    want = jt.SequenceClassifier(jcfg).apply(
        {"params": classifier_params}, jnp.asarray(ids), jnp.asarray(seg)
    )
    model = tt.SequenceClassifier(tcfg, device="cpu").eval()
    model.load_state_dict(params_from_flax(classifier_params, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(),
                    torch.from_numpy(seg).long())
    assert got.dtype == torch.float32 and got.shape == (B, 2)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_causal_lm_logits_match_jax(lm_params, impl, dtype):
    jcfg, tcfg = _configs(dtype, attention_impl=impl, causal=True)
    ids = _ids(seed=2)
    want = jt.CausalLM(jcfg).apply({"params": lm_params}, jnp.asarray(ids))
    model = tt.CausalLM(tcfg, device="cpu").eval()
    model.load_state_dict(params_from_flax(lm_params, tcfg))
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long())
    assert got.shape == (B, S, tcfg.vocab_size)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_step_match_jax(lm_params, dtype):
    jcfg, tcfg = _configs(dtype, causal=True)
    jm = jt.CausalLM(jcfg)
    tm = tt.CausalLM(tcfg, device="cpu").eval()
    tm.load_state_dict(params_from_flax(lm_params, tcfg))

    ids = _ids(seed=3)
    lengths = np.array([5, 27], np.int32)  # right-padded, ragged prompts
    j_logits, varied = jm.apply(
        {"params": lm_params}, jnp.asarray(ids), jnp.asarray(lengths),
        method=jt.CausalLM.prefill, mutable=["cache"],
    )
    cache = tm.init_cache(B)
    with torch.no_grad():
        t_logits = tm.prefill(torch.from_numpy(ids).long(),
                              torch.from_numpy(lengths).long(), cache)
    _close(t_logits, j_logits, dtype)
    # Cache rows of every layer in f32. In bf16 only layer 0's: deeper
    # layers' K/V are bf16 products of inputs that already differ by an
    # ulp, a few of which land past 2e-2; the logits above carry them.
    layers = len(cache) if dtype == "float32" else 1
    for i, (ck, cv) in enumerate(cache[:layers]):
        j_attn = varied["cache"]["encoder"][f"block_{i}"]["attn"]
        _close(ck[:, :S], j_attn["cached_key"][:, :S], dtype)
        _close(cv[:, :S], j_attn["cached_value"][:, :S], dtype)

    # One step per slot at its own (ragged) cache length.
    tokens = _ids(seed=4, shape=(B, 1))
    kv_len = 32
    j_step, varied2 = jm.apply(
        {"params": lm_params, "cache": varied["cache"]},
        jnp.asarray(tokens), jnp.asarray(lengths), kv_len,
        method=jt.CausalLM.decode_step, mutable=["cache"],
    )
    positions = torch.from_numpy(lengths).long()
    with torch.no_grad():
        t_step = tm.decode_step(torch.from_numpy(tokens).long(), positions,
                                kv_len, cache)
    assert t_step.shape == (B, tcfg.vocab_size)
    _close(t_step, j_step, dtype)
    rows = np.arange(B)
    for i, (ck, _) in enumerate(cache[:layers]):
        j_key = varied2["cache"]["encoder"][f"block_{i}"]["attn"]["cached_key"]
        _close(ck[rows, lengths], np.asarray(j_key)[rows, lengths], dtype)


def test_config_rejects_unported_attention():
    with pytest.raises(ValueError, match="attention_impl"):
        tt.tiny_transformer(attention_impl="ring")


def test_models_raise_without_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.SequenceClassifier(tt.tiny_transformer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tt.CausalLM(tt.tiny_transformer(causal=True))
