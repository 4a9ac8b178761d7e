"""Block rematerialisation (``TransformerConfig.remat``) in the port.

* With dropout 0.1 and one generator seed, the gradients with remat equal
  those without (rtol 1e-5, float32): the recomputed blocks apply the
  forward's dropout masks, and the generator ends where it would have.
* Against the JAX package's ``remat=True`` at dropout 0, the classifier's
  and the causal LM's gradients, by the f32 gradient bound (rtol 1e-3 /
  atol 1e-4), dense and flash attention.
* An ``Estimator`` fit with remat reproduces the fit without it, on both
  epoch paths (on the CPU the scan step runs eagerly; the card tests hold
  remat inside the captured step).
* A decode cache with remat raises, as in JAX.
"""
import dataclasses

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raydp_tpu.models import transformer as jt
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.dropout import set_dropout_generator
from raydp_tpu_torch.train import Estimator

GRAD = dict(rtol=1e-3, atol=1e-4)
SAME = dict(rtol=1e-5, atol=1e-7)
TINY = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=3, d_ff=64,
            max_len=16)


def _ids(seed, shape=(4, 16), vocab=64):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


def _grads(model, ids, seed, steps=2):
    """Gradients of the last of ``steps`` forward-backward passes in
    training mode, dropout drawn from a generator seeded ``seed``; and
    that generator's final state."""
    gen = torch.Generator().manual_seed(seed)
    set_dropout_generator(model, gen)
    model.train()
    x = torch.from_numpy(ids).long()
    for _ in range(steps):
        model.zero_grad(set_to_none=True)
        out = model(x)
        loss = (out.float() ** 2).mean()
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return float(loss.detach()), grads, gen.get_state()


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["classifier", "causal_lm"])
def test_remat_reproduces_dropout_masks(kind, impl):
    cfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.1,
                              attention_impl=impl,
                              causal=kind == "causal_lm", **TINY)
    runs = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        cls = tt.SequenceClassifier if kind == "classifier" else tt.CausalLM
        model = cls(c, device="cpu",
                    generator=torch.Generator().manual_seed(3))
        runs[remat] = _grads(model, _ids(1), seed=11)
    (l0, g0, s0), (l1, g1, s1) = runs[False], runs[True]
    assert l0 == l1
    assert torch.equal(s0, s1)        # the generator advanced alike
    assert g0.keys() == g1.keys()
    for name in g0:
        torch.testing.assert_close(g1[name], g0[name], **SAME, msg=name)


def test_remat_masks_differ_from_fresh_draws():
    """The check above has teeth: a recompute drawing fresh masks would
    give other gradients. Two forwards from one seed agree; from
    generators one draw apart they do not."""
    cfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.1,
                              remat=True, **TINY)
    model = tt.SequenceClassifier(cfg, device="cpu")
    _, a, _ = _grads(model, _ids(1), seed=11, steps=1)
    _, b, _ = _grads(model, _ids(1), seed=12, steps=1)
    assert any(not torch.allclose(a[n], b[n]) for n in a)


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("kind", ["classifier", "causal_lm"])
def test_remat_grads_match_jax_remat(kind, impl):
    causal = kind == "causal_lm"
    jcfg = jt.tiny_transformer(dtype=jnp.float32, dropout_rate=0.0,
                               attention_impl=impl, causal=causal,
                               remat=True, **TINY)
    tcfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.0,
                               attention_impl=impl, causal=causal,
                               remat=True, **TINY)
    ids = _ids(2)
    jmodel = (jt.CausalLM if causal else jt.SequenceClassifier)(jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(ids)))["params"]

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(ids),
                           deterministic=False)
        return jnp.mean(out.astype(jnp.float32) ** 2)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
    tmodel = (tt.CausalLM if causal else tt.SequenceClassifier)(
        tcfg, device="cpu")
    # flax creates the classifier's segment table only when called with
    # segment ids; the rest loads strictly.
    missing, unexpected = tmodel.load_state_dict(params_from_flax(
        jax.tree_util.tree_map(np.asarray, params), tcfg), strict=False)
    assert set(missing) <= {"encoder.seg_embed.weight"} and not unexpected
    tloss, tgrads, _ = _grads(tmodel, ids, seed=0, steps=1)
    np.testing.assert_allclose(tloss, float(jloss), rtol=2e-4)
    want = params_from_flax(jax.tree_util.tree_map(np.asarray, jgrads), tcfg)
    assert set(want) <= set(tgrads)
    for name, w in want.items():
        np.testing.assert_allclose(tgrads[name].numpy(), w.numpy(),
                                   err_msg=name, **GRAD)


def _token_cols(n, seq=16, vocab=64, seed=4):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return cols


@pytest.mark.parametrize("mode", ["stream", "scan"])
def test_estimator_fit_with_remat_reproduces_the_fit_without(mode):
    cols = _token_cols(48)
    hists, params = {}, {}
    for remat in (False, True):
        cfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.1,
                                  attention_impl="flash", remat=remat,
                                  **TINY)
        est = Estimator(
            model=tt.SequenceClassifier(
                cfg, device="cpu", generator=torch.Generator().manual_seed(5)),
            optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3),
            loss="softmax_ce", num_epochs=2, batch_size=16,
            feature_columns=[f"t{i}" for i in range(16)],
            label_column="label", feature_dtype=np.int32,
            label_dtype=np.int32, seed=0, epoch_mode=mode, device="cpu")
        hists[remat] = [h["train_loss"] for h in
                        est.fit(MLDataset([cols], 1))]
        params[remat] = est.get_model().state_dict()
    np.testing.assert_allclose(hists[True], hists[False], rtol=1e-5)
    for name, p in params[False].items():
        torch.testing.assert_close(params[True][name], p, **SAME, msg=name)


def test_eval_forward_with_remat_is_the_plain_forward():
    cfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.1, **TINY)
    plain = tt.SequenceClassifier(cfg, device="cpu").eval()
    remat = tt.SequenceClassifier(dataclasses.replace(cfg, remat=True),
                                  device="cpu").eval()
    remat.load_state_dict(plain.state_dict())
    x = torch.from_numpy(_ids(3)).long()
    torch.testing.assert_close(remat(x), plain(x), rtol=0, atol=0)


def test_decode_cache_is_incompatible_with_remat():
    cfg = tt.tiny_transformer(dtype=torch.float32, causal=True, remat=True,
                              **TINY)
    lm = tt.CausalLM(cfg, device="cpu").eval()
    cache = lm.init_cache(2)
    ids = torch.from_numpy(_ids(4, shape=(2, 8))).long()
    with pytest.raises(ValueError, match="decode cache is incompatible "
                                         "with remat"):
        lm.prefill(ids, torch.tensor([8, 5]), cache)
    with pytest.raises(ValueError, match="incompatible with remat"):
        lm.decode_step(ids[:, :1], torch.tensor([3, 4]), 8, cache)
