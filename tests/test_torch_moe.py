"""The port's MoE against the JAX package's (``raydp_tpu/models/moe.py``).

The same numpy inputs and the same (converted) flax parameters go through
both, on the CPU, in float32:

* ``MoELayer`` outputs, the Switch aux loss and parameter gradients, with
  ample capacity, with tokens dropped for capacity (in the first round
  and in the second) and with one expert;
* top-k conservation and capacity drops on the port alone, as the JAX
  package's own tests check them (``tests/test_moe.py``);
* ``MoEBlock`` and ``MoEClassifier`` forwards and gradients, and the
  classifier fit by ``Estimator(aux_losses=True)`` against
  ``JAXEstimator(aux_losses=True)`` on the flash trunk.

Bounds: the JAX package's (ROADMAP north star): forward rtol 2e-4 / atol
2e-5; gradients and the aux loss 1e-3 / 1e-4; estimator histories rtol
1e-4 and parameters as ``tests/test_torch_train.py`` holds them.
"""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import moe as jm
from raydp_tpu.models import transformer as jt
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import moe as tm
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.train import Estimator

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


def _tokens(t, d, seed):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(
        np.float32)


def _load(module, params, cfg=None):
    """Load converted flax ``params`` with every name present, none extra."""
    module.load_state_dict(params_from_flax(_numpy_tree(params), cfg),
                           strict=True)
    return module


def _jax_run(apply, params, x, w):
    """The JAX output, aux loss and gradients, from one compiled call."""
    def loss(p):
        out, state = apply({"params": p}, x, mutable=["losses"])
        return jnp.sum(out * w) + jm.moe_aux_loss(state), (out, state)

    grads, (out, state) = jax.jit(jax.grad(loss, has_aux=True))(params)
    return out, float(jm.moe_aux_loss(state)), grads


def _assert_grads_close(module, jgrads, cfg=None):
    want = params_from_flax(_numpy_tree(jgrads), cfg)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   err_msg=name, **GRAD)


LAYER_CASES = {
    "ample": dict(n_experts=4, top_k=2, capacity_factor=2.0),
    "one_expert": dict(n_experts=1, top_k=1, capacity_factor=1.0),
    "drops_first_round": dict(n_experts=2, top_k=1, capacity_factor=1e-6),
    "drops_second_round": dict(n_experts=4, top_k=2, capacity_factor=0.5),
}


@pytest.mark.parametrize("case", list(LAYER_CASES))
def test_moe_layer_matches_jax(case):
    cfg_j = jm.tiny_moe(**LAYER_CASES[case])
    cfg_t = tm.tiny_moe(**LAYER_CASES[case])
    x = _tokens(24, cfg_j.d_model, seed=1)
    w = _tokens(24, cfg_j.d_model, seed=2)
    layer = jm.MoELayer(cfg_j)
    params = nn.unbox(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))[
        "params"]
    want, aux, jgrads = _jax_run(layer.apply, params, jnp.asarray(x),
                                 jnp.asarray(w))

    port = _load(tm.MoELayer(cfg_t), params)
    xt = torch.from_numpy(x)
    got = port(xt)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(float(tm.moe_aux_loss(port).detach()), aux,
                               **GRAD)
    (torch.sum(got * torch.from_numpy(w)) + tm.moe_aux_loss(port)).backward()
    _assert_grads_close(port, jgrads)


def test_capacity_drops_tokens():
    """Capacity 1 per expert: at most 2 tokens come out non-zero, the
    rest are dropped to zeros, never NaN."""
    cfg = tm.tiny_moe(n_experts=2, top_k=1, capacity_factor=1e-6)
    layer = tm.MoELayer(cfg)
    with torch.no_grad():
        out = layer(torch.from_numpy(_tokens(16, cfg.d_model, seed=2)))
    assert int((out.abs().sum(-1) > 1e-6).sum()) <= 2
    assert int(layer.kept_slots) == 2
    assert torch.isfinite(out).all()


def test_topk_dispatch_conservation():
    """Ample capacity: every token takes top_k slots, and its output is
    the gate-weighted sum of its top_k experts' FFNs."""
    cfg = tm.tiny_moe(n_experts=4, top_k=2, capacity_factor=8.0)
    layer = tm.MoELayer(cfg)
    x = torch.from_numpy(_tokens(24, cfg.d_model, seed=1))
    with torch.no_grad():
        out = layer(x)
        probs = torch.softmax(x @ layer.router.weight.T, dim=-1)
        gates, experts = torch.topk(probs, 2, dim=-1)
        want = torch.zeros_like(x)
        for k in range(2):
            e = experts[:, k]
            h = torch.nn.functional.gelu(
                torch.einsum("td,tdf->tf", x, layer.w_up[e]) + layer.b_up[e],
                approximate="tanh")
            ffn = torch.einsum("tf,tfd->td", h, layer.w_down[e]) \
                + layer.b_down[e]
            want += gates[:, k:k + 1] * ffn
    assert int(layer.kept_slots) == 24 * 2
    torch.testing.assert_close(out, want, **FWD)


def _tiny(jmod, **kw):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                max_len=16, dropout_rate=0.0)
    base.update(kw)
    return jmod.tiny_transformer(**base)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_moe_classifier_matches_jax(impl):
    """Logits, the summed aux loss and every gradient of a two-block
    classifier; MoEBlock is the classifier's block."""
    jcfg = _tiny(jt, dtype=jnp.float32, attention_impl=impl)
    tcfg = _tiny(tt, dtype=torch.float32, attention_impl=impl)
    jmoe = jm.tiny_moe(capacity_factor=1.0)
    tmoe = tm.tiny_moe(capacity_factor=1.0)
    ids = np.random.default_rng(3).integers(0, 64, (3, 16)).astype(np.int32)
    w = np.random.default_rng(4).standard_normal((3, 2)).astype(np.float32)
    jmodel = jm.MoEClassifier(cfg=jcfg, moe=jmoe, num_classes=2)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(ids)))["params"]
    want, aux, jgrads = _jax_run(jmodel.apply, params, jnp.asarray(ids),
                                 jnp.asarray(w))

    port = _load(tm.MoEClassifier(tcfg, tmoe, 2, device="cpu"), params, tcfg)
    got = port(torch.from_numpy(ids))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    np.testing.assert_allclose(float(tm.moe_aux_loss(port).detach()), aux,
                               **GRAD)
    (torch.sum(got * torch.from_numpy(w)) + tm.moe_aux_loss(port)).backward()
    _assert_grads_close(port, jgrads, tcfg)


def _marker_data(n, seq, vocab, seed):
    """Learnable rows: the label is whether token 7 appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return ids, cols


def test_moe_classifier_fit_with_aux_losses_matches_jax():
    """``Estimator(aux_losses=True)`` against ``JAXEstimator(aux_losses=
    True)`` from the same initial parameters on the flash trunk: the
    training losses (task + aux), the eval loss and metric (task only),
    predictions and the trained parameters."""
    seq = 16
    ids, cols = _marker_data(64, seq, 64, seed=5)
    jcfg = _tiny(jt, dtype=jnp.float32, attention_impl="flash")
    tcfg = _tiny(tt, dtype=torch.float32, attention_impl="flash")
    jmodel = jm.MoEClassifier(cfg=jcfg, moe=jm.tiny_moe(top_k=1),
                              num_classes=2)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(ids[:1])))["params"]
    tmodel = _load(tm.MoEClassifier(tcfg, tm.tiny_moe(top_k=1), 2,
                                    device="cpu"), params, tcfg)
    kw = dict(loss="softmax_ce", metrics=["categorical_accuracy"],
              num_epochs=2, batch_size=16,
              feature_columns=[f"t{i}" for i in range(seq)],
              label_column="label", feature_dtype=np.int32,
              label_dtype=np.int32, aux_losses=True, seed=0,
              epoch_mode="stream")
    jest = JAXEstimator(model=jmodel, optimizer=optax.adam(1e-3), **kw)
    test = Estimator(model=tmodel,
                     optimizer=lambda p: torch.optim.Adam(p, lr=1e-3),
                     device="cpu", **kw)
    table = pa.table(cols)
    jhist = jest.fit(JaxMLDataset([table], 1),
                     evaluate_ds=JaxMLDataset([table], 1))
    thist = test.fit(MLDataset([cols], 1), evaluate_ds=MLDataset([cols], 1))
    assert len(jhist) == len(thist) == 2
    for j, t in zip(jhist, thist):
        for k in ("train_loss", "eval_loss", "eval_categorical_accuracy"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    # The eval loss leaves the aux term out: the task loss alone.
    logits = test.predict(ids)
    np.testing.assert_allclose(logits, jest.predict(ids), rtol=RTOL,
                               atol=1e-5)
    task = torch.nn.functional.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(cols["label"]).long())
    np.testing.assert_allclose(test.evaluate(MLDataset([cols], 1))["loss"],
                               float(task), rtol=RTOL)
    want = params_from_flax(_numpy_tree(jest.get_model()[1]["params"]), tcfg)
    got = test.get_model().state_dict()
    assert set(got) == set(want)
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith("attn.qkv.bias"):
            # The key bias has a zero gradient in exact arithmetic; Adam
            # moves it by about lr a step in its rounding noise's sign
            # (tests/test_torch_train.py).
            k = slice(len(w) // 3, 2 * len(w) // 3)
            assert np.abs(g[k] - w[k]).max() <= 2 * 1e-3 * 8, name
            g, w = np.delete(g, np.r_[k]), np.delete(w, np.r_[k])
        np.testing.assert_allclose(g, w, err_msg=name, **PARAM_TOL)


def test_moe_aux_loss_of_a_model_without_moe_is_zero():
    model = torch.nn.Linear(2, 2)
    assert float(tm.moe_aux_loss(model)) == 0.0


def test_moe_classifier_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tm.MoEClassifier(_tiny(tt), tm.tiny_moe())
