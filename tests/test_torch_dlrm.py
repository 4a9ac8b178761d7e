"""The port's DLRM against the JAX package's (``raydp_tpu/models/dlrm.py``).

The same numpy inputs and the same (converted) flax parameters go through
both, on the CPU, in float32: ``ShardedEmbedding`` by ``take`` and by
``onehot``, for one id and for bags pooled by sum and by mean;
``DotInteraction``'s lower triangle; ``DLRM`` and ``PackedDLRM`` forwards
and gradients with either lookup; ``PackedDLRM`` fit by ``Estimator``
against ``JAXEstimator``. The JAX package's sharded-table cases wait for
the multi-GPU slice (one card holds every table whole).

Bounds: the JAX package's (ROADMAP north star): forward rtol 2e-4 / atol
2e-5, gradients 1e-3 / 1e-4, estimator histories rtol 1e-4.
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
from raydp_tpu.models import dlrm as jd
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import dlrm as td
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.train import Estimator

FWD = dict(rtol=2e-4, atol=2e-5)
GRAD = dict(rtol=1e-3, atol=1e-4)
RTOL = 1e-4


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


def _load(module, params):
    module.load_state_dict(params_from_flax(_numpy_tree(params)),
                           strict=True)
    return module


def _batch(cfg, b=16, seed=0, bag=None):
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((b, cfg.dense_features)).astype(np.float32)
    sparse = np.stack(
        [rng.integers(0, v, size=(b,) if bag is None else (b, bag))
         for v in cfg.vocab_sizes], axis=1).astype(np.int32)
    return dense, sparse


@pytest.mark.parametrize("impl", ["take", "onehot"])
@pytest.mark.parametrize("pooling,bag", [("sum", None), ("sum", 3),
                                         ("mean", 3)])
def test_embedding_matches_jax(impl, pooling, bag):
    ids = np.random.default_rng(1).integers(
        0, 50, size=(6,) if bag is None else (6, bag)).astype(np.int32)
    kw = dict(vocab_size=50, embed_dim=8, impl=impl, pooling=pooling)
    jemb = jd.ShardedEmbedding(dtype=jnp.float32, **kw)
    params = nn.unbox(jemb.init(jax.random.PRNGKey(1), jnp.asarray(ids)))
    want = jemb.apply(params, jnp.asarray(ids))
    temb = _load(td.ShardedEmbedding(dtype=torch.float32, **kw),
                 params["params"])
    got = temb(torch.from_numpy(ids).long())
    assert got.shape == (6, 8)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)


def test_onehot_matches_take_and_pools_bags():
    """The two lookups agree, and a bag pools its rows (the JAX package's
    own checks, tests/test_dlrm.py)."""
    take = td.ShardedEmbedding(30, 4, impl="take", dtype=torch.float32)
    onehot = td.ShardedEmbedding(30, 4, impl="onehot", pooling="mean",
                                 dtype=torch.float32)
    onehot.load_state_dict(take.state_dict())
    bags = torch.tensor([[1, 2, 3], [4, 4, 4]])
    table = take.table.detach()
    torch.testing.assert_close(take(bags)[0], table[1] + table[2] + table[3])
    torch.testing.assert_close(onehot(bags)[0],
                               (table[1] + table[2] + table[3]) / 3)
    ids = torch.tensor([3, 11, 29, 0])
    onehot.pooling = "sum"
    torch.testing.assert_close(take(ids), onehot(ids))


def test_dot_interaction_takes_numpy_lower_triangle():
    feats = np.random.default_rng(2).standard_normal((3, 5, 4)).astype(
        np.float32)
    want = jd.DotInteraction().apply({}, jnp.asarray(feats))
    got = td.DotInteraction()(torch.from_numpy(feats))
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


@pytest.mark.parametrize("impl", ["take", "onehot"])
@pytest.mark.parametrize("interaction", ["dot", "cat"])
def test_dlrm_forward_and_grads_match_jax(impl, interaction):
    jcfg = jd.tiny_dlrm(dtype=jnp.float32, embedding_impl=impl,
                        interaction=interaction)
    tcfg = td.tiny_dlrm(dtype=torch.float32, embedding_impl=impl,
                        interaction=interaction)
    dense, sparse = _batch(jcfg)
    w = np.random.default_rng(3).standard_normal(16).astype(np.float32)
    jmodel = jd.DLRM(jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                                  jnp.asarray(sparse)))["params"]

    def loss(p):
        out = jmodel.apply({"params": p}, jnp.asarray(dense),
                           jnp.asarray(sparse))
        return jnp.sum(out * w), out

    jgrads, want = jax.jit(jax.grad(loss, has_aux=True))(params)
    tmodel = _load(td.DLRM(tcfg, device="cpu"), params)
    got = tmodel(torch.from_numpy(dense), torch.from_numpy(sparse).long())
    assert got.shape == (16,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **FWD)
    torch.sum(got * torch.from_numpy(w)).backward()
    want_g = params_from_flax(_numpy_tree(jgrads))
    got_g = {n: p.grad for n, p in tmodel.named_parameters()}
    assert set(got_g) == set(want_g)
    for name, g in want_g.items():
        np.testing.assert_allclose(got_g[name].numpy(), g.numpy(),
                                   err_msg=name, **GRAD)


def test_auto_resolves_to_take_on_one_card():
    cfg = td.criteo_dlrm()
    assert cfg.embedding_impl == "auto"
    assert {cfg.impl_for(v) for v in cfg.vocab_sizes} == {"take"}
    assert td.tiny_dlrm(embedding_impl="onehot").impl_for(64) == "onehot"


def test_bottom_width_must_equal_embed_dim():
    with pytest.raises(ValueError, match="embed_dim"):
        td.DLRM(td.tiny_dlrm(bottom_mlp=(32, 8)), device="cpu")


def _ctr_columns(cfg, n, seed):
    """Packed float columns and a label that depends on dense[:, 0] and
    whether the first id is even (tests/test_dlrm.py's task)."""
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, cfg.dense_features)).astype(np.float32)
    sparse = np.stack([rng.integers(0, v, size=n) for v in cfg.vocab_sizes],
                      axis=1).astype(np.float32)
    y = ((dense[:, 0] + (sparse[:, 0] % 2) - 0.5) > 0).astype(np.float32)
    x = np.concatenate([dense, sparse], axis=1)
    names = [f"d{i}" for i in range(cfg.dense_features)] + [
        f"c{i}" for i in range(cfg.n_tables)]
    cols = {name: x[:, i] for i, name in enumerate(names)}
    cols["label"] = y
    return x, names, cols


@pytest.mark.parametrize("impl", ["take", "onehot"])
def test_packed_dlrm_fit_matches_jax(impl):
    """``PackedDLRM`` through ``Estimator`` against ``JAXEstimator`` from
    the same initial parameters: losses, eval metrics, predictions."""
    jcfg = jd.tiny_dlrm(dtype=jnp.float32, embedding_impl=impl)
    tcfg = td.tiny_dlrm(dtype=torch.float32, embedding_impl=impl)
    x, names, cols = _ctr_columns(jcfg, 256, seed=0)
    jmodel = jd.PackedDLRM(jcfg)
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0),
                                  jnp.asarray(x[:1])))["params"]
    tmodel = _load(td.PackedDLRM(tcfg, device="cpu"), params)
    kw = dict(loss="bce", metrics=["accuracy"], num_epochs=3, batch_size=64,
              feature_columns=names, label_column="label", seed=0,
              epoch_mode="stream")
    jest = JAXEstimator(model=jmodel, optimizer=optax.adam(1e-2), **kw)
    test = Estimator(model=tmodel,
                     optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                     device="cpu", **kw)
    table = pa.table(cols)
    jhist = jest.fit(JaxMLDataset([table], 1),
                     evaluate_ds=JaxMLDataset([table], 1))
    thist = test.fit(MLDataset([cols], 1), evaluate_ds=MLDataset([cols], 1))
    for j, t in zip(jhist, thist):
        for k in ("train_loss", "eval_loss", "eval_accuracy"):
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    assert thist[-1]["train_loss"] < thist[0]["train_loss"] * 0.9
    np.testing.assert_allclose(test.predict(x[:50]), jest.predict(x[:50]),
                               rtol=RTOL, atol=1e-5)


def test_dlrm_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.PackedDLRM(td.tiny_dlrm())
