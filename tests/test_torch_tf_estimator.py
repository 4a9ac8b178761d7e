"""The port's keras wire-format estimator against the JAX package's
(``raydp_tpu/train/tf_estimator.py``).

* Every keras optimizer: the first 3 updates of ``parse_keras_optimizer``'s
  torch optimizer against those of the JAX package's optax transform, on
  the same parameters and gradients (adam, adamw, sgd with and without
  momentum, rmsprop, adagrad).
* ``KerasSequential``: the forward of a model with every supported layer
  from converted flax parameters, with the flax parameter names.
* ``TFEstimator`` fits against the JAX ``TFEstimator``'s from the same
  initial parameters: a regression tower, the fused sigmoid head and the
  fused softmax head (int labels), each history within rtol 1e-4.
* The errors: unsupported layer, loss, optimizer and metric, the layer
  error also through ``fit_on_df``.

Tolerances: optimizer updates rtol 1e-5 / atol 1e-7 (float32, the same
arithmetic in another order); forwards rtol 2e-4 / atol 2e-5; histories
rtol 1e-4 and predictions rtol 1e-4 / atol 1e-5, as
``tests/test_torch_train.py``.
"""
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.train import tf_estimator as jtf
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.train import tf_estimator as ttf

RTOL = 1e-4
FWD = dict(rtol=2e-4, atol=2e-5)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


def _keras_json(layers):
    return json.dumps({"class_name": "Sequential",
                       "config": {"name": "m", "layers": layers}})


def _dense(units, activation="linear", name=None):
    return {"class_name": "Dense",
            "config": {"units": units, "activation": activation,
                       "name": name}}


OPTIMIZERS = {
    "adam": {"class_name": "Adam",
             "config": {"learning_rate": 0.01, "beta_1": 0.8,
                        "beta_2": 0.99}},
    "adamw": {"class_name": "AdamW",
              "config": {"learning_rate": 0.01, "weight_decay": 0.1}},
    "sgd": "sgd",
    "sgd_momentum": {"class_name": "SGD",
                     "config": {"learning_rate": 0.1, "momentum": 0.9}},
    "rmsprop": {"class_name": "RMSprop",
                "config": {"learning_rate": 0.01, "rho": 0.8}},
    "adagrad": {"class_name": "Adagrad", "config": {"learning_rate": 0.1}},
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizer_updates_match_optax(name):
    spec = OPTIMIZERS[name]
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal(3).astype(np.float32)}
    # Small gradients too, where eps inside or outside the root differs.
    grads = [{k: (rng.standard_normal(v.shape) * scale).astype(np.float32)
              for k, v in params.items()} for scale in (1.0, 1e-4, 0.3)]
    tx = jtf.parse_keras_optimizer(spec)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
               for k, v in params.items()}
    opt = ttf.parse_keras_optimizer(spec)(list(tparams.values()))
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, p in tparams.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        for k, p in tparams.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jparams[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name} {k}")


def test_default_and_unknown_optimizers():
    assert isinstance(ttf.parse_keras_optimizer(None)(
        [torch.nn.Parameter(torch.zeros(1))]), torch.optim.Adam)
    with pytest.raises(ValueError, match="unsupported keras optimizer"):
        ttf.parse_keras_optimizer("ftrl")
    assert ttf.parse_keras_model(_keras_json([_dense(4, "relu")]))[0][
        "class_name"] == "Dense"


ALL_LAYERS = [
    {"class_name": "InputLayer", "config": {"batch_input_shape": [None, 2, 3]}},
    {"class_name": "Flatten", "config": {}},
    _dense(16, "relu", name="hidden"),
    {"class_name": "BatchNormalization", "config": {}},
    _dense(8, "gelu"),
    {"class_name": "LayerNormalization", "config": {"name": "norm"}},
    _dense(8),
    {"class_name": "Activation", "config": {"activation": "tanh"}},
    {"class_name": "Dropout", "config": {"rate": 0.5}},
    _dense(4, "softmax"),
]


def test_keras_sequential_forward_matches_jax():
    x = np.random.default_rng(1).standard_normal((5, 2, 3)).astype(np.float32)
    jmodel = jtf.KerasSequential(layer_configs=tuple(ALL_LAYERS))
    params = nn.unbox(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x)))[
        "params"]
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    tmodel = ttf.KerasSequential(ALL_LAYERS, (2, 3), device="cpu").eval()
    tmodel.load_state_dict(params_from_flax(_numpy_tree(params)), strict=True)
    assert {"hidden.weight", "layers.0.weight", "layers.1.weight",
            "layers.2.weight", "norm.weight",
            "LayerNorm_0.weight"} <= set(tmodel.state_dict())
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD)


def _fit_both(layers, cols, features, x, **kw):
    """The JAX and the port TFEstimator over the same rows, both from the
    JAX estimator's initial parameters (``init(PRNGKey(seed), x[:1])``)."""
    kw = dict(feature_columns=features, seed=0, epoch_mode="stream", **kw)
    jest = jtf.TFEstimator(model=layers, **kw)
    test = ttf.TFEstimator(model=layers, device="cpu", **kw)
    assert test.layer_configs == jest.layer_configs
    params = jtf.KerasSequential(layer_configs=jest.layer_configs).init(
        jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    test.get_model().load_state_dict(params_from_flax(_numpy_tree(params)),
                                     strict=True)
    table = pa.table(cols)
    jhist = jest.fit(JaxMLDataset([table], 1),
                     evaluate_ds=JaxMLDataset([table], 1))
    thist = test.fit(MLDataset([cols], 1), evaluate_ds=MLDataset([cols], 1))
    assert len(jhist) == len(thist)
    for j, t in zip(jhist, thist):
        assert t["samples"] == j["samples"]
        for k in j:
            if k.startswith(("train_loss", "eval_")):
                np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(test.predict(x[:40]), jest.predict(x[:40]),
                               rtol=RTOL, atol=1e-5)
    return jest, test, thist


def test_regression_tower_fit_matches_jax():
    """The taxi example's tower (Dense + BatchNormalization, keras JSON),
    Adam, mean_squared_error with an mae metric."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((512, 4)).astype(np.float32)
    y = (2 * x[:, 0] - 3 * x[:, 1] + x[:, 2] * x[:, 3] + 1).astype(
        np.float32)
    cols = {f"f{i}": x[:, i] for i in range(4)}
    cols["y"] = y
    layers = []
    for units in (32, 16):
        layers += [_dense(units, "relu"),
                   {"class_name": "BatchNormalization", "config": {}}]
    layers.append(_dense(1))
    _, test, hist = _fit_both(
        _keras_json(layers), cols, [f"f{i}" for i in range(4)], x,
        optimizer={"class_name": "Adam", "config": {"learning_rate": 0.01}},
        loss="mean_squared_error", metrics=["mae"], label_column="y",
        batch_size=64, num_epochs=3)
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    # predict is the returned module's forward.
    module = test.get_model().eval()
    with torch.no_grad():
        want = module(torch.from_numpy(x[:7])).numpy()
    np.testing.assert_allclose(test.predict(x[:7]), want, rtol=1e-6)


def test_binary_head_fuses_sigmoid_and_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((512, 2)).astype(np.float32)
    cols = {"x1": x[:, 0], "x2": x[:, 1],
            "label": (x[:, 0] - x[:, 1] > 0).astype(np.float32)}
    jest, test, hist = _fit_both(
        [_dense(16, "relu"), _dense(1, "sigmoid")], cols, ["x1", "x2"], x,
        optimizer={"class_name": "RMSprop",
                   "config": {"learning_rate": 0.01}},
        loss="binary_crossentropy", metrics=["accuracy"],
        label_column="label", batch_size=64, num_epochs=3)
    assert test.layer_configs[-1]["config"]["activation"] == "linear"
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert hist[-1]["eval_accuracy"] > 0.85


def test_softmax_head_fuses_with_int_labels_and_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((384, 4)).astype(np.float32)
    cols = {f"f{i}": x[:, i] for i in range(4)}
    cols["label"] = np.argmax(x[:, :3], axis=1).astype(np.int64)
    layers = [_dense(32, "relu"), _dense(3),
              {"class_name": "Activation", "config": {"activation": "softmax"}}]
    _, test, hist = _fit_both(
        layers, cols, [f"f{i}" for i in range(4)], x,
        optimizer={"class_name": "SGD",
                   "config": {"learning_rate": 0.1, "momentum": 0.9}},
        loss="sparse_categorical_crossentropy",
        metrics=["sparse_categorical_accuracy"], label_column="label",
        batch_size=64, num_epochs=3)
    assert [c["class_name"] for c in test.layer_configs] == ["Dense", "Dense"]
    assert test._estimator_kw["label_dtype"] == np.int32
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]


def test_dropout_model_trains_and_saves(tmp_path):
    """Port only (JAX's dropout bits cannot be reproduced): a Dropout
    layer trains; save and restore give the same predictions; the history
    survives shutdown."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((256, 3)).astype(np.float32)
    cols = {f"f{i}": x[:, i] for i in range(3)}
    cols["y"] = (x @ np.array([1.0, -2.0, 0.5], np.float32)).astype(
        np.float32)
    layers = [_dense(16, "relu"),
              {"class_name": "Dropout", "config": {"rate": 0.1}}, _dense(1)]
    kw = dict(model=layers, optimizer="adagrad", loss="mse",
              feature_columns=["f0", "f1", "f2"], label_column="y",
              batch_size=32, num_epochs=4, device="cpu")
    est = ttf.TFEstimator(**kw)
    hist = est.fit(MLDataset([cols], 1))
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    path = str(tmp_path / "ck")
    est.save(path)
    again = ttf.TFEstimator(**kw)
    again.restore(path)
    np.testing.assert_allclose(again.predict(x[:9]), est.predict(x[:9]),
                               rtol=1e-6)
    est.shutdown()
    assert est.history == hist


def test_unsupported_layer_loss_metric_and_df_raise():
    with pytest.raises(ValueError, match="unsupported keras loss"):
        ttf.TFEstimator(model=[_dense(1)], loss="poisson",
                        feature_columns=["a"], label_column="y",
                        device="cpu")
    with pytest.raises(ValueError, match="unsupported keras metrics"):
        ttf.TFEstimator(model=[_dense(1)], metrics=["auc"],
                        feature_columns=["a"], label_column="y",
                        device="cpu")
    est = ttf.TFEstimator(
        model=[{"class_name": "Conv2D", "config": {"filters": 3}}],
        loss="mse", feature_columns=["a"], label_column="y", device="cpu")
    cols = {"a": np.array([1.0, 2.0], np.float32),
            "y": np.array([0.0, 1.0], np.float32)}
    with pytest.raises(ValueError, match="unsupported keras layer"):
        est.fit(MLDataset([cols], 1))
    df = torch_rdf.from_items([{"a": 1.0, "y": 0.0}, {"a": 2.0, "y": 1.0}])
    with pytest.raises(ValueError, match="unsupported keras layer"):
        est.fit_on_df(df)
    with pytest.raises(ValueError, match="Sequential"):
        ttf.parse_keras_model({"class_name": "Model"})


def test_tf_estimator_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttf.TFEstimator(model=[_dense(1)])
