"""The port's training path against the JAX package's.

* Every loss and metric name against the JAX function, on numpy inputs.
* ``taxi_fare_regressor`` forward from converted flax parameters.
* ``Estimator`` against ``JAXEstimator``, both on one epoch path
  (``"stream"``, whose shuffle the port copies, unless a test names
  ``"scan"``): both start from the JAX estimator's own
  initial parameters, ``model.init(PRNGKey(seed), x[:1])``, converted.
  Weight decay is set explicitly on both sides (optax's adamw default is
  1e-4, torch's AdamW 1e-2).
* The dropout repair: explicit generators make fits reproducible and
  resumable exactly (port only: JAX's dropout bits cannot be reproduced,
  so every parity fit runs with dropout off).

Tolerances: losses, metrics and predictions rtol 1e-4 (f32, the same
arithmetic in another order); parameters after training rtol 1e-4 /
atol 1e-5 (Adam's update divides by sqrt(v), which carries the gradients'
last-bit differences into the parameters at up to ~1e-6 absolute). One
exception: the attention's key bias has a gradient of exactly zero in
exact arithmetic (it shifts all of a query's scores by one constant), so
both frameworks feed Adam rounding noise there and Adam moves it by about
lr per step in the noise's sign; it is held to |difference| <= 2·lr·steps.
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
from raydp_tpu.models import mlp as jmlp
from raydp_tpu.models import transformer as jt
from raydp_tpu.train import losses as jl
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.convert import params_from_flax
from raydp_tpu_torch.models.dropout import Dropout, set_dropout_generator
from raydp_tpu_torch.models.mlp import taxi_fare_regressor
from raydp_tpu_torch.train import Estimator, TrainingCallback
from raydp_tpu_torch.train import losses as tl

RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, nn.unbox(tree))


# ------------------------------------------------------------ losses

def _loss_inputs(name, rng):
    """(preds, targets) numpy pairs that the loss or metric takes."""
    if name in ("softmax_ce", "sparse_categorical_crossentropy",
                "categorical_accuracy"):
        return (rng.standard_normal((16, 5)).astype(np.float32),
                rng.integers(0, 5, 16).astype(np.int32))
    if name == "lm_ce":
        return (rng.standard_normal((3, 8, 11)).astype(np.float32),
                rng.integers(0, 11, (3, 8)).astype(np.int32))
    if name in ("bce", "binary_crossentropy", "accuracy", "binary_accuracy"):
        return (rng.standard_normal((16, 1)).astype(np.float32) * 3,
                rng.integers(0, 2, 16).astype(np.float32))
    # Regression: predictions one rank above the targets (squeezed), with
    # differences on both sides of smooth_l1's beta.
    return (rng.standard_normal((16, 1)).astype(np.float32) * 2,
            rng.standard_normal(16).astype(np.float32))


@pytest.mark.parametrize("table,name", [("loss", n) for n in tl.LOSSES]
                         + [("metric", n) for n in tl.METRICS])
def test_losses_and_metrics_match_jax(table, name):
    assert set(tl.LOSSES) == set(jl.LOSSES)
    assert set(tl.METRICS) == set(jl.METRICS)
    resolve_t = tl.resolve_loss if table == "loss" else tl.resolve_metric
    resolve_j = jl.resolve_loss if table == "loss" else jl.resolve_metric
    preds, targets = _loss_inputs(name, np.random.default_rng(0))
    got = resolve_t(name)(torch.from_numpy(preds), torch.from_numpy(targets))
    want = resolve_j(name)(jnp.asarray(preds), jnp.asarray(targets))
    assert got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL, atol=1e-6)


def test_unknown_names_raise_like_jax():
    for resolve_t, resolve_j in ((tl.resolve_loss, jl.resolve_loss),
                                 (tl.resolve_metric, jl.resolve_metric)):
        with pytest.raises(ValueError) as got:
            resolve_t("nope")
        with pytest.raises(ValueError) as want:
            resolve_j("nope")
        assert str(got.value) == str(want.value)
    assert tl.resolve_loss(tl.mse) is tl.mse


# --------------------------------------------------------------- MLP

def test_taxi_fare_regressor_forward_matches_jax():
    x = np.random.default_rng(1).standard_normal((10, 9)).astype(np.float32)
    jmodel = jmlp.taxi_fare_regressor()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    model = taxi_fare_regressor(9, device="cpu")
    model.load_state_dict(params_from_flax(_numpy_tree(params)))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert got.shape == (10, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


# -------------------------------------------------------- estimator

N_ROWS, N_FEAT, BATCH = 300, 9, 64  # 5 batches, the last ragged (44)


def _taxi_data():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((N_ROWS, N_FEAT)).astype(np.float32)
    y = (x @ rng.standard_normal(N_FEAT) + 0.1
         * rng.standard_normal(N_ROWS)).astype(np.float32)
    cols = {f"f{i}": x[:, i] for i in range(N_FEAT)}
    cols["fare"] = y
    return x, cols


def _fit_both(jmodel, tmodel, sample_x, cols, jax_opt, torch_opt,
              jax_epoch_mode="stream", evaluate=True, **kw):
    """Fit the JAX and the port estimator from the same initial
    parameters; returns both estimators and histories."""
    seed = kw.pop("seed", 0)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.asarray(sample_x[:1]))["params"]
    missing, unexpected = tmodel.load_state_dict(
        params_from_flax(_numpy_tree(params), getattr(tmodel, "cfg", None)),
        strict=False)
    # flax creates the segment table only when called with segment ids,
    # which the estimators never pass.
    assert set(missing) <= {"encoder.seg_embed.weight"} and not unexpected
    jest = JAXEstimator(model=jmodel, optimizer=jax_opt, seed=seed,
                        epoch_mode=jax_epoch_mode, **kw)
    test = Estimator(model=tmodel, optimizer=torch_opt, seed=seed,
                     epoch_mode=jax_epoch_mode, device="cpu", **kw)
    jhist = jest.fit(JaxMLDataset([pa.table(cols)], 1), evaluate_ds=(
        JaxMLDataset([pa.table(cols)], 1) if evaluate else None))
    thist = test.fit(MLDataset([cols], 1),
                     evaluate_ds=MLDataset([cols], 1) if evaluate else None)
    return jest, test, jhist, thist


def _assert_histories_close(jhist, thist, keys):
    assert len(jhist) == len(thist)
    for j, t in zip(jhist, thist):
        assert t["samples"] == j["samples"]
        for k in keys:
            np.testing.assert_allclose(t[k], j[k], rtol=RTOL, err_msg=k)


def _assert_params_close(jest, test, cfg=None, lr_steps=0.0):
    want = params_from_flax(_numpy_tree(jest.get_model()[1]["params"]), cfg)
    got = test.get_model().state_dict()
    for name, w in want.items():
        g, w = got[name].numpy(), w.numpy()
        if name.endswith("attn.qkv.bias"):  # [q | k | v] rows
            k = slice(len(w) // 3, 2 * len(w) // 3)
            assert np.abs(g[k] - w[k]).max() <= 2 * lr_steps, name
            g, w = np.delete(g, np.r_[k]), np.delete(w, np.r_[k])
        np.testing.assert_allclose(g, w, err_msg=name, **PARAM_TOL)


@pytest.mark.parametrize("loss", ["mse", "smooth_l1"])
def test_estimator_matches_jax_on_taxi_mlp(loss):
    x, cols = _taxi_data()
    kw = dict(loss=loss, metrics=["mae"], num_epochs=3, batch_size=BATCH,
              feature_columns=[f"f{i}" for i in range(N_FEAT)],
              label_column="fare", shuffle=True)
    jest, test, jhist, thist = _fit_both(
        jmlp.taxi_fare_regressor(), taxi_fare_regressor(N_FEAT, device="cpu"),
        x, cols, optax.adam(1e-3),
        lambda p: torch.optim.Adam(p, lr=1e-3), **kw)
    assert [h["samples"] for h in thist] == [N_ROWS] * 3
    assert thist[-1]["train_loss"] < thist[0]["train_loss"]
    _assert_histories_close(jhist, thist,
                            ["train_loss", "eval_loss", "eval_mae"])
    _assert_params_close(jest, test)
    np.testing.assert_allclose(test.predict(x[:77]), jest.predict(x[:77]),
                               rtol=RTOL, atol=1e-5)
    ds = MLDataset([cols], 1)
    np.testing.assert_allclose(
        test.evaluate(ds)["loss"],
        jest.evaluate(JaxMLDataset([pa.table(cols)], 1))["loss"], rtol=RTOL)


@pytest.mark.parametrize("rows", ["features", "bare"])
def test_predict_on_zero_rows_matches_jax(rows):
    """``predict`` on zero rows: (0, 1) float32 for the taxi MLP, the
    trailing dims and dtype of its output on one row, as the JAX
    estimator gives; ``(0,)`` for a bare ``np.empty((0,))`` that cannot
    feed the model, in both."""
    x, cols = _taxi_data()
    jest, test, _, _ = _fit_both(
        jmlp.taxi_fare_regressor(), taxi_fare_regressor(N_FEAT, device="cpu"),
        x, cols, optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3),
        evaluate=False, loss="mse", num_epochs=1, batch_size=BATCH,
        feature_columns=[f"f{i}" for i in range(N_FEAT)],
        label_column="fare")
    empty = x[:0] if rows == "features" else np.empty((0,))
    got, want = test.predict(empty), jest.predict(empty)
    assert got.shape == want.shape == ((0, 1) if rows == "features"
                                       else (0,))
    assert got.dtype == want.dtype == np.float32
    assert test.predict(x[:3]).shape == jest.predict(x[:3]).shape == (3, 1)


def _token_data(n, seq, vocab, seed=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, vocab, size=(n, seq)).astype(np.int32)
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, seq, pos.sum())] = 7  # the label's marker
    cols = {f"t{i}": ids[:, i] for i in range(seq)}
    cols["label"] = pos.astype(np.int32)
    return ids, cols


TINY = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
            max_len=16, attention_impl="flash")


def test_estimator_matches_jax_on_flash_classifier_adamw():
    ids, cols = _token_data(48, 16, 64)
    jcfg = jt.tiny_transformer(dtype=jnp.float32, dropout_rate=0.0, **TINY)
    tcfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.0, **TINY)
    kw = dict(loss="softmax_ce", metrics=["categorical_accuracy"],
              num_epochs=2, batch_size=16,
              feature_columns=[f"t{i}" for i in range(16)],
              label_column="label", feature_dtype=np.int32,
              label_dtype=np.int32)
    jest, test, jhist, thist = _fit_both(
        jt.SequenceClassifier(jcfg), tt.SequenceClassifier(tcfg, device="cpu"),
        ids, cols, optax.adamw(1e-3, weight_decay=1e-2),
        lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-2), **kw)
    _assert_histories_close(
        jhist, thist, ["train_loss", "eval_loss", "eval_categorical_accuracy"])
    _assert_params_close(jest, test, tcfg, lr_steps=1e-3 * 6)


def test_estimator_matches_jax_on_causal_lm():
    """Self-supervised ``lm_ce``. The JAX stream path expects (x, y)
    pairs from its loader, which a label-less loader does not give, so
    the JAX side runs its scan path, unshuffled (scan shuffles with
    jax.random), and neither side evaluates."""
    ids, cols = _token_data(32, 16, 64, seed=4)
    del cols["label"]
    jcfg = jt.tiny_transformer(dtype=jnp.float32, dropout_rate=0.0,
                               causal=True, **TINY)
    tcfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.0,
                               causal=True, **TINY)
    kw = dict(loss="lm_ce", num_epochs=2, batch_size=8,
              feature_columns=[f"t{i}" for i in range(16)],
              self_supervised=True, feature_dtype=np.int32, shuffle=False)
    jest, test, jhist, thist = _fit_both(
        jt.CausalLM(jcfg), tt.CausalLM(tcfg, device="cpu"), ids, cols,
        optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3),
        jax_epoch_mode="scan", evaluate=False, **kw)
    _assert_histories_close(jhist, thist, ["train_loss"])
    _assert_params_close(jest, test, tcfg, lr_steps=1e-3 * 8)
    assert np.isfinite(test.predict(ids[:3])).all()


# ---------------------------------------------- dropout and resume

def _dropout_estimator(seed=0, **kw):
    kw.setdefault("epoch_mode", "stream")  # these fits test the stream path
    cfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.1, **TINY)
    model = tt.SequenceClassifier(
        cfg, device="cpu", generator=torch.Generator().manual_seed(5))
    return Estimator(
        model=model, loss="softmax_ce", num_epochs=3, batch_size=16,
        feature_columns=[f"t{i}" for i in range(16)], label_column="label",
        feature_dtype=np.int32, label_dtype=np.int32, seed=seed,
        optimizer=lambda p: torch.optim.AdamW(p, lr=1e-3), device="cpu", **kw)


def _losses(history):
    return [h["train_loss"] for h in history]


def test_same_seed_gives_bit_identical_fits_with_dropout():
    _, cols = _token_data(64, 16, 64, seed=6)
    a = _losses(_dropout_estimator(seed=0).fit(MLDataset([cols], 1)))
    b = _losses(_dropout_estimator(seed=0).fit(MLDataset([cols], 1)))
    c = _losses(_dropout_estimator(seed=1).fit(MLDataset([cols], 1)))
    assert a == b
    assert a != c  # the seed reaches the dropout masks


def test_resume_mid_epoch_reproduces_the_uninterrupted_run(tmp_path):
    """4 batches an epoch, a checkpoint every 3 steps; resuming from step
    6 (epoch 1, batch 2) gives the uninterrupted run's last epoch and
    final parameters bit for bit, dropout 0.1 included."""
    _, cols = _token_data(64, 16, 64, seed=7)
    full = _dropout_estimator(checkpoint_dir=str(tmp_path / "a"),
                              save_every_steps=3)
    full_hist = full.fit(MLDataset([cols], 1))
    path = tmp_path / "a" / "step_mid_6.pt"
    assert path.exists() and (tmp_path / "a" / "step_2.pt").exists()
    resumed = _dropout_estimator()
    res_hist = resumed.fit(MLDataset([cols], 1), resume_from=str(path))
    assert [h["epoch"] for h in res_hist] == [1, 2]
    assert res_hist[0]["samples"] == 32  # the epoch's last two batches
    assert res_hist[-1]["train_loss"] == full_hist[-1]["train_loss"]
    want = full.get_model().state_dict()
    for name, p in resumed.get_model().state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=0)


def test_dropout_identity_in_eval_and_at_rate_zero():
    x = torch.randn(4, 8)
    drop = Dropout(0.5)
    set_dropout_generator(drop, torch.Generator().manual_seed(0))
    assert drop.eval()(x) is x
    assert Dropout(0.0).train()(x) is x
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.5).train()(x)


def test_dropout_keeps_one_minus_rate_and_scales():
    rate = 0.1
    drop = Dropout(rate).train()
    set_dropout_generator(drop, torch.Generator().manual_seed(0))
    x = torch.ones(1_000_000)
    y = drop(x)
    kept = (y != 0).float().mean().item()
    assert abs(kept - (1 - rate)) < 0.01 * (1 - rate)
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 1 / (1 - rate)))


def test_estimator_rejects_scan_and_unknown_modes():
    """``"scan"`` is accepted and runs its path (it raised before the
    scan path was ported); an unknown mode raises."""
    _, cols = _token_data(32, 16, 64, seed=8)
    est = _dropout_estimator(epoch_mode="scan")
    assert est.effective_epoch_mode is None
    hist = est.fit(MLDataset([cols], 1), num_epochs=1)
    assert est.effective_epoch_mode == "scan"
    assert hist[0]["samples"] == 32 and np.isfinite(hist[0]["train_loss"])
    with pytest.raises(ValueError, match="epoch_mode"):
        _dropout_estimator(epoch_mode="fused")


def test_callbacks_and_epoch_checkpoints(tmp_path):
    _, cols = _token_data(32, 16, 64, seed=8)
    seen = []

    class Record(TrainingCallback):
        def on_epoch_end(self, epoch, metrics):
            seen.append((epoch, metrics["train_loss"]))

        def on_train_end(self, history):
            seen.append(len(history))

    est = _dropout_estimator(callbacks=[Record()],
                             checkpoint_dir=str(tmp_path))
    hist = est.fit(MLDataset([cols], 1), num_epochs=2)
    assert seen == [(0, hist[0]["train_loss"]), (1, hist[1]["train_loss"]),
                    2]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_0.pt",
                                                          "step_1.pt"]
    preds = est.predict(np.stack([cols[f"t{i}"] for i in range(16)], 1))
    assert preds.shape == (32, 2) and np.isfinite(preds).all()


def test_estimator_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Estimator(model=lambda: torch.nn.Linear(2, 1))
