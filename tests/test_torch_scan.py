"""The port's scan path against the JAX package's, on the CPU.

``Estimator(epoch_mode="scan")`` against ``JAXEstimator``'s scan path
(``raydp_tpu/train/estimator.py:930-1144``) on the same numpy data and
the same converted initial parameters:

* the path decision (``_use_scan`` and the ``resume_from`` rule);
* the materialised, padded arrays (``_materialize_all`` and
  ``_pad_cycle``);
* unshuffled scan fits of the taxi MLP and of the flash
  ``SequenceClassifier`` (f32; the JAX kernels as the other parity tests
  run them on the CPU), rows not divisible by the batch, no dropout:
  per-epoch ``train_loss`` and ``samples``, and the final parameters, at
  ``test_torch_train``'s tolerances. The port cannot reproduce
  ``jax.random.permutation``, so the shuffle and dropout are checked on
  the port alone: a permutation of all rows that follows the seed and
  changes each epoch, and bit-identical fits from one seed.

On the CPU the scan step runs eagerly; on a card it is a CUDA graph
(``tests/test_torch_cuda.py``).
"""
import importlib
import logging
import types

import jax.numpy as jnp
import numpy as np
import optax
import pyarrow as pa
import pytest
import torch

from raydp_tpu.data.ml_dataset import MLDataset as JaxMLDataset
from raydp_tpu.models import mlp as jmlp
from raydp_tpu.models import transformer as jt
from raydp_tpu.train import estimator as jest_module
from raydp_tpu.train.estimator import JAXEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import transformer as tt
from raydp_tpu_torch.models.mlp import taxi_fare_regressor
from raydp_tpu_torch.train import Estimator
from raydp_tpu_torch.train import estimator as test_module
from raydp_tpu_torch.train.losses import mse
from raydp_tpu_torch.utils.graphed import (
    CapturedStep,
    capture_refusal,
    make_capturable,
)

from test_torch_train import (
    BATCH,
    N_FEAT,
    N_ROWS,
    TINY,
    _assert_histories_close,
    _assert_params_close,
    _dropout_estimator,
    _fit_both,
    _losses,
    _taxi_data,
    _token_data,
)

FEATURES = [f"f{i}" for i in range(N_FEAT)]


def _estimators(epoch_mode, **kw):
    """A JAX and a port estimator of the taxi MLP, configured alike."""
    cfg = dict(loss="mse", num_epochs=1, batch_size=BATCH,
               feature_columns=FEATURES, label_column="fare",
               epoch_mode=epoch_mode, **kw)
    return (JAXEstimator(model=jmlp.taxi_fare_regressor(), **cfg),
            Estimator(model=taxi_fare_regressor(N_FEAT, device="cpu"),
                      device="cpu", **cfg))


def _datasets(cols, num_shards=1):
    blocks = [{k: v[i::num_shards] for k, v in cols.items()}
              for i in range(num_shards)]
    return (JaxMLDataset([pa.table(b) for b in blocks], num_shards),
            MLDataset(blocks, num_shards))


# ---------------------------------------------------- the path decision

@pytest.mark.parametrize("case", [
    "auto_under_threshold", "auto_over_threshold", "stream", "scan",
    "empty", "empty_without_total_rows", "resume_from"])
def test_use_scan_gives_the_jax_answer(case, tmp_path, caplog):
    """JAX's decision is ``_use_scan(ds) and resume_from is None``
    (``JAXEstimator._fit``); the port's is read from a fit's
    ``effective_epoch_mode``. Neither ``MLDataset`` holds zero rows, so
    the empty case asks both ``_use_scan`` of a dataset whose
    ``total_rows`` is 0, with ``"scan"`` requested: both stream and
    warn alike. A dataset without ``total_rows`` that holds no rows
    scans when asked, and both fits record empty epochs."""
    mode = {"auto_over_threshold": "auto", "auto_under_threshold": "auto",
            "resume_from": "auto", "empty": "scan",
            "empty_without_total_rows": "scan"}.get(case, case)
    kw = {"scan_threshold_bytes": 10} if case == "auto_over_threshold" \
        else {}
    jax_est, port = _estimators(mode, **kw)
    want = {"auto_under_threshold": "scan", "auto_over_threshold": "stream",
            "stream": "stream", "scan": "scan", "empty": "stream",
            "empty_without_total_rows": "scan", "resume_from": "stream"}[case]
    if case == "empty":
        empty = types.SimpleNamespace(total_rows=0)
        with caplog.at_level(logging.WARNING):
            assert not jax_est._use_scan(empty)
            jax_warned = [r.getMessage() for r in caplog.records]
            caplog.clear()
            assert not port._use_scan(empty)
            port_warned = [r.getMessage() for r in caplog.records]
        assert port_warned == jax_warned and len(port_warned) == 1
        return
    if case == "empty_without_total_rows":
        empty = types.SimpleNamespace(
            num_shards=1,
            shard_columns=lambda rank, wanted: {
                c: np.zeros(0, np.float32) for c in wanted})
        hists = {}
        for name, est in (("jax", jax_est), ("port", port)):
            with caplog.at_level(logging.WARNING):
                caplog.clear()
                hist = est.fit(empty, num_epochs=2)
                assert "recording empty epochs" in caplog.text
            assert est.effective_epoch_mode == want
            hists[name] = [(h["epoch"], h["train_loss"], h["samples"])
                           for h in hist]
        assert hists["port"] == hists["jax"] == [(0, 0.0, 0), (1, 0.0, 0)]
        return
    _, cols = _taxi_data()
    jds, tds = _datasets(cols)
    resume = None
    if case == "resume_from":
        resume = port.save(str(tmp_path), step=0, data_position=(1, 0))
    jax_mode = ("scan" if jax_est._use_scan(jds) and resume is None
                else "stream")
    port.fit(tds, num_epochs=2, resume_from=resume)
    assert port.effective_epoch_mode == jax_mode == want
    assert [h["epoch"] for h in port.history] == (
        [1] if case == "resume_from" else [0, 1])


def test_materialize_and_pad_match_jax():
    """Two shards of 301 rows (the shard plan pads the second to 151 by
    reuse), a batch of 64: 302 rows padded to 320 by cycling. Also a pad
    longer than the data."""
    x, cols = _taxi_data()
    cols = {k: np.concatenate([v, v[:1]]) for k, v in cols.items()}
    jax_est, port = _estimators("scan")
    jds, tds = _datasets(cols, num_shards=2)
    jx, jy = jax_est._materialize_all(jds)
    tx, ty = port._materialize_all(tds)
    assert tx.dtype == jx.dtype and ty.dtype == jy.dtype
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    for n, pad in ((len(tx), -len(tx) % BATCH), (3, 10)):
        want = jest_module._pad_cycle(jx[:n], jy[:n], pad)
        got = test_module._pad_cycle(tx[:n], ty[:n], pad)
        assert got[0].shape == (n + pad, N_FEAT)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    xs, _ = test_module._pad_cycle(tx[:3], None, 4)
    np.testing.assert_array_equal(xs, tx[[0, 1, 2, 0, 1, 2, 0]])


# ------------------------------------------------------ fits against JAX

def test_scan_fit_matches_jax_on_taxi_mlp():
    """300 rows in batches of 64: 5 fused steps, the last padded with 20
    cycled rows; ``samples`` counts the 300 true rows and ``train_loss``
    is the mean of the 5 steps' losses."""
    x, cols = _taxi_data()
    kw = dict(loss="mse", num_epochs=3, batch_size=BATCH,
              feature_columns=FEATURES, label_column="fare", shuffle=False)
    jest, test, jhist, thist = _fit_both(
        jmlp.taxi_fare_regressor(), taxi_fare_regressor(N_FEAT, device="cpu"),
        x, cols, optax.adam(1e-3), lambda p: torch.optim.Adam(p, lr=1e-3),
        jax_epoch_mode="scan", evaluate=False, **kw)
    assert jest.effective_epoch_mode == test.effective_epoch_mode == "scan"
    assert [h["samples"] for h in thist] == [N_ROWS] * 3
    assert test._step == 3 * 5
    _assert_histories_close(jhist, thist, ["train_loss"])
    _assert_params_close(jest, test)


def test_scan_fit_matches_jax_on_flash_classifier():
    """The f32 flash classifier (TINY), AdamW, 40 rows in batches of 16:
    3 fused steps an epoch, the last padded with 8 cycled rows."""
    ids, cols = _token_data(40, 16, 64, seed=9)
    jcfg = jt.tiny_transformer(dtype=jnp.float32, dropout_rate=0.0, **TINY)
    tcfg = tt.tiny_transformer(dtype=torch.float32, dropout_rate=0.0, **TINY)
    kw = dict(loss="softmax_ce", num_epochs=2, batch_size=16,
              feature_columns=[f"t{i}" for i in range(16)],
              label_column="label", feature_dtype=np.int32,
              label_dtype=np.int32, shuffle=False)
    jest, test, jhist, thist = _fit_both(
        jt.SequenceClassifier(jcfg), tt.SequenceClassifier(tcfg, device="cpu"),
        ids, cols, optax.adamw(1e-3, weight_decay=1e-2),
        lambda p: torch.optim.AdamW(p, lr=1e-3, weight_decay=1e-2),
        jax_epoch_mode="scan", evaluate=False, **kw)
    assert [h["samples"] for h in thist] == [40, 40]
    _assert_histories_close(jhist, thist, ["train_loss"])
    _assert_params_close(jest, test, tcfg, lr_steps=1e-3 * 6)


# ------------------------------------------------ the port's own draws

def _recorded_rows(seed, n_rows=96, batch=16, epochs=3, shuffle=True):
    """Each epoch's rows, in the order the scan steps saw them (the label
    of row i is i)."""
    rng = np.random.default_rng(0)
    cols = {f"f{i}": rng.standard_normal(n_rows).astype(np.float32)
            for i in range(N_FEAT)}
    cols["fare"] = np.arange(n_rows, dtype=np.float32)
    seen = []

    def recording_mse(preds, targets):
        seen.append(targets.clone())
        return mse(preds, targets)

    est = Estimator(model=taxi_fare_regressor(N_FEAT, device="cpu"),
                    loss=recording_mse, num_epochs=epochs, batch_size=batch,
                    feature_columns=FEATURES, label_column="fare",
                    seed=seed, shuffle=shuffle, epoch_mode="scan",
                    device="cpu")
    est.fit(MLDataset([cols], 1))
    steps = -(-n_rows // batch)
    return [torch.cat(seen[e * steps:(e + 1) * steps]).long().tolist()
            for e in range(epochs)]


def test_scan_shuffle_is_a_seeded_permutation_that_changes_each_epoch():
    a, b, c = _recorded_rows(0), _recorded_rows(0), _recorded_rows(1)
    for epoch in a:
        assert sorted(epoch) == list(range(96))
    assert a == b
    assert a[0] != a[1] != a[2]
    assert a != c
    assert _recorded_rows(0, shuffle=False) == [list(range(96))] * 3
    # 100 rows: padded to 112 by cycling rows 0-11, then permuted.
    padded = _recorded_rows(0, n_rows=100, epochs=1)[0]
    assert sorted(padded) == sorted(list(range(100)) + list(range(12)))


def test_scan_fits_with_dropout_are_bit_identical_for_one_seed():
    _, cols = _token_data(64, 16, 64, seed=6)
    fit = lambda seed: _losses(_dropout_estimator(  # noqa: E731
        seed=seed, epoch_mode="scan").fit(MLDataset([cols], 1)))
    a, b, c = fit(0), fit(0), fit(1)
    assert a == b
    assert a != c


# ------------------------------------------------- capture bookkeeping

def test_recording_launches_puts_counters_back_and_counting_replays_adds():
    mod = importlib.import_module("raydp_tpu_torch.ops.flash_attention")
    fns = (mod.flash_attention, mod.flash_bwd_delta, mod.flash_bwd_dq,
           mod.flash_bwd_dkv)
    before = [f.launches for f in fns]
    with mod.recording_launches() as gained:
        for n, f in zip((12, 12, 12, 12), fns):
            f.launches += n
        mod.flash_bwd_dq.launches += 1
    assert gained == [12, 12, 13, 12]
    assert [f.launches for f in fns] == before
    mod.count_replay(gained)
    mod.count_replay(gained)
    assert [f.launches - b for f, b in zip(fns, before)] == [24, 24, 26, 24]
    for f, b in zip(fns, before):
        f.launches = b


@pytest.mark.parametrize("name,verdict", [
    ("AdamW", "capturable"), ("Adam", "capturable"),
    ("RMSprop", "capturable"), ("SGD", "as it is"), ("Adagrad", "refused")])
def test_make_capturable_by_optimizer(name, verdict):
    """Optimizers with a capturable mode are switched to it; SGD, which
    keeps no host state, is captured as it is; Adagrad (its step count
    on the host) is refused by ``capture_refusal`` and ``make_capturable``
    alike."""
    model = torch.nn.Linear(3, 1)
    opt = getattr(torch.optim, name)(model.parameters(), lr=1e-3)
    model(torch.ones(2, 3)).sum().backward()
    opt.step()
    if verdict == "refused":
        assert name in capture_refusal(opt)
        with pytest.raises(TypeError, match="epoch_mode='stream'"):
            make_capturable(opt)
        return
    assert capture_refusal(opt) is None
    make_capturable(opt)
    assert all(g.get("capturable", False) == (verdict == "capturable")
               for g in opt.param_groups)


def test_captured_optimizer_step_needs_a_warm_up_call():
    """Captured as its first step, an optimizer step would create its
    state afresh on every replay: refused before anything reaches a
    card."""
    opt = torch.optim.AdamW(torch.nn.Linear(3, 1).parameters(), lr=1e-3)
    with pytest.raises(ValueError, match="warm-up"):
        CapturedStep(lambda: None, warmup=0, optimizer=opt)
