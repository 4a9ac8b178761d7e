"""The port's torch compat estimator (``raydp_tpu_torch/train/
torch_estimator.py``) against the JAX package's tests of its own and
against the JAX package's ``TorchEstimator`` itself, on the CPU.

* The cases of ``tests/test_torch_estimator.py`` run against the port
  (``tests/torch_port_cases.py`` points ``raydp_tpu.train.torch_estimator``
  at it), every estimator built with ``device="cpu"``. The module is put
  in ``sys.modules`` for its two gang cases, which register it with
  cloudpickle by name. Its two cases that build a dataset through the JAX
  package's ``_ensure_df`` are mirrored here on the port's.
* ``tests/test_predict.py``'s ``TorchEstimator`` case, in both driver
  modes (the reference's autouse fixture, repeated here).
* Direct parity: one creator of a tiny flash ``SequenceClassifier`` of
  the port (2 layers, width 64; its plain attention on the CPU), one seed
  and one frame, fitted shuffled with an eval frame through the JAX
  package's ``TorchEstimator`` and the port's: the histories equal and
  every ``state_dict`` entry ``torch.equal``. The world-2 fit is in
  ``test_torch_compat_store_feed.py``.
* Where the port differs by design: the shard and the epoch's order
  cross to the device once (checked here by counting the loop's reads),
  the trained state is CPU tensors, a bfloat16 output predicts as
  float32, and a model class of a script travels to gang ranks by value.
"""
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu.dataframe as ref_rdf
import raydp_tpu_torch
import raydp_tpu_torch.train.torch_estimator as te
from raydp_tpu.data import MLDataset as RefMLDataset
from raydp_tpu.train.torch_estimator import TorchEstimator as RefEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.models import SequenceClassifier, tiny_transformer
from raydp_tpu_torch.train import TorchEstimator
from raydp_tpu_torch.train.estimator import _ensure_df
from test_torch_client_mode import mode_session  # noqa: F401
from torch_port_cases import (cases, case_params, load_port_module,
                              run_case, time_limit)

REFERENCE = load_port_module("test_torch_estimator.py")
# Mirrored below: they build the dataset with the JAX package's
# _ensure_df, a JAX-package frame.
MIRRORED = ("test_all_shards_consumed_when_more_shards_than_workers",
            "test_evaluate_uses_all_shards")
REFERENCE_CASES = cases(REFERENCE, [
    n for n in vars(REFERENCE)
    if n.startswith("test_") and n not in MIRRORED])
PREDICT = load_port_module(
    "test_predict.py",
    only=("test_torch_estimator_predict_matches_manual_forward",))
# Each test's own limit, in seconds: the gang cases start processes.
LIMIT_S = 240

# The direct parity fit: a tiny flash classifier over GLUE-shaped rows.
SEQ, VOCAB, ROWS = 16, 64, 192


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    """Every port estimator of this file is built with device="cpu"."""
    init = te.TorchEstimator.__init__

    def cpu_init(self, *args, device="cpu", **kwargs):
        init(self, *args, device=device, **kwargs)

    monkeypatch.setattr(te.TorchEstimator, "__init__", cpu_init)


@pytest.mark.parametrize("name,params",
                         case_params(REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request, monkeypatch):
    # The gang cases register their module with cloudpickle by name.
    monkeypatch.setitem(sys.modules, REFERENCE.__name__, REFERENCE)
    with time_limit(LIMIT_S):
        run_case(REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) + len(MIRRORED) == 12


def test_predict_case_both_modes(mode_session, request):  # noqa: F811
    with time_limit(LIMIT_S):
        run_case(PREDICT,
                 "test_torch_estimator_predict_matches_manual_forward", {},
                 request)


def _linear_df(n, seed):
    return REFERENCE._linear_df(n=n, seed=seed)


class _CountingLoss(torch.nn.MSELoss):
    def __init__(self, seen):
        super().__init__()
        self.seen = seen

    def forward(self, inp, tgt):
        self.seen.append(len(tgt))
        return super().forward(inp, tgt)


def test_all_shards_consumed_when_more_shards_than_workers():
    """test_torch_estimator.py's case on the port's frames: one worker
    over 4 shards trains every row."""
    ds = MLDataset.from_df(_ensure_df(_linear_df(200, 5)), num_shards=4)
    seen = []
    est = TorchEstimator(
        num_workers=1, model=lambda c: torch.nn.Linear(2, 1),
        loss=_CountingLoss(seen), feature_columns=["a", "b"],
        label_column="y", num_epochs=1, batch_size=200, shuffle=False)
    est.fit(ds)
    assert sum(seen) == 200, f"only {sum(seen)} of 200 rows trained"


def test_evaluate_uses_all_shards():
    """test_torch_estimator.py's case on the port's frames: evaluate over
    4 wrap-padded shards scores exactly the 121 rows."""
    seen = []
    df = _linear_df(121, 8)
    est = TorchEstimator(
        model=lambda c: torch.nn.Linear(2, 1), loss=_CountingLoss(seen),
        feature_columns=["a", "b"], label_column="y", num_epochs=1,
        batch_size=121, shuffle=False)
    est.fit(MLDataset.from_df(_ensure_df(df), num_shards=1))
    seen.clear()
    est.evaluate(MLDataset.from_df(_ensure_df(df), num_shards=4))
    assert seen == [121], f"evaluate saw {seen} rows, wanted exactly 121"


def glue_frame(n, seed):
    """GLUE-shaped rows: the label is whether marker token 7 appears."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(10, VOCAB, size=(n, SEQ))
    pos = rng.random(n) < 0.5
    ids[pos, rng.integers(0, SEQ, pos.sum())] = 7
    df = pd.DataFrame({f"t{i}": ids[:, i] for i in range(SEQ)})
    df["label"] = pos.astype(np.int64)
    return df


class SegmentedClassifier(torch.nn.Module):
    """A classifier fed segment ids 0: every parameter, the segment table
    included, takes part in the loss, as DDP without
    ``find_unused_parameters`` needs in both packages' gangs."""

    def __init__(self, clf):
        super().__init__()
        self.clf = clf

    def forward(self, ids):
        return self.clf(ids, torch.zeros_like(ids))


def flash_classifier(config):
    """The port's bf16 flash classifier at 2 layers of width 64, built
    on the CPU (its flash attention runs the plain version there)."""
    cfg = tiny_transformer(vocab_size=VOCAB, d_model=64, n_heads=4,
                           n_layers=2, d_ff=128, max_len=SEQ,
                           attention_impl="flash")
    return SegmentedClassifier(
        SequenceClassifier(cfg, num_classes=2, device="cpu"))


def adamw(model, config):
    return torch.optim.AdamW(model.parameters(), lr=config["lr"])


def parity_kwargs(**kw):
    out = dict(model=flash_classifier, optimizer=adamw,
               loss=torch.nn.CrossEntropyLoss,
               feature_columns=[f"t{i}" for i in range(SEQ)],
               feature_types=np.int64, label_column="label",
               label_type=np.int64, batch_size=32, num_epochs=2,
               shuffle=True, seed=3, lr=1e-3)
    out.update(kw)
    return out


def assert_same_fit(ref, port):
    assert port.history == ref.history
    want = ref._trained_state
    got = port._trained_state
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], torch.from_numpy(want[k])), k


def test_world1_fit_equals_the_reference():
    """The same creator, seed and frames through both packages: equal
    histories (losses and accuracies, train and eval) and equal
    parameters, bit for bit; predictions equal too."""
    train, evl = glue_frame(ROWS, 0), glue_frame(48, 1)
    ref = RefEstimator(**parity_kwargs())
    ref.fit_on_df(train, evaluate_df=evl)
    port = TorchEstimator(**parity_kwargs())
    port.fit_on_df(train, evaluate_df=evl)
    assert len(port.history) == 2 and "eval_acc" in port.history[-1]
    assert_same_fit(ref, port)
    ids = evl[[f"t{i}" for i in range(SEQ)]].to_numpy()
    np.testing.assert_array_equal(port.predict(ids), ref.predict(ids))


def test_world1_fit_from_each_packages_frames():
    """The same rows as each package's engine frame, 3 partitions, fitted
    from its MLDataset: the datasets hand over the same rows, so the
    fits are equal."""
    train = glue_frame(ROWS, 2)
    ref = RefEstimator(**parity_kwargs(num_epochs=1))
    ref.fit(RefMLDataset.from_df(ref_rdf.from_pandas(train,
                                                     num_partitions=3),
                                 num_shards=3))
    port = TorchEstimator(**parity_kwargs(num_epochs=1))
    port.fit(MLDataset.from_df(raydp_tpu_torch.dataframe.from_pandas(
        train, num_partitions=3), num_shards=3))
    assert_same_fit(ref, port)


def test_epoch_reads_once(monkeypatch):
    """The loop reads its sums once an epoch, whatever the steps: one
    ``tolist`` of the train sums an epoch, one of the eval sums."""
    reads = []
    real = torch.Tensor.tolist

    def counting(self):
        reads.append(tuple(self.shape))
        return real(self)

    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    df = _linear_df(256, 1)
    est = TorchEstimator(model=lambda c: torch.nn.Linear(2, 1),
                         loss=torch.nn.MSELoss(), feature_columns=["a", "b"],
                         label_column="y", batch_size=16, num_epochs=3,
                         shuffle=False)
    est.fit_on_df(df, evaluate_df=df.iloc[:32])
    assert reads == [(3,), (4,)] * 3


def test_bf16_outputs_predict_as_float32():
    class Half(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(2, 2).to(torch.bfloat16)

        def forward(self, x):
            return self.fc(x.to(torch.bfloat16))

    est = TorchEstimator(model=Half(), loss=torch.nn.CrossEntropyLoss(),
                         feature_columns=["a", "b"], label_column="y",
                         label_type=np.int64, num_epochs=1)
    df = _linear_df(64, 2)
    df["y"] = (df["a"] > 0.5).astype(np.int64)
    est.fit_on_df(df)
    assert est._trained_state["fc.weight"].dtype == torch.bfloat16
    out = est.predict(df[["a", "b"]].to_numpy()[:5])
    assert out.dtype == np.float32 and out.shape == (5, 2)


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        te.TorchEstimator.__init__(
            object.__new__(te.TorchEstimator), model=torch.nn.Linear(2, 1),
            loss=torch.nn.MSELoss(), device="cuda")
