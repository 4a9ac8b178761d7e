"""The port's step retries and resume bookkeeping
(``raydp_tpu_torch/train/estimator.py``) against the JAX package's
(``tests/test_resume.py:122-231``, ``tests/test_fault_tolerance.py:
361-415``).

* The five retry cases of ``tests/test_resume.py`` on the port's
  ``_train_step`` (the scan case at the port's granularity, the step):
  a persistent failure spends the budget and surfaces; an explicit
  ``max_failures`` turns "donation" off and survives a transient
  failure; the scan path retries its eager steps; the defaults keep
  donation on with an inert budget of 3; donation on re-raises the
  original error at once.
* A transient failure raised after the forward (the dropout masks
  already drawn) is retried and leaves the parameters of a run that
  never failed, bit for bit; a failure in ``opt.step()`` or in a gang's
  gradient exchange re-raises at once, whatever the budget.
* Checkpoints record the writing world (``data_world``); a resume under
  another world rescales the per-rank skip and starts the fresh rank's
  dropout stream; retention prunes ``step_mid_`` and
  ``step_emergency_`` files together, oldest step first, and the
  survivor restores.

``tests/test_resume.py::test_train_and_data_config_objects_wire`` runs
on the port's typed configs in ``tests/test_torch_typed_config.py``.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.train import Estimator
from raydp_tpu_torch.train import estimator as est_mod


def _ds(n=2048, parts=4, seed=0):
    """``tests/test_resume.py``'s rows: 2 shards of 1,024."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    df = torch_rdf.from_pandas(
        pd.DataFrame({"a": a, "b": b, "y": 2 * a - 3 * b + 1}),
        num_partitions=parts)
    return MLDataset.from_df(df, num_shards=2)


def _est(dropout=0.0, **kw):
    """``tests/test_resume.py``'s estimator on the port, the MLP's
    weights drawn from one seed (and dropout where asked)."""
    torch.manual_seed(0)
    model = raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1,
                                dropout_rate=dropout, device="cpu")
    defaults = dict(
        model=model, optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
        loss="mse", num_epochs=3, batch_size=256,
        feature_columns=["a", "b"], label_column="y", seed=5, shuffle=True,
        epoch_mode="stream", device="cpu")
    defaults.update(kw)
    return Estimator(**defaults)


class Boom(Exception):
    pass


def _params(est):
    return {k: v.detach().clone()
            for k, v in est.get_model().state_dict().items()}


def _assert_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# -- tests/test_resume.py's five retry cases ---------------------------------

def test_step_retry_budget_surfaces_persistent_failure():
    est = _est(max_failures=2, donate_state=False)
    calls = {"n": 0}

    def bad_step(x, y):
        calls["n"] += 1
        raise Boom("persistent")

    est._train_step = bad_step
    with pytest.raises(Boom):
        est.fit(_ds())
    assert calls["n"] == 3  # 2 failures within budget, the 3rd raises


def test_explicit_max_failures_disables_donation_and_retries_work():
    est = _est(max_failures=2)
    assert est.donate_state is False  # so the retries happen
    calls = {"n": 0}
    real = est._train_step

    def flaky_step(x, y):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device error")
        return real(x, y)

    est._train_step = flaky_step
    history = est.fit(_ds())
    assert calls["n"] == 3 * 8 + 1  # 8 steps an epoch, one retried
    assert len(history) == est.num_epochs


def test_scan_mode_step_retry_survives_transient_failure():
    """The scan path's unit is the step (the CPU runs it eagerly): a
    transient failure costs one retried step, not an epoch."""
    est = _est(max_failures=2, epoch_mode="scan")
    assert est.donate_state is False
    calls = {"n": 0}
    real = est._train_step

    def flaky_step(x, y):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device error")
        return real(x, y)

    est._train_step = flaky_step
    history = est.fit(_ds())
    assert est.effective_epoch_mode == "scan"
    assert len(history) == est.num_epochs
    assert calls["n"] == est.num_epochs * 8 + 1


def test_default_config_keeps_donation_on():
    est = _est()
    assert est.donate_state is True
    assert est.max_failures == 3


def test_donated_step_failure_raises_original_immediately():
    est = _est(max_failures=2, donate_state=True)
    assert est.donate_state is True
    calls = {"n": 0}

    def bad_step(x, y):
        calls["n"] += 1
        raise Boom("original")

    est._train_step = bad_step
    with pytest.raises(Boom, match="original"):
        est.fit(_ds())
    assert calls["n"] == 1


# -- what a retry may and may not touch ---------------------------------------

@pytest.mark.parametrize("epoch_mode", ["stream", "scan"])
def test_retry_after_the_forward_leaves_the_unfailed_parameters(epoch_mode):
    """The loss raises once at step 5, after the forward drew its dropout
    masks: the retried batch draws the same masks, so the fit ends with
    a clean fit's parameters exactly."""
    clean = _est(dropout=0.3, epoch_mode=epoch_mode)
    clean.fit(_ds())
    est = _est(dropout=0.3, epoch_mode=epoch_mode, max_failures=1)
    loss_fn = est._loss_fn
    calls = {"n": 0}

    def flaky_loss(pred, target):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("transient host error")
        return loss_fn(pred, target)

    est._loss_fn = flaky_loss
    est.fit(_ds())
    assert calls["n"] == 3 * 8 + 1
    assert [h["train_loss"] for h in est.history] == [
        h["train_loss"] for h in clean.history]
    _assert_equal(_params(est), _params(clean))


def test_failure_in_the_optimizer_step_is_not_retried():
    """``opt.step()`` updates in place: a failure there re-raises at
    once, with budget to spare."""
    est = _est(max_failures=3)
    step = est.optimizer.step
    calls = {"n": 0}

    def failing_step(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise Boom("in the update")
        return step(*args, **kwargs)

    est.optimizer.step = failing_step
    with pytest.raises(Boom, match="in the update"):
        est.fit(_ds())
    assert calls["n"] == 2 and est._failures == 0


def test_failure_in_the_gradient_exchange_is_not_retried():
    """In a gang the update begins when the rank enters the exchange (the
    other ranks may already have reduced with it): a failure there
    re-raises at once; one in the backward before it is retried."""
    est = _est(max_failures=3)
    est._clock = est_mod._StepClock(est.device)
    x = torch.zeros(4, 2)
    y = torch.zeros(4)

    def exchange(loss_sum, rows, preempt):
        raise Boom("in the exchange")

    est._allreduce = exchange
    with pytest.raises(Boom, match="in the exchange"):
        est._run_step(est._train_step, x, y)
    assert est._failures == 0
    loss_fn = est._loss_fn
    calls = {"n": 0}

    def flaky_loss(pred, target):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("before the exchange")
        return loss_fn(pred, target)

    est._loss_fn = flaky_loss
    with pytest.raises(Boom, match="in the exchange"):
        est._run_step(est._train_step, x, y)
    assert est._failures == 1 and calls["n"] == 2


# -- data_world, the rescaled resume, retention ------------------------------

def test_checkpoint_records_world_and_rescales_resume(tmp_path, monkeypatch):
    """A checkpoint written as by a 2-rank world at per-rank batch 3
    restores with ``_resume_world == 2``; a 1-rank resume skips the 6
    batches that position is here, and starts the dropout stream of a
    fresh rank 0 (not the writer's)."""
    est = _est(num_epochs=1, shuffle=False)
    est.fit(_ds())
    monkeypatch.setattr(est_mod, "_data_world", lambda: 2)
    path = est.save(str(tmp_path), step="mid_6", data_position=(0, 3))
    monkeypatch.undo()
    state = torch.load(path, weights_only=True)
    assert state["data_world"] == 2

    fresh = _est(num_epochs=1, shuffle=False)
    fresh.restore_path(path)
    assert fresh._resume_world == 2
    assert fresh._resume_position == (0, 3)
    want = torch.Generator().manual_seed(est_mod._rank_seed(5, 0))
    assert torch.equal(fresh._generator.get_state(), want.get_state())

    resumed = _est(num_epochs=1, shuffle=False)
    history = resumed.fit(_ds(), resume_from=path)
    assert resumed.resume_skip == 6
    assert history[0]["samples"] == (8 - 6) * 256

    # The world that wrote it resumes its own position and stream.
    same = _est(num_epochs=1, shuffle=False)
    one = est.save(str(tmp_path), step="mid_7", data_position=(0, 3))
    same.fit(_ds(), resume_from=one)
    assert same.resume_skip == 3
    same.restore_path(one)
    assert torch.equal(same._generator.get_state(),
                       torch.load(one, weights_only=True)["generator"])


def test_checkpoint_without_data_world_restores_as_before(tmp_path):
    """A file with no ``data_world`` (older, or 0) means an unknown
    world: no rescale, the saved stream restored."""
    est = _est(num_epochs=1)
    est.fit(_ds())
    path = est.save(str(tmp_path), step="mid_8", data_position=(0, 4))
    state = torch.load(path, weights_only=True)
    del state["data_world"]
    torch.save(state, path)
    fresh = _est(num_epochs=1)
    fresh.fit(_ds(), resume_from=path)
    assert fresh._resume_world is None and fresh.resume_skip == 4


def test_retention_prunes_mid_and_emergency_together(tmp_path, monkeypatch):
    """``RAYDP_TPU_CKPT_KEEP`` bounds ``step_mid_`` and
    ``step_emergency_`` files as one ring ordered by step: the newest
    survive, epoch-end and ``final.pt`` files are never pruned, and the
    survivor restores."""
    monkeypatch.setenv(est_mod.CKPT_KEEP_ENV, "2")
    ckpt = str(tmp_path)
    est = _est(num_epochs=1, shuffle=False, checkpoint_dir=ckpt,
               save_every_steps=3)
    est.fit(_ds())  # step_mid_3, step_mid_6, step_0.pt
    est.save(ckpt, step="emergency_7", data_position=(1, 0))
    est.save(ckpt, step="mid_5", data_position=(1, 0))  # older than 7
    est.save(ckpt)
    names = sorted(n for n in os.listdir(ckpt) if n.endswith(".pt"))
    assert names == ["final.pt", "step_0.pt", "step_emergency_7.pt",
                     "step_mid_6.pt"]
    est.save(ckpt, step="emergency_9", data_position=(1, 0))
    names = sorted(n for n in os.listdir(ckpt) if n.endswith(".pt"))
    assert names == ["final.pt", "step_0.pt", "step_emergency_7.pt",
                     "step_emergency_9.pt"]
    fresh = _est()
    fresh.restore_path(os.path.join(ckpt, "step_emergency_9.pt"))
    _assert_equal(_params(fresh), _params(est))


def test_drain_writes_the_emergency_checkpoint_and_raises(tmp_path):
    """An in-process fit drains a notice at the next step boundary:
    ``step_emergency_<N>.pt`` at the exact position, the notice marked
    drained, ``PreemptionError`` naming the path; the fit resumed from it
    ends with an uninterrupted one's parameters."""
    from raydp_tpu_torch import fault

    clean = _est(num_epochs=2, dropout=0.2)
    clean.fit(_ds())
    ckpt = str(tmp_path)
    est = _est(num_epochs=2, dropout=0.2, checkpoint_dir=ckpt)
    step = est._train_step
    calls = {"n": 0}

    def notice_at_step_11(x, y):
        calls["n"] += 1
        if calls["n"] == 11:
            fault.request_preemption(grace_s=0)
        return step(x, y)

    est._train_step = notice_at_step_11
    try:
        with pytest.raises(fault.PreemptionError) as info:
            est.fit(_ds())
    finally:
        drained = fault.inject._state.drained.is_set()
        fault.reset_for_tests()
    path = os.path.join(ckpt, "step_emergency_11.pt")
    assert info.value.checkpoint_path == path and drained
    state = torch.load(path, weights_only=True)
    assert (state["data_epoch"], state["data_batch"], state["step"]) == (
        1, 3, 11)
    resumed = _est(num_epochs=2, dropout=0.2)
    resumed.fit(_ds(), resume_from=path)
    # Its one epoch is epoch 1's last 5 batches.
    assert [(h["epoch"], h["samples"]) for h in resumed.history] == [
        (1, 5 * 256)]
    _assert_equal(_params(resumed), _params(clean))
