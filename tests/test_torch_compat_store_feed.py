"""The port's torch compat estimator's store feed, on the CPU.

* The cases of ``tests/test_torch_store_feed.py`` run against the port:
  under a live port session the gang's ranks read their shards straight
  from the object store (the driver's ``_rows_range`` is never called),
  eval is gang-reduced where every rank holds an eval shard, and falls
  back to rank 0 where the eval set has too few blocks.
* Direct parity at world 2: the same creator of a tiny flash
  ``SequenceClassifier`` (as in ``test_torch_compat_estimator.py``), one
  seed and one frame of 4 partitions, fitted by a 2-rank gloo gang of
  each package under a session of each package, both datasets
  ref-backed: the histories (gang-reduced eval included) equal and every
  parameter ``torch.equal``.
"""
import sys

import cloudpickle
import numpy as np
import pytest
import torch

import raydp_tpu
import raydp_tpu.dataframe as ref_rdf
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf
import raydp_tpu_torch.train.torch_estimator as te
from raydp_tpu.data import MLDataset as RefMLDataset
from raydp_tpu.train.torch_estimator import TorchEstimator as RefEstimator
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.train import TorchEstimator
from test_torch_compat_estimator import (assert_same_fit, glue_frame,
                                         on_cpu, parity_kwargs)  # noqa: F401
from torch_port_cases import (cases, case_params, load_port_module,
                              run_case, time_limit)

REFERENCE = load_port_module("test_torch_store_feed.py")
REFERENCE_CASES = cases(
    REFERENCE, [n for n in vars(REFERENCE) if n.startswith("test_")])
LIMIT_S = 240


@pytest.mark.parametrize("name,params",
                         case_params(REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) == 3


@pytest.fixture()
def both_sessions():
    ref = raydp_tpu.init(app_name="compat-parity-ref", num_workers=2)
    try:
        port = raydp_tpu_torch.init(app_name="compat-parity-port",
                                    num_workers=2)
        try:
            yield ref, port
        finally:
            raydp_tpu_torch.stop()
    finally:
        raydp_tpu.stop()


def test_world2_store_feed_fit_equals_the_reference(both_sessions,
                                                    monkeypatch):
    """Both packages' 2-rank gangs on the same rows, store-fed, with a
    gang-reduced eval: equal histories and parameters."""
    # The JAX package's ranks load the creator with cloudpickle: by value,
    # since they cannot import this test module.
    cloudpickle.register_pickle_by_value(
        sys.modules[glue_frame.__module__])

    def boom(*a, **k):
        raise AssertionError("driver-side _rows_range used in store mode")

    monkeypatch.setattr(te, "_rows_range", boom)
    train, evl = glue_frame(256, 4), glue_frame(64, 5)
    with time_limit(LIMIT_S):
        ref_ds = RefMLDataset.from_df(
            ref_rdf.from_pandas(train, num_partitions=4), num_shards=2)
        ref_eval = RefMLDataset.from_df(
            ref_rdf.from_pandas(evl, num_partitions=2), num_shards=2)
        ref = RefEstimator(num_workers=2, **parity_kwargs())
        ref.fit(ref_ds, ref_eval)

        ds = MLDataset.from_df(rdf.from_pandas(train, num_partitions=4),
                               num_shards=2)
        port_eval = MLDataset.from_df(rdf.from_pandas(evl, num_partitions=2),
                                      num_shards=2)
        port = TorchEstimator(num_workers=2, **parity_kwargs())
        spec = port._store_feed_spec(ds, port_eval, 2)
        assert spec is not None
        assert all(p is not None for p in spec["eval_plans"])
        port.fit(ds, port_eval)
    assert len(port.history) == 2 and "eval_acc" in port.history[-1]
    assert_same_fit(ref, port)
    np.testing.assert_array_equal(
        [h["train_loss"] for h in port.history],
        [h["train_loss"] for h in ref.history])
    assert torch.isfinite(torch.tensor(port.history[-1]["eval_loss"]))
