"""The port's multi-host planes (``raydp_tpu_torch/cluster``, ``store``,
``data``) against ``tests/test_multihost.py``: two virtual hosts on one
machine, node-scoped shm namespaces, per-node store agents, the
master's directory.

* Its cases run against the port, loaded by ``tests/torch_port_cases.py``
  with their imports pointed at ``raydp_tpu_torch``.
* ``test_mldataset_and_estimator_across_hosts`` trains the JAX
  package's ``JAXEstimator``; it is rewritten here on the port's
  ``Estimator`` (an MLP on the CPU, the same rows, batch and epochs),
  and ``test_mldataset_holder_survives_stop`` calls ``to_jax``, which
  the port names ``to_torch``: mirrored here on it.
"""
import numpy as np
import pandas as pd
import pytest

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.train import Estimator
from torch_port_cases import cases, load_port_module, run_case, time_limit

REWRITTEN = ("test_mldataset_and_estimator_across_hosts",
             "test_mldataset_holder_survives_stop")
PORT_REFERENCE = load_port_module("test_multihost.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE)
    if n.startswith("test_") and n not in REWRITTEN])
LIMIT_S = 120


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) + len(REWRITTEN) == 9


def test_mldataset_and_estimator_across_hosts():
    import torch

    session = raydp_tpu_torch.init(app_name="multihost-test", num_workers=2,
                                   num_virtual_nodes=2)
    try:
        with time_limit(LIMIT_S):
            rng = np.random.default_rng(1)
            a = rng.standard_normal(1024)
            b = rng.standard_normal(1024)
            y = 2 * a - 3 * b + 1
            df = rdf.from_pandas(pd.DataFrame({"a": a, "b": b, "y": y}),
                                 num_partitions=4)
            ds = MLDataset.from_df(df, num_shards=2)
            # blocks live on both hosts, and every shard materializes on
            # the driver
            assert {r.node_id for r in ds.blocks} == {"node-0", "node-1"}
            cols = ds.shard_columns(0, ["a", "b", "y"])
            assert len(cols["a"]) == ds.rows_per_shard
            assert session.cluster is not None

            torch.manual_seed(0)
            est = Estimator(
                model=raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1,
                                          device="cpu"),
                optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
                loss="mse", num_epochs=4, batch_size=256,
                feature_columns=["a", "b"], label_column="y", seed=0,
                device="cpu")
            history = est.fit_on_df(df)
            assert history[-1]["train_loss"] < history[0]["train_loss"]
    finally:
        raydp_tpu_torch.stop()


def test_mldataset_holder_survives_stop():
    """Holder-owned MLDataset blocks outlive worker teardown
    (``stop(del_obj_holder=False)``) and stay readable through
    ``to_torch``."""
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"a": rng.standard_normal(400),
                        "b": rng.standard_normal(400),
                        "label": rng.standard_normal(400)})
    raydp_tpu_torch.init(app_name="mlds-holder", num_workers=2,
                         memory_per_worker="256MB")
    try:
        with time_limit(LIMIT_S):
            ds = MLDataset.from_df(rdf.from_pandas(pdf, num_partitions=4),
                                   num_shards=2)
            loader = ds.to_torch(["a", "b"], "label", batch_size=100,
                                 rank=1, shuffle=False, device="cpu")
            assert sum(x.shape[0] for x, _ in loader) == ds.rows_per_shard
            # Shards survive worker teardown (holder ownership).
            raydp_tpu_torch.stop(del_obj_holder=False)
            loader2 = ds.to_torch(["a"], "label", batch_size=100, rank=0,
                                  shuffle=False, device="cpu")
            assert sum(x.shape[0] for x, _ in loader2) == ds.rows_per_shard
    finally:
        raydp_tpu_torch.stop()
