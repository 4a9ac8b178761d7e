"""The port's typed configs (``raydp_tpu_torch/config``), the estimator's
``infeed_depth`` and ``rng_impl``, and the host-side torch dataset, on
the CPU.

* ``tests/test_config.py``'s ``DataConfig``/``TrainConfig`` cases run
  against the port (``"config"`` is in ``torch_port_cases.PORTED``).
* ``tests/test_resume.py::test_train_and_data_config_objects_wire``
  mirrored on the port's ``Estimator`` and MLP, and the same configs
  give the same estimator settings as the JAX package's ``JAXEstimator``.
* ``rng_impl`` takes the JAX package's names and refuses others;
  ``infeed_depth`` reaches the stream path's loaders (at least 1).
* ``tests/test_ml_dataset.py::test_to_torch`` mirrored on
  ``MLDataset.to_torch_dataset`` in both driver modes (the reference's
  autouse fixture, repeated here), and its ``get_worker_info`` split.
"""
import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu.config as ref_config
import raydp_tpu_torch.config as port_config
import raydp_tpu_torch.dataframe as rdf
from raydp_tpu.models import MLP as RefMLP
from raydp_tpu.train import JAXEstimator
from raydp_tpu_torch.config import DataConfig, TrainConfig
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.data.torch_adapter import TorchShardDataset
from raydp_tpu_torch.models import MLP
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.train import Estimator
from raydp_tpu_torch.train.estimator import RNG_IMPLS
from test_torch_client_mode import mode_session  # noqa: F401
from torch_port_cases import cases, load_port_module, run_case, time_limit

CONFIG = load_port_module(
    "test_config.py",
    only=("test_data_config_validation", "test_train_config_defaults"))
CONFIG_CASES = cases(CONFIG, ["test_data_config_validation",
                              "test_train_config_defaults"])
LIMIT_S = 120


@pytest.mark.parametrize("name,params", [(n, p) for _, n, p in CONFIG_CASES],
                         ids=[i for i, _, _ in CONFIG_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(CONFIG, name, params, request)


def _ds(n=2048, parts=4, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    df = rdf.from_pandas(
        pd.DataFrame({"a": a, "b": b, "y": 2 * a - 3 * b + 1}),
        num_partitions=parts)
    return MLDataset.from_df(df, num_shards=2)


def test_train_and_data_config_objects_wire():
    """test_resume.py's case on the port's Estimator."""
    tc = TrainConfig(num_epochs=2, seed=9, max_failures=1,
                     log_every_steps=0)
    dc = DataConfig(batch_size=128, shuffle=False, prefetch=1)
    est = Estimator(
        model=MLP(2, hidden=(8,), out_dim=1, device="cpu"),
        loss="mse",
        feature_columns=["a", "b"],
        label_column="y",
        train_config=tc,
        data_config=dc,
        device="cpu",
    )
    assert est.num_epochs == 2
    assert est.seed == 9
    assert est.batch_size == 128
    assert est.shuffle is False
    assert est.max_failures == 1
    # Explicitly configured retries switch "donation" off so they work.
    assert est.donate_state is False
    history = est.fit(_ds())
    assert len(history) == 2
    assert history[-1]["train_loss"] < history[0]["train_loss"]


SETTINGS = ("num_epochs", "seed", "log_every", "checkpoint_dir",
            "max_failures", "save_every_steps", "batch_size", "shuffle",
            "prefetch", "drop_last", "donate_state", "infeed_depth",
            "rng_impl")


@pytest.mark.parametrize("train,data", [
    (dict(num_epochs=3, seed=4, log_every_steps=7, checkpoint_dir="/ck",
          max_failures=2, save_every_steps=5),
     dict(batch_size=32, shuffle=True, prefetch=0, drop_last=True)),
    (dict(), dict()),
    (dict(max_failures=0), None),
    (None, dict(batch_size=8, prefetch=3)),
], ids=["both", "defaults", "train-only", "data-only"])
def test_overrides_equal_the_reference(train, data, tmp_path):
    """The same TrainConfig/DataConfig over the same scalar arguments:
    every setting they name is the JAX package's."""
    scalars = dict(num_epochs=9, seed=1, log_every=2, batch_size=64,
                   shuffle=False, prefetch=5, drop_last=False,
                   infeed_depth=3, rng_impl="rbg",
                   checkpoint_dir=str(tmp_path))

    def configs(mod, mesh):
        tc = None if train is None else mod.TrainConfig(mesh=mesh, **train)
        dc = None if data is None else mod.DataConfig(**data)
        return dict(train_config=tc, data_config=dc)

    ref = JAXEstimator(model=RefMLP(hidden=(4,), out_dim=1), **scalars,
                       **configs(ref_config, ref_config.TrainConfig().mesh))
    port = Estimator(model=MLP(2, hidden=(4,), out_dim=1, device="cpu"),
                     **scalars, **configs(port_config, MeshSpec()),
                     device="cpu")
    assert ({k: getattr(port, k) for k in SETTINGS}
            == {k: getattr(ref, k) for k in SETTINGS})
    assert port.mesh_spec.size == ref.mesh_spec.size == 1


def test_rng_impl_names():
    for name in RNG_IMPLS:
        est = Estimator(model=MLP(2, hidden=(4,), out_dim=1, device="cpu"),
                        rng_impl=name, device="cpu")
        assert est.rng_impl == name
    with pytest.raises(ValueError, match="rng_impl"):
        Estimator(model=MLP(2, hidden=(4,), out_dim=1, device="cpu"),
                  rng_impl="philox", device="cpu")


@pytest.mark.parametrize("depth,want", [(1, 1), (4, 4), (0, 1)])
def test_infeed_depth_reaches_the_loaders(depth, want):
    est = Estimator(model=MLP(2, hidden=(4,), out_dim=1, device="cpu"),
                    feature_columns=["a", "b"], label_column="y",
                    infeed_depth=depth, device="cpu")
    loaders = est._loaders(_ds(64, 2), ["a", "b"], "y", shuffle=True,
                           drop_last=False)
    assert [ld.infeed_depth for ld in loaders] == [want, want]


def _frame(n=1000, parts=4):
    rng = np.random.default_rng(0)
    return rdf.from_pandas(
        pd.DataFrame({"a": rng.standard_normal(n),
                      "b": rng.standard_normal(n),
                      "label": rng.standard_normal(n)}),
        num_partitions=parts)


def test_to_torch_dataset_both_modes(mode_session):  # noqa: F811
    """test_ml_dataset.py::test_to_torch on to_torch_dataset."""
    with time_limit(LIMIT_S):
        ds = MLDataset.from_df(_frame(256, 2), num_shards=1)
        tds = ds.to_torch_dataset(["a", "b"], "label", batch_size=128,
                                  shuffle=False)
        batches = list(tds)
    assert isinstance(tds, torch.utils.data.IterableDataset)
    assert len(batches) == 2 == len(tds)
    assert isinstance(batches[0][0], torch.Tensor)
    assert batches[0][0].shape == (128, 2)
    assert batches[0][0].device.type == "cpu"


def test_worker_split_is_round_robin(monkeypatch):
    """Under a DataLoader of 3 workers each worker yields every third
    batch, so the workers together yield each batch once."""
    ds = MLDataset.from_df(_frame(100, 2), num_shards=1)
    tds = TorchShardDataset(ds, 0, ["a", "b"], "label", 10, False, 5)
    everything = [x for x, _ in tds]
    got = []
    for wid in range(3):
        info = type("Info", (), {"id": wid, "num_workers": 3})()
        monkeypatch.setattr(torch.utils.data, "get_worker_info",
                            lambda info=info: info)
        got.append([x for x, _ in tds])
    assert [len(g) for g in got] == [4, 3, 3]
    for wid, g in enumerate(got):
        for i, x in enumerate(g):
            torch.testing.assert_close(x, everything[wid + 3 * i],
                                       rtol=0, atol=0)
