"""The port's DataFrame engine on its session's worker processes
(``ClusterExecutor``, ``raydp_tpu_torch/dataframe/executor.py``) against
the JAX package's on its own.

* Every case of ``tests/test_dataframe_cluster.py`` runs against the
  port, on one port session of 2 workers for the module (the reference's
  module-scoped fixture), its pipelines' functions shipped to the
  workers by the closure carrier.
* The same pipelines run through both engines' sessions at once, over
  the same pandas input made from a seed: ``tests/test_dataframe.py``'s
  taxi pipeline, a groupBy and a broadcast and a shuffle join. Outputs
  are compared sorted by every column (the cluster's exchanges order
  rows by worker arrival), floats within rtol 1e-9 (as
  ``tests/test_torch_dataframe.py``).
* ``chip_smoke``'s taxi ETL on the port's cluster equals the numpy
  features exactly (the haversine within its rtol), and afterwards no
  worker has imported torch or can see a CUDA device.
* Each session is stopped by its fixture, which then checks that no
  segment of the port session's namespace is left under the shm
  directory.
"""
import os
import sys

import numpy as np
import pandas as pd
import pytest

import raydp_tpu
import raydp_tpu.dataframe as jax_rdf
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
from raydp_tpu_torch.dataframe.executor import ClusterExecutor
from raydp_tpu_torch.store import shm
from torch_port_cases import cases, load_port_module, run_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

PORT_REFERENCE = load_port_module("test_dataframe_cluster.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE) if n.startswith("test_")])
PORT_TAXI = load_port_module("test_dataframe.py").nyc_taxi_preprocess


@pytest.fixture(scope="module")
def port_session():
    s = raydp_tpu_torch.init(app_name="port-df", num_workers=2,
                             memory_per_worker="256MB")
    namespace = s.cluster.namespace
    yield s
    raydp_tpu_torch.stop()
    assert shm.list_segments(f"rdp-{namespace}-") == []


@pytest.fixture(scope="module")
def both_sessions(port_session):
    s = raydp_tpu.init(app_name="jax-df", num_workers=2,
                       memory_per_worker="256MB")
    yield s, port_session
    raydp_tpu.stop()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request, port_session):
    run_case(PORT_REFERENCE, name, params, request,
             fixtures={"session": port_session})


def _sorted(pdf: pd.DataFrame) -> pd.DataFrame:
    cols = sorted(pdf.columns)
    return pdf[cols].sort_values(cols).reset_index(drop=True)


def _assert_same(got: pd.DataFrame, want: pd.DataFrame) -> None:
    got, want = _sorted(got), _sorted(want)
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for c in want.columns:
        if pd.api.types.is_float_dtype(want[c]):
            np.testing.assert_allclose(got[c].to_numpy(), want[c].to_numpy(),
                                       rtol=1e-9, err_msg=c)
        else:
            assert got[c].tolist() == want[c].tolist(), c


def _numbers(seed=4, n=3000):
    rng = np.random.default_rng(seed)
    return pd.DataFrame({
        "k": rng.integers(0, 13, n),
        "v": rng.integers(-100, 100, n),
        "x": rng.standard_normal(n),
    })


def _pipelines(rdf, taxi_fn, numbers, dims, taxi):
    df = rdf.from_pandas(numbers, num_partitions=4)
    dim = rdf.from_pandas(dims, num_partitions=2)
    return {
        "taxi": taxi_fn(rdf.from_pandas(taxi, num_partitions=4)),
        "groupby": df.groupBy("k").agg(("v", "sum"), ("x", "mean"),
                                       ("x", "max")),
        "broadcast_join": df.join(dim, on="k"),
        "shuffle_join": df.join(dim, on="k", how="outer"),
    }


def test_engines_agree_on_their_sessions(both_sessions):
    from tests.test_dataframe import _fake_taxi
    from tests.test_dataframe import nyc_taxi_preprocess as jax_taxi

    numbers = _numbers()
    dims = pd.DataFrame({"k": np.arange(0, 16, dtype=np.int64),
                         "w": np.arange(16) * 0.5})
    taxi = _fake_taxi(1500, seed=5)
    want = _pipelines(jax_rdf, jax_taxi, numbers, dims, taxi)
    got = _pipelines(torch_rdf, PORT_TAXI, numbers, dims, taxi)
    for name in want:
        assert isinstance(got[name]._executor, ClusterExecutor), name
        _assert_same(got[name].to_pandas(), want[name].to_pandas())


def test_taxi_etl_on_workers_without_torch(port_session):
    table = chip_smoke.synthetic_taxi_table(np, 20_000, seed=3)
    df = torch_rdf.from_arrow(table, num_partitions=4)
    assert isinstance(df._executor, ClusterExecutor)
    out = chip_smoke.nyc_taxi_preprocess(torch_rdf, df)
    wrong = chip_smoke.taxi_etl_mismatch(
        np, out.to_arrow(), chip_smoke.taxi_features_numpy(np, table))
    assert wrong is None, wrong

    def probe(ctx):
        import os
        import sys

        return ("torch" in sys.modules,
                os.environ.get("CUDA_VISIBLE_DEVICES"))

    cluster = port_session.cluster
    seen = [cluster.submit(probe, worker_id=w.worker_id)
            for w in cluster.alive_workers()]
    assert seen == [(False, "")] * 2
