"""The port's client mode (``raydp_tpu_torch.connect``,
``raydp_tpu_torch/cluster/client.py``) against the JAX package's tests of
it, and the object-store ``MLDataset`` in both driver modes.

* ``tests/test_client_mode.py``'s cases run against the port, loaded
  with every ``raydp_tpu`` name pointed at the port
  (``tests/torch_port_cases.py``), so its second driver is a subprocess
  that calls ``raydp_tpu_torch.connect``: the pipeline in both modes,
  refs a client put readable by the owning driver, the connect guard,
  and the ``MLDataset`` round trip in both modes.
* Its estimator case, on the port's ``Estimator`` with a torch MLP on
  ``device="cpu"``, in both modes: 4 epochs, the loss falls.
* The pipeline's numbers from a port client equal those of the JAX
  package's direct run on the same rows.
* A module-scoped two-mode session (in this process, or in a host
  subprocess this process connects to; 2 workers on 2 virtual nodes)
  runs every case of ``tests/test_reverse_path.py`` on the port, and
  ``from_refs``, ``schema``, ``shard_tables`` and ``locality() == 1.0``
  on the 2 nodes in both modes.

Each test runs under a time limit of its own (``LIMIT_S``).
"""
import select
import subprocess
import sys
import time

import numpy as np
import pandas as pd
import pytest

import raydp_tpu_torch
from torch_port_cases import cases, load_port_module, run_case, time_limit

CLIENT_MODE = load_port_module("test_client_mode.py")
CLIENT_CASES = cases(CLIENT_MODE, [
    "test_pipeline_both_driver_modes",
    "test_client_refs_visible_to_owning_driver",
    "test_connect_guard_in_process_with_live_session",
    "test_ml_dataset_roundtrip_both_driver_modes",
])
REVERSE = load_port_module("test_reverse_path.py")
REVERSE_CASES = cases(
    REVERSE, [n for n in vars(REVERSE) if n.startswith("test_")])
# Each test's own limit, in seconds: every test here starts processes.
LIMIT_S = 150

# The reference's estimator case on the port: a torch MLP on the CPU.
FIT_PIPELINE = """
def run_fit():
    import numpy as np
    import pandas as pd
    import torch
    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.models import MLP
    from raydp_tpu_torch.train import Estimator

    rng = np.random.default_rng(1)
    pdf = pd.DataFrame({
        "a": rng.standard_normal(512),
        "b": rng.standard_normal(512),
    })
    pdf["y"] = 2.0 * pdf.a - pdf.b
    est = Estimator(
        MLP(2, hidden=(8,), device="cpu",
            generator=torch.Generator().manual_seed(7)),
        optimizer=lambda p: torch.optim.Adam(p, lr=1e-2),
        num_epochs=4, batch_size=64,
        feature_columns=["a", "b"], label_column="y", seed=7, device="cpu",
    )
    hist = est.fit_on_df(
        rdf.from_pandas(pdf, num_partitions=2), num_shards=2
    )
    return {
        "first": float(hist[0]["train_loss"]),
        "last": float(hist[-1]["train_loss"]),
        "epochs": len(hist),
    }
"""


@pytest.fixture(autouse=True)
def _time_limit():
    with time_limit(LIMIT_S):
        yield


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in CLIENT_CASES],
                         ids=[i for i, _, _ in CLIENT_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(CLIENT_MODE, name, params, request)


def test_cases_cover_the_reference_modules():
    assert len(CLIENT_CASES) == 6
    assert len(REVERSE_CASES) == 6


@pytest.fixture
def session():
    s = raydp_tpu_torch.init(app_name="client-mode-test", num_workers=2)
    yield s
    raydp_tpu_torch.stop()


@pytest.mark.parametrize("mode", ["direct", "client"])
def test_estimator_fit_both_driver_modes(session, mode):
    out = CLIENT_MODE._run_in_mode(session, mode, FIT_PIPELINE, "run_fit")
    assert out["epochs"] == 4
    assert out["last"] < out["first"], out  # loss must decrease


def test_client_pipeline_equals_jax_direct_run(session):
    """The reference module's pipeline, run by a port client, gives the
    numbers the JAX package gives running it in its own process: counts
    and keys equal, sums within 1e-9 (pyarrow's multithreaded group-by
    adds a group's rows in an order that varies run to run, as
    ``tests/test_torch_dataframe.py`` allows)."""
    import raydp_tpu
    import test_client_mode as jax_client_mode

    got = CLIENT_MODE._run_in_mode(session, "client", CLIENT_MODE.PIPELINE,
                                   "run_pipeline")
    jax_session = raydp_tpu.init(app_name="client-mode-jax", num_workers=2)
    try:
        want = jax_client_mode._run_in_mode(
            jax_session, "direct", jax_client_mode.PIPELINE, "run_pipeline")
    finally:
        raydp_tpu.stop()
    assert got.keys() == want.keys()
    for key, value in want.items():
        if isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=1e-9,
                                       err_msg=key)
        else:
            assert got[key] == value, key


# -- one session a mode, for the reverse path and locality ----------------

_HOST_SCRIPT = """\
import sys
import raydp_tpu_torch

s = raydp_tpu_torch.init(app_name="client-mode-host", num_workers=2,
                         num_virtual_nodes=2)
print("ADDR " + s.cluster.master.address, flush=True)
sys.stdin.read()  # the parent closing the pipe is the shutdown signal
raydp_tpu_torch.stop()
"""


@pytest.fixture(scope="module", params=["inprocess", "client"])
def mode_session(request):
    """A live 2-worker session on 2 virtual nodes in both driver modes:
    in this process, or in a host subprocess that this process attaches
    to with ``connect``."""
    if request.param == "inprocess":
        s = raydp_tpu_torch.init(app_name="mode-inprocess", num_workers=2,
                                 num_virtual_nodes=2)
        yield s
        raydp_tpu_torch.stop()
        return
    proc = subprocess.Popen([sys.executable, "-c", _HOST_SCRIPT],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                            text=True)

    def teardown():
        try:
            proc.stdin.close()
            proc.wait(timeout=30)
        except Exception:
            proc.kill()
            proc.wait()

    addr, buf = None, ""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline and proc.poll() is None:
        ready, _, _ = select.select([proc.stdout], [], [], 5)
        if not ready:
            continue
        line = proc.stdout.readline()
        if not line:
            break
        buf += line
        if line.startswith("ADDR "):
            addr = line.split(None, 1)[1].strip()
            break
    if not addr:
        teardown()
        pytest.fail(f"client-mode host failed to start within 60s: {buf!r}")
    try:
        s = raydp_tpu_torch.connect(addr)
    except BaseException:
        teardown()
        raise
    yield s
    raydp_tpu_torch.stop()
    teardown()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REVERSE_CASES],
                         ids=[i for i, _, _ in REVERSE_CASES])
def test_reverse_path_case_both_modes(mode_session, name, params, request):
    run_case(REVERSE, name, params, request,
             fixtures={"session": mode_session})


def test_from_refs_schema_and_shard_tables_both_modes(mode_session):
    import pyarrow as pa

    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.data import MLDataset

    pdf = pd.DataFrame({"i": np.arange(300, dtype=np.int64),
                        "f": np.linspace(0.0, 1.0, 300)})
    df = rdf.from_pandas(pdf, num_partitions=3)
    ds = MLDataset.from_refs(df.to_object_refs(), num_shards=2)
    assert ds.schema() == df.schema
    for r in range(2):
        tables = ds.shard_tables(r)
        assert all(isinstance(t, pa.Table) for t in tables)
        merged = pa.concat_tables(tables)
        np.testing.assert_array_equal(merged.column("i").to_numpy(),
                                      ds.shard_columns(r, ["i"])["i"])
        assert merged.num_rows == ds.rows_per_shard
    seen = np.concatenate([ds.shard_columns(r, ["i"])["i"]
                           for r in range(2)])
    assert set(seen.tolist()) == set(range(300))


def test_locality_on_two_virtual_nodes_both_modes(mode_session):
    """``tests/test_locality.py``'s two-host case on the mode's session:
    blocks on both nodes, a fully local plan, shards still readable."""
    import raydp_tpu_torch.dataframe as rdf
    from raydp_tpu_torch.data import MLDataset

    rng = np.random.default_rng(1)
    pdf = pd.DataFrame({"a": rng.standard_normal(4000),
                        "y": rng.standard_normal(4000)})
    df = rdf.from_pandas(pdf, num_partitions=4)
    ds = MLDataset.from_df(df, num_shards=2, rank_nodes=["node-0", "node-1"])
    assert set(ds.block_nodes) == {"node-0", "node-1"}
    assert ds.locality() == 1.0
    total = sum(len(ds.shard_columns(r, ["a"])["a"]) for r in range(2))
    assert total == 2 * ds.rows_per_shard
    assert len(mode_session.cluster.alive_workers()) == 2
