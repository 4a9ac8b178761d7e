"""The port's worker cluster (``raydp_tpu_torch/cluster``, ``store``)
against the JAX package's ``tests/test_request_dedup.py``,
``test_stress.py``, ``test_command_launcher.py`` and
``test_pod_roles.py``.

* Every case of the first three runs against the port, loaded by
  ``tests/torch_port_cases.py`` with its imports pointed at
  ``raydp_tpu_torch``: the worker's at-most-once ``RunTask`` dedup, the
  store and the session under concurrent load, and sessions whose
  workers and agents start through the ssh command builder (a shim
  ``ssh`` on ``PATH``; the ``ssh_shim_session`` fixture gets pytest's
  ``tmp_path`` and ``monkeypatch`` through the harness).
* ``test_pod_roles.py`` runs ``examples/pod_driver.py``, a script of the
  JAX package. Its case is mirrored here on the port: a driver process
  with ``num_workers=0`` on a fixed master port, and a host role that
  starts the port's store agent and two ETL workers for node ``pod-1``
  pointed at it; the driver waits for both and runs a ``groupBy``.
"""
import os
import subprocess
import sys

import pytest

from raydp_tpu_torch.cluster.rpc import RpcClient
from raydp_tpu_torch.utils.net import find_free_port
from torch_port_cases import cases, load_port_module, run_case, time_limit

MODULES = {name: load_port_module(f"test_{name}.py")
           for name in ("request_dedup", "stress", "command_launcher")}
REFERENCE_CASES = [(f"{mod}::{i}", mod, n, p)
                   for mod, module in MODULES.items()
                   for i, n, p in cases(module, [x for x in vars(module)
                                                 if x.startswith("test_")])]
LIMIT_S = 180
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("mod,name,params",
                         [c[1:] for c in REFERENCE_CASES],
                         ids=[c[0] for c in REFERENCE_CASES])
def test_reference_case_on_port(mod, name, params, request):
    with time_limit(LIMIT_S):
        run_case(MODULES[mod], name, params, request)


def test_cases_cover_the_reference_modules():
    counts = {mod: sum(1 for c in REFERENCE_CASES if c[1] == mod)
              for mod in MODULES}
    assert counts == {"request_dedup": 5, "stress": 3, "command_launcher": 4}


_POD_DRIVER = """
import sys, time
import numpy as np, pandas as pd
import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf

s = raydp_tpu_torch.init(app_name="pod-driver", num_workers=0,
                         bind_host="127.0.0.1", master_port=int(sys.argv[1]))
try:
    deadline = time.monotonic() + 90
    while time.monotonic() < deadline:
        if len(s.cluster.alive_workers()) >= 2:
            break
        time.sleep(0.5)
    workers = s.cluster.alive_workers()
    assert len(workers) >= 2, f"only {len(workers)} joined"
    print("workers:", [(w.worker_id, w.node_id) for w in workers])
    rng = np.random.default_rng(0)
    pdf = pd.DataFrame({"k": rng.integers(0, 7, 20_000),
                        "v": rng.standard_normal(20_000)})
    out = (rdf.from_pandas(pdf, num_partitions=8).groupBy("k")
           .agg({"v": "mean"}).to_pandas().sort_values("k"))
    want = pdf.groupby("k")["v"].mean().to_numpy()
    assert np.allclose(out["mean(v)"].to_numpy(), want)
    print("pod_driver driver OK")
finally:
    raydp_tpu_torch.stop()
"""


def test_driver_and_host_roles_cross_process():
    """``tests/test_pod_roles.py``'s case on the port (see the module
    docstring): workers of a host process join a ``num_workers=0``
    driver over the network and run its stage."""
    port = find_free_port()
    master = f"127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": REPO}
    driver = subprocess.Popen(
        [sys.executable, "-c", _POD_DRIVER, str(port)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    host = []
    try:
        # The host role's agent asks the master for the session's
        # namespace as it starts, so it starts once the master listens.
        assert RpcClient(master, "raydp.AppMaster").wait_ready(60.0)
        host.append(subprocess.Popen(
            [sys.executable, "-m", "raydp_tpu_torch.store.agent",
             "--node-id", "pod-1", "--master", master,
             "--bind-host", "127.0.0.1"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT))
        host += [subprocess.Popen(
            [sys.executable, "-m", "raydp_tpu_torch.cluster.worker_main",
             "--worker-id", f"pod-1-w{i}", "--master", master,
             "--node-id", "pod-1", "--bind-host", "127.0.0.1"],
            env=env, cwd=REPO, stdout=subprocess.DEVNULL,
            stderr=subprocess.STDOUT) for i in range(2)]
        out, err = driver.communicate(timeout=240)
        assert driver.returncode == 0, out[-2000:] + err[-2000:]
        assert "pod_driver driver OK" in out
        assert "pod-1" in out  # workers joined from the host
    finally:
        if driver.poll() is None:
            driver.kill()
        for p in host:
            p.terminate()
        for p in host:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
