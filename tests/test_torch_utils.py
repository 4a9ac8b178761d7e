"""The port's package surface against the JAX package's.

* Every case of ``tests/test_utils.py`` (memory sizes, block division,
  ``split_sizes``) runs against ``raydp_tpu_torch.utils``, loaded by
  ``tests/torch_port_cases.py`` with its imports pointed at the port.
* Every name in the ``__all__`` of the reference's ``raydp_tpu``,
  ``raydp_tpu.utils``, ``raydp_tpu.cluster``, ``raydp_tpu.telemetry``,
  ``raydp_tpu.control``, ``raydp_tpu.loadgen`` and ``raydp_tpu.sim``
  resolves on the port's counterpart, but for the names of modules
  still to port (ROADMAP Queue A items 7-10), listed in ``UNPORTED``:
  none of these packages exports one today.
* The lazy exports keep ``import raydp_tpu_torch`` and its ``utils``
  and ``cluster`` packages free of torch.
"""
import importlib
import os
import subprocess
import sys

import pytest

from torch_port_cases import cases, load_port_module, run_case

PORT_REFERENCE = load_port_module("test_utils.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
PACKAGES = ("", ".utils", ".cluster", ".telemetry", ".control", ".loadgen",
            ".sim", ".config", ".models")
# Names of a reference package's __all__ that belong to modules the port
# has not taken yet, by package.
UNPORTED = {pkg: () for pkg in PACKAGES}


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) >= 20


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: "raydp_tpu" + p)
def test_reference_exports_resolve_on_port(pkg):
    ref = importlib.import_module("raydp_tpu" + pkg)
    port = importlib.import_module("raydp_tpu_torch" + pkg)
    missing = [n for n in ref.__all__
               if n not in UNPORTED[pkg] and not hasattr(port, n)]
    assert not missing, missing
    assert set(ref.__all__) - set(UNPORTED[pkg]) <= set(port.__all__)


def test_version_is_the_ports_own():
    import raydp_tpu
    import raydp_tpu_torch

    assert raydp_tpu_torch.__version__ == raydp_tpu.__version__


def test_lazy_exports_load_no_torch():
    code = ("import sys\n"
            "import raydp_tpu_torch, raydp_tpu_torch.utils as u\n"
            "import raydp_tpu_torch.cluster as c\n"
            "from raydp_tpu_torch.utils import split_sizes, BlockSlice\n"
            "from raydp_tpu_torch.cluster import Cluster, place\n"
            "assert raydp_tpu_torch.__version__\n"
            "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"], out.stdout


def test_start_log_splits_a_process_start(tmp_path):
    """With ``RAYDP_TPU_START_LOG`` set, a process logs its start's parts
    (``raydp_tpu_torch/utils/startup.py``): ``up`` from its creation,
    ``import torch`` by the import hook, the model, the optimizer and the
    first step by the estimator; without it, nothing."""
    from raydp_tpu_torch.utils import startup

    code = ("import numpy as np, pyarrow as pa\n"
            "import raydp_tpu_torch\n"
            "from raydp_tpu_torch.data import MLDataset\n"
            "from raydp_tpu_torch.models.mlp import MLP\n"
            "from raydp_tpu_torch.train import Estimator\n"
            "est = Estimator(model=MLP(2, hidden=(4,), out_dim=1, "
            "device='cpu'), loss='mse', num_epochs=1, batch_size=8, "
            "feature_columns=['a', 'b'], label_column='y', device='cpu', "
            "epoch_mode='stream')\n"
            "ones = np.ones(16, np.float32)\n"
            "est.fit(MLDataset([pa.table({'a': ones, 'b': ones, "
            "'y': ones})], 1))\n")
    env = dict(os.environ, **{startup.ENV: str(tmp_path)})
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    (row,) = startup.read_starts(str(tmp_path))
    assert row["role"] == "python -c"
    for part in ("up", "torch", "model", "optimizer", "first_step"):
        assert 0 <= row[part] <= row["total"], (part, row)
    assert abs(sum(row[p] for p in startup.PARTS if p in row)
               + row["other"] - row["total"]) < 1e-6
    before = sorted(os.listdir(tmp_path))
    env[startup.ENV] = ""
    subprocess.run([sys.executable, "-c", code], env=env, check=True,
                   timeout=120)
    assert sorted(os.listdir(tmp_path)) == before
