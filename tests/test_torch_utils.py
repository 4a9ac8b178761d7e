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
import subprocess
import sys

import pytest

from torch_port_cases import cases, load_port_module, run_case

PORT_REFERENCE = load_port_module("test_utils.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
PACKAGES = ("", ".utils", ".cluster", ".telemetry", ".control", ".loadgen",
            ".sim", ".config")
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
