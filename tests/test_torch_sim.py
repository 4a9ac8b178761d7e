"""The port's control-plane simulator (``raydp_tpu_torch/sim``) against
``tests/test_sim.py`` and the JAX package's.

* The cases of ``tests/test_sim.py`` run against the port through
  ``tests/torch_port_cases.py`` (``sim``, ``control``, ``loadgen``,
  ``serve``, ``fault``, ``telemetry`` and ``utils`` pointed at the
  port): the virtual clock, the real autoscaler, arbiter and request
  queue on virtual time, traces replayed with their monitors and
  pathology detectors, the fault clauses on virtual time, the virtual
  knee sweep, the report and the dashboard's sim section. The
  million-arrival case stays slow, as in the reference. The reference's
  autouse fixture is repeated here.
* The clock-seam fence cases run the port's ``raydpcheck``
  (``raydp_tpu_torch/analysis``, R6) over fixture files under a
  ``raydp_tpu_torch/`` tree and over the port's own fenced modules (the
  harness points the test module's ``"raydp_tpu/..."`` path literals at
  the port). ``LEFT_FOR_ITEM_10`` is empty: no case is left out.
* ``python -m raydp_tpu_torch.sim``'s ``run``, ``report`` and ``knee``.
* The cross-package checks are in ``tests/test_torch_sim_parity.py``.
"""
import json

import pytest

from raydp_tpu_torch.control import arbiter as arbiter_mod
from raydp_tpu_torch.fault import inject as _inject
from raydp_tpu_torch.utils import clock as _clock
from raydp_tpu_torch.utils.profiling import metrics
from torch_port_cases import (
    case_params,
    cases,
    load_port_module,
    run_case,
    time_limit,
)

LEFT_FOR_ITEM_10 = ()
WHOLE = load_port_module("test_sim.py")
TEST_NAMES = tuple(n for n in vars(WHOLE)
                   if n.startswith("test_") and n not in LEFT_FOR_ITEM_10)
HELPERS = ("_kinds", "_invariants", "_ListProvisioner", "_PressureGroup",
           "_run_r6")
PORT_REFERENCE = load_port_module("test_sim.py", only=TEST_NAMES + HELPERS)
REFERENCE_CASES = cases(PORT_REFERENCE, TEST_NAMES)
LIMIT_S = 120


@pytest.fixture(autouse=True)
def _clean_world():
    metrics.reset()
    _inject.reset_for_tests()
    yield
    if _clock.is_virtual():
        _clock.uninstall()
    arbiter_mod.reset_for_tests()
    _inject.reset_for_tests()
    metrics.reset()


@pytest.mark.parametrize("name,params",
                         case_params(PORT_REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    names = [n for n in vars(WHOLE) if n.startswith("test_")]
    assert len(names) == 28 and LEFT_FOR_ITEM_10 == ()
    assert len(REFERENCE_CASES) == 28


def test_cli_runs_reports_and_sweeps(tmp_path, capsys):
    """``python -m raydp_tpu_torch.sim``: ``run`` writes the result JSON
    and exits 0 on a clean run, ``report`` renders it, ``knee`` sweeps."""
    from raydp_tpu_torch.sim.__main__ import main

    out = str(tmp_path / "run.json")
    assert main(["run", "--rps", "40", "--duration", "2", "--hosts", "2",
                 "--out", out]) == 0
    assert main(["report", out]) == 0
    knee = str(tmp_path / "knee.json")
    assert main(["knee", "--hosts", "1", "--max-batch", "1",
                 "--service-ms", "20", "--slo-ms", "100", "--out",
                 knee]) == 0
    text = capsys.readouterr().out
    assert "invariants: clean" in text and "sim knee:" in text
    with open(knee) as f:
        assert json.load(f)["kind"] == "sim_knee"
