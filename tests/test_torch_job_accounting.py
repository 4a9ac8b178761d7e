"""The port's accounting plane (``raydp_tpu_torch/telemetry``: job
contexts, the usage ledger, the event timeline, shard retention) and the
gang's health report against ``tests/test_job_accounting.py`` and
``tests/test_heartbeat_race.py::test_shipped_metrics_survive_worker_death``.

Every case runs against the port (``test_reference_case_on_port``),
loaded by ``tests/torch_port_cases.py``: its ``raydp_tpu.telemetry`` and
``raydp_tpu.spmd`` imports point at the port, and the heartbeat case
runs on a port session. The reference's autouse fixture (no ambient
job, a clean thread scope) is applied here to the port's accounting.
"""
import pytest

from raydp_tpu_torch.telemetry import accounting as acct
from torch_port_cases import cases, load_port_module, run_case, time_limit

PORT_REFERENCE = load_port_module("test_job_accounting.py")
REFERENCE_NAMES = tuple(n for n in dir(PORT_REFERENCE)
                        if n.startswith("test_"))
HEARTBEAT = load_port_module(
    "test_heartbeat_race.py",
    only=("test_shipped_metrics_survive_worker_death", "_session"))
HEARTBEAT_NAMES = ("test_shipped_metrics_survive_worker_death",)
LIMIT_S = 120
ALL_CASES = ([(PORT_REFERENCE,) + c for c in cases(PORT_REFERENCE,
                                                   REFERENCE_NAMES)]
             + [(HEARTBEAT,) + c for c in cases(HEARTBEAT,
                                                HEARTBEAT_NAMES)])


@pytest.fixture(autouse=True)
def _clean_ambient_job():
    """Each case starts with no ambient job and a clean thread scope."""
    prev = acct.process_job()
    acct.set_process_job(None)
    yield
    acct.set_process_job(prev)


@pytest.mark.parametrize("module,name,params",
                         [(c[0], c[2], c[3]) for c in ALL_CASES],
                         ids=[c[1] for c in ALL_CASES])
def test_reference_case_on_port(module, name, params, request):
    with time_limit(LIMIT_S):
        run_case(module, name, params, request)
