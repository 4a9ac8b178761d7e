"""The port's shuffle engine (``raydp_tpu_torch/dataframe``: the one-pass
partitioner, co-partitioning elision, the exchange's locality counters,
prefix limits, the schema cache, concurrent parquet) against
``tests/test_shuffle.py``.

Every case runs against the port, loaded by ``tests/torch_port_cases.py``
with its imports pointed at ``raydp_tpu_torch``; its ``forced_exchanges``
fixture gets pytest's ``monkeypatch`` through the harness, and its
cluster cases share one 2-worker port session for the module, as the
reference's module-scoped fixture does.
"""
import inspect

import pytest

import raydp_tpu_torch
from torch_port_cases import cases, load_port_module, run_case, time_limit

PORT_REFERENCE = load_port_module("test_shuffle.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
LIMIT_S = 120


@pytest.fixture(scope="module")
def port_session():
    s = raydp_tpu_torch.init(app_name="shuffletest", num_workers=2,
                             memory_per_worker="256MB")
    yield s
    raydp_tpu_torch.stop()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    uses_session = "session" in inspect.signature(
        getattr(PORT_REFERENCE, name)).parameters
    fixtures = ({"session": request.getfixturevalue("port_session")}
                if uses_session else None)
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request, fixtures=fixtures)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) == 28
