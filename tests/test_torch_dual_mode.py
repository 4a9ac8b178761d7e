"""The port's DataFrame pipelines in both executor modes against
``tests/test_dual_mode.py``.

Every case runs against the port twice, once per value of the
reference's parametrized module fixture ``mode``: ``local`` (the
in-process executor) and ``cluster`` (a 2-worker port session started
and stopped around the case). ``tests/torch_port_cases.py`` expands the
fixture's params into cases and hands the fixture its ``request.param``.
"""
import pytest

from torch_port_cases import cases, load_port_module, run_case, time_limit

PORT_REFERENCE = load_port_module("test_dual_mode.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
LIMIT_S = 120


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_both_modes():
    assert len(REFERENCE_CASES) == 12
    assert sorted({i.rsplit("[", 1)[1] for i, _, _ in REFERENCE_CASES}) == [
        "cluster]", "local]"]
