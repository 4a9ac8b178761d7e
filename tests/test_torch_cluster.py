"""The port's session, worker cluster and object store
(``raydp_tpu_torch/{context,cluster,store,config}``) against the JAX
package's tests of the same modules.

* Every case of ``tests/test_cluster.py``, ``tests/test_object_store.py``
  and ``tests/test_placement.py``, and ``tests/test_config.py``'s two
  ``ClusterConfig`` cases, runs against the port: each module is loaded
  again with its imports pointed at the port (``tests/torch_port_cases.py``),
  so the port's sessions start real worker processes and its store real
  ``/dev/shm`` segments.
* No test leaves a segment behind: every object store the port opens in
  a test (the session's directory, a standalone store) must have no
  segment under its namespace when the test ends.
"""
import pytest

import raydp_tpu_torch.store.object_store as port_store
from raydp_tpu_torch.store import shm
from torch_port_cases import cases, load_port_module, run_case

MODULES = {
    "test_cluster.py": None,
    "test_object_store.py": None,
    "test_placement.py": None,
    "test_config.py": ("test_cluster_config_from_args",
                       "test_cluster_config_validation"),
}
REFERENCE_CASES = []
for _file, _only in MODULES.items():
    _module = load_port_module(_file, only=_only)
    for _id, _name, _params in cases(
            _module, [n for n in vars(_module) if n.startswith("test_")]):
        REFERENCE_CASES.append((f"{_file[:-3]}::{_id}", _module, _name,
                                _params))


@pytest.fixture(autouse=True)
def no_segment_left(monkeypatch):
    """Every store opened during the test has no segment left after it."""
    namespaces = []
    init = port_store.ObjectStore.__init__

    def recording_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        namespaces.append(self.namespace)

    monkeypatch.setattr(port_store.ObjectStore, "__init__", recording_init)
    yield
    left = [s for ns in set(namespaces)
            for s in shm.list_segments(f"rdp-{ns}-")]
    assert not left, f"segments left behind: {left}"


@pytest.mark.parametrize("module,name,params",
                         [(m, n, p) for _, m, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(module, name, params, request):
    run_case(module, name, params, request)


def test_cases_cover_the_reference_modules():
    """Each reference module contributes all of its cases (the two
    ``ClusterConfig`` ones of test_config.py)."""
    counts = {}
    for case_id, *_ in REFERENCE_CASES:
        counts[case_id.split("::")[0]] = counts.get(
            case_id.split("::")[0], 0) + 1
    assert counts == {"test_cluster": 7, "test_object_store": 8,
                      "test_placement": 9, "test_config": 2}
