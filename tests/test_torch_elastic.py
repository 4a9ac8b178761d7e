"""The port's ETL cluster recovery (``raydp_tpu_torch/cluster``) against
the JAX package's ``tests/test_elastic.py``, and the fault plan's task
hook in the port's worker (``cluster/worker_main.py``).

* Every case of ``tests/test_elastic.py`` runs against a port session
  (loaded by ``tests/torch_port_cases.py`` with its imports pointed at
  the port): a SIGKILLed worker respawned on its node, the restart
  budget per lineage and its sliding window, a ``mapPartitions`` and an
  ``MLDataset``'s shard resolution that complete through a worker kill.
* ``kill:worker=w0,task=2`` under a port session: worker ``w0`` dies as
  it starts its third task, and a ``mapPartitions`` over the session
  still completes with every row equal to numpy's.
* No test leaves a segment of a store it opened.
"""
import numpy as np
import pandas as pd
import pytest

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as torch_rdf
import raydp_tpu_torch.store.object_store as port_store
from raydp_tpu_torch import fault
from raydp_tpu_torch.store import shm
from raydp_tpu_torch.utils.profiling import metrics
from torch_port_cases import cases, load_port_module, run_case, time_limit

PORT_REFERENCE = load_port_module("test_elastic.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
LIMIT_S = 120


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


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) == 6


def _times_three(t):
    import pyarrow.compute as pc

    return t.set_column(0, "x", pc.multiply(t.column("x"), 3))


def test_task_kill_clause_under_map_partitions(monkeypatch):
    """The plan reaches the workers through their environment; ``w0``
    dies at its task 2 and the stage's tasks are retried elsewhere."""
    monkeypatch.setenv(fault.FAULT_PLAN_ENV, "kill:worker=w0,task=2")
    s = raydp_tpu_torch.init(app_name="elastic-task-kill", num_workers=2)
    try:
        with time_limit(LIMIT_S):
            pdf = pd.DataFrame({"x": np.arange(12_000)})
            df = torch_rdf.from_pandas(pdf, num_partitions=12)
            out = df.mapPartitions(_times_three).to_pandas()
            alive = {w.worker_id for w in s.cluster.alive_workers()}
    finally:
        raydp_tpu_torch.stop()
    out = out.sort_values("x").reset_index(drop=True)
    assert out["x"].tolist() == (pdf["x"] * 3).tolist()
    assert "w0" not in alive
    counters = metrics.snapshot().get("counters", {})
    assert counters.get("worker_restarts/w0", 0) >= 1
