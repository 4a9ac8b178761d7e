"""A port replica group under the control plane and open-loop load, on
the CPU with a real replica process (``tests/test_torch_serve_models.
sum_model``).

The group is admitted by the arbiter with ``slots = replicas`` under a
high-priority job, serves a Poisson schedule through the load
generator's ``GroupTarget`` and a short one through ``HttpTarget`` on a
``ServeFrontend`` with no error, and its lease goes back on ``stop()``;
then a higher-priority gang's arrival preempts an admitted group, which
drains and stops, and the arrival takes its slot. A small file, so that
pytest-xdist's ``loadfile`` schedule runs it late, as
``tests/test_torch_serve_group.py``.
"""
import time

import pytest

from raydp_tpu_torch import control
from raydp_tpu_torch.loadgen import (
    GroupTarget,
    HttpTarget,
    poisson_schedule,
    run_schedule,
)
from raydp_tpu_torch.serve import ReplicaGroup, ServeFrontend
from raydp_tpu_torch.telemetry import accounting as acct
from raydp_tpu_torch.telemetry import events as events_mod
from raydp_tpu_torch.utils.profiling import metrics
from test_torch_serve_models import sum_model
from torch_port_cases import time_limit

LIMIT_S = 120
REGISTER_DEADLINE_S = 60.0


@pytest.fixture(autouse=True)
def _fresh_state():
    metrics.reset()
    control.reset_for_tests()
    yield
    control.reset_for_tests()
    metrics.reset()


def _wait_for(pred, what, deadline_s=REGISTER_DEADLINE_S):
    deadline = time.monotonic() + deadline_s
    while not pred():
        if time.monotonic() > deadline:
            pytest.fail(f"{what} within {deadline_s} s")
        time.sleep(0.05)


def test_admitted_group_serves_open_loop_load():
    arb = control.configure(2, admit_timeout_s=30.0)
    job = acct.mint_job("serve", priority=5)
    group = ReplicaGroup(replicas=1, model_fn=sum_model, device="cpu",
                         label="t-admitted", max_batch=8, slo_ms=5)
    with time_limit(LIMIT_S):
        with acct.job_scope(job):
            group.start()
        try:
            rep = arb.report()
            assert rep["in_use"] == 1
            assert rep["leases"][0]["job"] == job.job_id
            _wait_for(lambda: group.stats()["replicas_alive"] == 1,
                      "the replica did not register")
            res = run_schedule(GroupTarget(group),
                               poisson_schedule(60.0, 1.5, seed=4),
                               timeout_s=5.0)
            assert res.counts()["ok"] == len(res.outcomes) > 40
            assert res.latency_quantile(0.99) < 5.0
            assert set(res.phase_fractions()) >= {"queue_wait", "execute"}
            fe = ServeFrontend(group).start()
            try:
                http = run_schedule(
                    HttpTarget(f"http://127.0.0.1:{fe.port}"),
                    poisson_schedule(20.0, 1.0, seed=5), timeout_s=5.0)
            finally:
                fe.close()
            assert http.counts()["ok"] == len(http.outcomes) > 5
        finally:
            group.stop()
    assert arb.report()["in_use"] == 0
    assert arb.report()["states"][job.job_id] == "completed"


def test_higher_priority_gang_preempts_an_admitted_group():
    arb = control.configure(1, admit_timeout_s=60.0)
    group = ReplicaGroup(replicas=1, model_fn=sum_model, device="cpu",
                         label="t-victim")
    with time_limit(LIMIT_S):
        with acct.job_scope(acct.mint_job("low", priority=0)):
            group.start()
        try:
            _wait_for(lambda: group.stats()["replicas_alive"] == 1,
                      "the replica did not register")
            assert group.predict([2, 3]) == 5.0
            lease = arb.acquire(acct.mint_job("gang", priority=5), slots=1,
                                kind="gang")
            assert not group._started  # drained by the arbiter's callback
            lease.release()
        finally:
            group.stop()
    kinds = [r["name"] for r in events_mod.local_events()]
    assert "sched/preempt" in kinds and "serve/preempt" in kinds
    assert arb.report()["in_use"] == 0
