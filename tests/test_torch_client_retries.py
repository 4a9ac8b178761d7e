"""A second driver's reads of the master (``raydp_tpu_torch/cluster/
client.py``): the idempotent-retry loop's two env overrides and the
scheduler report.

* ``RAYDP_TPU_CLIENT_RETRIES`` and ``RAYDP_TPU_CLIENT_BACKOFF_S`` are read
  per call, with the reference's defaults (4 retries, 0.25 s doubling)
  and an unparsable value read as its default; a call makes the same
  number of attempts, and sleeps the same nominal delays, as the JAX
  package's ``_retry_idempotent`` under the same environment (each
  against its own transport's unavailable-peer error).
* ``RemoteCluster.scheduler_report`` (the master's ``SchedulerReport``)
  and the dashboard's scheduler section read the session's arbiter.
"""
import grpc
import pytest

import raydp_tpu.cluster.client as ref_client
import raydp_tpu_torch
from raydp_tpu_torch import control
from raydp_tpu_torch.cluster import client as port_client
from raydp_tpu_torch.cluster.client import RemoteCluster
from raydp_tpu_torch.cluster.rpc import RpcUnavailable
from raydp_tpu_torch.telemetry import accounting as acct


class _GrpcUnavailable(grpc.RpcError):
    def code(self):
        return grpc.StatusCode.UNAVAILABLE


def _attempts(module, error, monkeypatch, failures=100):
    """(calls made, nominal delays slept) of one retried call that fails
    ``failures`` times, jitter pinned to 0."""
    calls, slept = [], []
    monkeypatch.setattr(module.random, "uniform", lambda a, b: 0.0)
    monkeypatch.setattr(module.time, "sleep", slept.append)

    def fn():
        calls.append(1)
        if len(calls) <= failures:
            raise error
        return "ok"

    try:
        out = module._retry_idempotent(fn, "test call")
    except type(error):
        out = None
    return out, len(calls), slept


@pytest.mark.parametrize("retries,backoff,want_calls,want_slept", [
    (None, None, 5, [0.25, 0.5, 1.0, 2.0]),
    ("2", "0.1", 3, [0.1, 0.2]),
    ("0", "5", 1, []),
    ("bogus", "nan?", 5, [0.25, 0.5, 1.0, 2.0]),
])
def test_retry_env_read_per_call_as_the_reference(monkeypatch, retries,
                                                  backoff, want_calls,
                                                  want_slept):
    for name, value in ((port_client.CLIENT_RETRIES_ENV, retries),
                        (port_client.CLIENT_BACKOFF_ENV, backoff)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    got = _attempts(port_client, RpcUnavailable("down"), monkeypatch)
    want = _attempts(ref_client, _GrpcUnavailable(), monkeypatch)
    assert got == want == (None, want_calls, pytest.approx(want_slept))


def test_retry_recovers_once_the_master_answers(monkeypatch):
    monkeypatch.setenv(port_client.CLIENT_RETRIES_ENV, "3")
    monkeypatch.setenv(port_client.CLIENT_BACKOFF_ENV, "0.01")
    assert _attempts(port_client, RpcUnavailable("down"), monkeypatch,
                     failures=2)[:2] == ("ok", 3)


def test_remote_scheduler_report_is_the_sessions_arbiter():
    session = raydp_tpu_torch.init(app_name="sched-report", num_workers=1)
    try:
        arb = control.configure(3, admit_timeout_s=5.0)
        lease = arb.acquire(acct.mint_job("held"), slots=2, kind="gang",
                            label="g")
        remote = RemoteCluster(session.cluster.master.address)
        try:
            rep = remote.scheduler_report()
            local = session.cluster.scheduler_report()
            for r in (rep, local):
                assert r["enabled"] and r["capacity"] == 3
                assert r["in_use"] == 2 and r["queue_depth"] == 0
                assert [(l["job"], l["slots"], l["label"])
                        for l in r["leases"]] == [(lease.job.job_id, 2, "g")]
            dash = remote.dashboard_report()["control"]["scheduler"]
            assert dash["in_use"] == 2 and dash["capacity"] == 3
            assert session.cluster.dashboard_report()["control"][
                "scheduler"]["leases"][0]["job"] == lease.job.job_id
            lease.release()
            assert remote.scheduler_report()["in_use"] == 0
        finally:
            remote._client.close()
    finally:
        raydp_tpu_torch.stop()
        control.reset_for_tests()
