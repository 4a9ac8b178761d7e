"""The port's arbiter (``raydp_tpu_torch/control/arbiter.py``) and its
hooks in ``fit_spmd`` and ``SPMDJob`` against ``tests/test_scheduler.py``.

* Its 13 unit cases (priority order, the DWRR tie-break from the usage
  ledger, shedding, admission timeouts, preemption and its deadline,
  lease TTLs, stage-gate reentrancy, the report, elastic resize) run
  against the port, loaded by ``tests/torch_port_cases.py`` with
  ``control``, ``telemetry`` and ``utils`` pointed at the port. The
  reference's autouse fixture is repeated here (the harness resolves
  only a case's own arguments).
* Its two end-to-end tenancy cases fit ``JAXEstimator`` gangs from a
  factory the harness cannot rewrite (a JAX model, orbax checkpoint
  directories), so they are mirrored on the port with the torch factory
  of ``tests/test_torch_fault_tolerance.py`` (``MLP(hidden=(16,),
  out_dim=1)``, Adam 3e-2, batch 128, the reference's rows), gloo CPU
  ranks and ``.pt`` checkpoints: a high-priority arrival preempts a
  low-priority gang mid-epoch, whose resumed parameters equal an
  unpreempted run's under ``torch.equal``; and a gang that exhausts its
  restart budget releases its slots to a queued tenant. The reference
  marks the first slow; here it runs in the tier-1 gate (~30 s on the
  CPU), as every port file that names the port's telemetry must
  (``tests/test_torch_telemetry.py::test_port_telemetry_tests_run_in_tier1``),
  and it needs the accounting plane's job priorities.
* ``fit_spmd`` with ``RAYDP_TPU_SCHED_CAPACITY`` set takes its lease and
  gives it back.
"""
import glob
import os
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

import raydp_tpu_torch
import raydp_tpu_torch.dataframe as rdf
from raydp_tpu_torch import control
from raydp_tpu_torch.data import MLDataset
from raydp_tpu_torch.parallel import MeshSpec
from raydp_tpu_torch.spmd.job import SPMDJobError
from raydp_tpu_torch.telemetry import accounting as acct
from raydp_tpu_torch.telemetry import events as events_mod
from raydp_tpu_torch.train import Estimator, fit_spmd
from torch_port_cases import (
    case_params,
    cases,
    load_port_module,
    run_case,
    time_limit,
)

MIRRORED = ("test_two_tenants_preempt_resume_loss_parity",
            "test_budget_exhaustion_sheds_capacity_to_queued_work")
UNIT_NAMES = (
    "test_disabled_arbiter_is_inert", "test_priority_orders_admission",
    "test_dwrr_deficit_breaks_priority_ties",
    "test_shed_on_max_queue_carries_depth_and_eta",
    "test_admission_timeout_raises_busy",
    "test_oversized_request_is_rejected_not_queued_forever",
    "test_preempts_lower_priority_victim_and_resumes",
    "test_preempt_deadline_reclaims_hung_victim",
    "test_lease_ttl_reclaims_unrenewed_lease",
    "test_ttl_reap_racing_release_does_not_double_free",
    "test_stage_gate_turns_are_reentrant_and_leaseholder_passthrough",
    "test_scheduler_report_shape_and_cluster_delegation",
    "test_elastic_resize_returns_slots")
PORT_REFERENCE = load_port_module(
    "test_scheduler.py",
    only=UNIT_NAMES + ("_counter", "_acquire_in_thread", "_wait_for"))
REFERENCE_CASES = cases(PORT_REFERENCE, UNIT_NAMES)
LIMIT_S = 60
GANG_LIMIT_S = 300


@pytest.fixture(autouse=True)
def _clean_arbiter(monkeypatch):
    for var in (control.SCHED_CAPACITY_ENV, control.SCHED_MAX_QUEUE_ENV,
                control.SCHED_ADMIT_TIMEOUT_ENV, control.SCHED_LEASE_TTL_ENV,
                control.SCHED_PREEMPT_TIMEOUT_ENV, control.SCHED_PRESSURE_ENV):
        monkeypatch.delenv(var, raising=False)
    control.reset_for_tests()
    yield
    control.reset_for_tests()


@pytest.mark.parametrize("name,params",
                         case_params(PORT_REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    names = [n for n in vars(load_port_module("test_scheduler.py"))
             if n.startswith("test_")]
    assert sorted(names) == sorted(UNIT_NAMES + MIRRORED)
    assert len(REFERENCE_CASES) + len(MIRRORED) == 15


# -- the end-to-end tenancy cases, mirrored ---------------------------------


def _factory(ckpt_dir=None, num_epochs=2, save_every_steps=0):
    """``tests/test_scheduler.py``'s factory on the port: the torch MLP
    of ``tests/test_torch_fault_tolerance.py``, seeded in the rank."""
    def make_estimator():
        import torch.distributed as dist

        torch.manual_seed(0)
        model = raydp_tpu_torch.MLP(2, hidden=(16,), out_dim=1, device="cpu")
        world = dist.get_world_size() if dist.is_initialized() else 1
        return Estimator(
            model=model, optimizer=lambda p: torch.optim.Adam(p, lr=3e-2),
            loss="mse", num_epochs=num_epochs, batch_size=128,
            feature_columns=["a", "b"], label_column="y",
            mesh=MeshSpec(dp=world), seed=0, shuffle=False,
            epoch_mode="stream", checkpoint_dir=ckpt_dir,
            save_every_steps=save_every_steps, device="cpu")

    return make_estimator


def _ds(n=1024, shards=1):
    """``tests/test_scheduler.py``'s rows, through the port's engine."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(n)
    b = rng.standard_normal(n)
    pdf = pd.DataFrame({"a": a, "b": b, "y": 2 * a - 3 * b + 1})
    return MLDataset.from_df(rdf.from_pandas(pdf, num_partitions=shards * 2),
                             num_shards=shards)


def _fit(*args, **kwargs):
    return fit_spmd(*args, device="cpu", **kwargs)


def _wait_for(pred, timeout):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.05)
    return pred()


def _kinds():
    return [r["name"] for r in events_mod.local_events()]


def test_two_tenants_preempt_resume_loss_parity(tmp_path):
    """A high-priority arrival evicts the low-priority gang mid-epoch
    through the drain path, trains on the freed slot, and the victim
    resumes from its emergency checkpoint to the parameters and loss of
    an unpreempted run (``torch.equal``)."""
    ds = _ds(n=4096)
    arrival_ds = _ds(n=512)
    victim_env = {"RAYDP_TPU_CKPT_KEEP": "0"}
    with time_limit(GANG_LIMIT_S):
        clean = _fit(_factory(str(tmp_path / "clean"), num_epochs=8,
                              save_every_steps=2), ds, world_size=1,
                     env=victim_env, timeout=300)
    control.configure(capacity=1, admit_timeout_s=240.0)
    victim_dir = str(tmp_path / "victim")
    victim_out = {}

    def run_victim():
        with acct.job_scope(acct.mint_job("victim", priority=0)):
            try:
                victim_out["res"] = _fit(
                    _factory(victim_dir, num_epochs=8, save_every_steps=2),
                    ds, world_size=1, env=victim_env, timeout=300,
                    checkpoint_dir=victim_dir)
            except Exception as exc:  # recorded for the asserts
                victim_out["err"] = exc

    vt = threading.Thread(target=run_victim, daemon=True)
    vt.start()
    assert _wait_for(lambda: os.path.isfile(
        os.path.join(victim_dir, "step_mid_2.pt")), 240.0), \
        "victim never reached its first mid checkpoint"
    with time_limit(GANG_LIMIT_S):
        with acct.job_scope(acct.mint_job("arrival", priority=5)):
            arrival = _fit(_factory(None, num_epochs=1), arrival_ds,
                           world_size=1, timeout=300)
    vt.join(300.0)
    assert "err" not in victim_out, victim_out.get("err")
    victim = victim_out["res"]
    assert arrival["restarts"] == 0 and victim["restarts"] == 1
    assert victim["failures"][0]["preempted"]
    assert glob.glob(os.path.join(victim_dir, "step_emergency_*.pt"))
    assert victim["history"][-1]["train_loss"] == (
        clean["history"][-1]["train_loss"])
    for name, want in clean["params"].items():
        assert torch.equal(torch.from_numpy(victim["params"][name]),
                           torch.from_numpy(want)), name
    kinds = _kinds()
    assert "sched/preempt" in kinds and "sched/resume" in kinds


def test_budget_exhaustion_sheds_capacity_to_queued_work():
    """A tenant whose gang burns its whole restart budget releases its
    slots on the way out: the queued tenant is admitted and completes
    instead of hanging behind a dead job."""
    control.configure(capacity=1, admit_timeout_s=240.0)
    ds = _ds(n=512)
    doomed_out = {}

    def run_doomed():
        with acct.job_scope(acct.mint_job("doomed", priority=5)):
            try:
                _fit(_factory(None, num_epochs=1), ds, world_size=1,
                     # fires in every incarnation: step 1 is never behind
                     # a checkpoint
                     env={"RAYDP_TPU_FAULT_PLAN": "kill:rank=0,step=1"},
                     timeout=300, max_restarts=1, restart_backoff_s=0.1)
            except SPMDJobError as exc:
                doomed_out["err"] = exc

    with time_limit(GANG_LIMIT_S):
        dt = threading.Thread(target=run_doomed, daemon=True)
        dt.start()
        arb = control.get_arbiter()
        assert _wait_for(lambda: arb.in_use() == 1, 60.0)
        # Lower priority than the doomed job: never preempts it, queues.
        with acct.job_scope(acct.mint_job("patient", priority=0)):
            patient = _fit(_factory(None, num_epochs=1), ds, world_size=1,
                           timeout=300)
        dt.join(60.0)
    assert "restart budget exhausted" in str(doomed_out["err"])
    assert patient["restarts"] == 0
    assert np.isfinite(patient["history"][-1]["train_loss"])
    assert arb.in_use() == 0  # no leaked capacity


def test_fit_spmd_takes_and_returns_its_gang_lease(monkeypatch):
    """With ``RAYDP_TPU_SCHED_CAPACITY`` set the fit is admitted under
    its own job (``sched/admit`` for a gang of its world) and leaves no
    slot held; ``SPMDJob.start`` inside it takes no second lease."""
    monkeypatch.setenv(control.SCHED_CAPACITY_ENV, "2")
    control.reset_for_tests()
    with time_limit(GANG_LIMIT_S):
        out = _fit(_factory(None, num_epochs=1), _ds(n=256), world_size=1,
                   timeout=300)
    arb = control.get_arbiter()
    rep = arb.report()
    assert rep["enabled"] and rep["in_use"] == 0 and rep["leases"] == []
    assert rep["states"][out["job_id"]] == "completed"
    admits = [r for r in events_mod.local_events()
              if r["name"] == "sched/admit" and r.get("job") == out["job_id"]]
    assert len(admits) == 1 and admits[0]["attrs"]["slots"] == 1
