"""The port's autoscaler (``raydp_tpu_torch/control/autoscaler.py``) and
the fault plan's spawn hook against ``tests/test_autoscaler.py``.

* Its 13 cases (a grow within one evaluation, the idle streak and
  cooldowns, the gang floor, spawn faults backed off to convergence or a
  spent budget, bin-packing of a freed host, a serve group's queue as
  pressure, the decision events, the background loop, the
  ``ClusterProvisioner``'s error wrapping, ``AutoscalerConfig.from_env``)
  run against the port through ``tests/torch_port_cases.py``; the
  reference's autouse fixture is repeated here.
* ``chip_smoke.py``'s phase 17c, the reference's autoscale smoke, runs
  here on a port session of torch-free CPU workers: a queued arbiter
  waiter grows the pool in one evaluation, ``spawn_fail:nth=1`` is
  backed off, and a 96-task ETL loses no task across the drain back to
  one worker, with no flap.
"""
import pytest

import chip_smoke
import raydp_tpu_torch
from raydp_tpu_torch import control, fault
from raydp_tpu_torch.telemetry import events as events_mod
from torch_port_cases import (
    case_params,
    cases,
    load_port_module,
    run_case,
    time_limit,
)

PORT_REFERENCE = load_port_module("test_autoscaler.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [n for n in vars(PORT_REFERENCE)
                                         if n.startswith("test_")])
LIMIT_S = 60


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.delenv(fault.FAULT_PLAN_ENV, raising=False)
    monkeypatch.delenv(fault.FAULT_SEED_ENV, raising=False)
    for var in (v for v in dir(control) if v.startswith("AUTOSCALE")):
        monkeypatch.delenv(getattr(control, var), raising=False)
    fault.reset_for_tests()
    control.reset_for_tests()
    yield
    fault.reset_for_tests()
    control.reset_for_tests()


@pytest.mark.parametrize("name,params",
                         case_params(PORT_REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(REFERENCE_CASES) == 13


def test_spawn_hook_counts_attempts_and_fires_its_clauses(monkeypatch):
    """``spawn_delay`` stalls its attempt through the clock seam and
    ``spawn_fail`` raises on its own; each clause fires once, on the
    attempt it names, and lands on the timeline."""
    slept = []
    monkeypatch.setattr(fault.inject._clock, "sleep", slept.append)
    monkeypatch.setenv(fault.FAULT_PLAN_ENV,
                       "spawn_delay:nth=0,delay=2.5;spawn_fail:nth=2")
    fault.on_spawn()
    assert slept == [2.5]
    fault.on_spawn()
    with pytest.raises(fault.SpawnFaultError, match="attempt 2"):
        fault.on_spawn()
    fault.on_spawn()
    assert slept == [2.5]
    clauses = [r["attrs"]["clause"] for r in events_mod.local_events()
               if r["name"] == "fault/clause"][-2:]
    assert clauses == ["spawn_delay", "spawn_fail"]


def test_autoscale_smoke_on_a_port_session():
    """``chip_smoke.phase_autoscale`` (17c) on the CPU: its checks hold
    the grow, the retried grow, the lossless drain and the decision
    record, and it leaves no session, plan or arbiter behind."""
    with time_limit(180):
        out = chip_smoke.phase_autoscale(raydp_tpu_torch)
    assert out["lost"] == 0 and out["flaps"] == 0
    assert out["grow_s"] > 0 and out["drain_s"] > 0
    assert raydp_tpu_torch.context.current_session() is None
    assert not control.get_arbiter().enabled
