"""The port's simulator (``raydp_tpu_torch/sim``) held equal to the JAX
package's on the same inputs.

* One ``run_trace`` scenario (an arbiter with two gangs, an autoscaler
  and a serving queue under a Poisson trace) gives the same
  ``result_to_json`` (wall seconds and events per wall second apart),
  the same autoscaler decisions and the same event timeline in both
  packages.
* One virtual knee sweep under a ``KneeConfig`` over a synthetic cliff
  (one replica of 20 ms a call, batch 1: 50 requests/s) gives the same
  knee and curve. The wall-clock knee finder's latencies are wall time,
  which no two runs repeat; its virtual-time sweep is the one a knee
  can be held equal by.
"""
import json

import pytest

import raydp_tpu.control.arbiter as ref_arbiter_mod
import raydp_tpu.loadgen as ref_loadgen
import raydp_tpu.sim.scenario as ref_scenario
import raydp_tpu.telemetry.events as ref_events
import raydp_tpu.utils.profiling as ref_profiling
from raydp_tpu.control.autoscaler import AutoscalerConfig as RefAutoscalerCfg
from raydp_tpu.loadgen.knee import KneeConfig as RefKneeConfig
from raydp_tpu.telemetry import stage_store as ref_stage_store
from raydp_tpu_torch.control import arbiter as arbiter_mod
from raydp_tpu_torch.control.autoscaler import AutoscalerConfig
from raydp_tpu_torch.loadgen import poisson_schedule
from raydp_tpu_torch.loadgen.knee import KneeConfig
from raydp_tpu_torch.sim import scenario as port_scenario
from raydp_tpu_torch.telemetry import events as port_events
from raydp_tpu_torch.telemetry import stage_store as port_stage_store
from raydp_tpu_torch.utils.profiling import metrics

# Wall-clock fields of a SimResult's JSON and of the sim/run event.
WALL_KEYS = ("wall_s", "events_per_s")


@pytest.fixture(autouse=True)
def _clean_world():
    metrics.reset()
    ref_profiling.metrics.reset()
    # The scenario's autoscaler reads the process's recent DataFrame
    # stages (its stage_queue signal): stages an earlier test ran in this
    # process, with wall-clock queue times of their own, would enter one
    # package's decisions and not the other's.
    port_stage_store.clear()
    ref_stage_store.clear()
    yield
    arbiter_mod.reset_for_tests()
    ref_arbiter_mod.reset_for_tests()
    metrics.reset()
    ref_profiling.metrics.reset()


def _scenario(scenario_mod, autoscaler_cfg):
    """The reference's resonance scenario: serve pressure makes the
    autoscaler grow while a high-priority gang preempts a low one."""
    spec = scenario_mod.GangJobSpec
    return scenario_mod.ScenarioConfig(
        hosts=1, max_batch=2, max_queue=512, slo_ms=50.0,
        arbiter_capacity=4,
        jobs=(spec(arrive_t=0.5, slots=4, priority=0, hold_s=6.0,
                   drain_s=0.3, resume=True, label="low"),
              spec(arrive_t=3.5, slots=4, priority=5, hold_s=2.0,
                   preemptible=False, resume=False, label="high")),
        autoscaler=autoscaler_cfg(
            min_workers=1, max_workers=6, up_cooldown_s=2.0,
            down_cooldown_s=3.0, idle_evals=2, step=1, spawn_retries=1,
            backoff_s=0.0))


def _replay(scenario_mod, events_mod, autoscaler_cfg, schedule, path,
            monkeypatch):
    """One package's ``run_trace`` of ``schedule``: its JSON (wall keys
    dropped) and its timeline as (kind, attributes) pairs."""
    timeline = []
    real_emit = events_mod.emit

    def record(kind, job=None, **attrs):
        timeline.append((kind, job.job_id if job is not None else None,
                         {k: v for k, v in attrs.items()
                          if k not in WALL_KEYS}))
        return real_emit(kind, job=job, **attrs)

    monkeypatch.setattr(events_mod, "emit", record)
    result = scenario_mod.run_trace(schedule,
                                    _scenario(scenario_mod, autoscaler_cfg))
    monkeypatch.setattr(events_mod, "emit", real_emit)
    scenario_mod.result_to_json(result, path)
    with open(path) as f:
        doc = json.load(f)
    for key in WALL_KEYS:
        doc.pop(key)
    return doc, timeline


def test_run_trace_equals_the_reference(tmp_path, monkeypatch):
    schedule = poisson_schedule(150.0, 10.0, seed=21)
    ref_schedule = ref_loadgen.poisson_schedule(150.0, 10.0, seed=21)
    ref_profiling.metrics.reset()
    want, want_tl = _replay(ref_scenario, ref_events, RefAutoscalerCfg,
                            ref_schedule, str(tmp_path / "ref.json"),
                            monkeypatch)
    ref_arbiter_mod.reset_for_tests()
    got, got_tl = _replay(port_scenario, port_events, AutoscalerConfig,
                          schedule, str(tmp_path / "port.json"),
                          monkeypatch)
    assert got == want
    assert got_tl == want_tl
    decisions = [attrs for kind, _, attrs in got_tl
                 if kind == "autoscale/decision"]
    assert [d["verdict"] for d in decisions] == [
        attrs["verdict"] for kind, _, attrs in want_tl
        if kind == "autoscale/decision"]
    kinds = {kind for kind, _, _ in got_tl}
    # The scenario reaches every plane it names.
    assert {"sched/preempt", "sched/resume", "autoscale/grow",
            "sim/run"} <= kinds
    assert got["arrivals"] == len(schedule) and got["gangs"][0]["preempts"]


def test_sim_knee_equals_the_reference():
    knee = dict(start_rps=4, max_rps=256, step_factor=2.0,
                step_duration_s=2.0, slo_ms=100.0, shed_threshold=0.05,
                bisect_rounds=3, seed=1)
    scenario = dict(hosts=1, max_batch=1, service_ms=20.0, slo_ms=100.0,
                    max_queue=64, timeout_s=2.0)
    ref_profiling.metrics.reset()
    want = ref_scenario.sim_knee(ref_scenario.ScenarioConfig(**scenario),
                                 RefKneeConfig(**knee))
    ref_arbiter_mod.reset_for_tests()
    got = port_scenario.sim_knee(port_scenario.ScenarioConfig(**scenario),
                                 KneeConfig(**knee))
    assert got == want
    assert got["saturated"] and 16 <= got["knee_rps"] <= 80
