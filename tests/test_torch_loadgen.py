"""The port's load generator (``raydp_tpu_torch/loadgen``) against
``tests/test_loadgen.py`` and the JAX package's.

* The 20 tests of ``tests/test_loadgen.py`` (21 cases: one is
  parametrized over two tail shapes) run against the port through
  ``tests/torch_port_cases.py`` with ``loadgen``, ``serve``, ``sim`` and
  ``utils`` pointed at the port: schedule shapes, the trace format, the
  live-queue recorder, the open-loop wheel under a stalling backend and
  its in-flight cap, the knee finder on a synthetic cliff, phase
  provenance, histogram merges, token metrics and the decode target.
* Cross-package: one seeded schedule of each kind gives bit-identical
  arrival offsets, buckets and sizes in both packages, and a trace
  written by one package reads back equal in the other.
"""
import pytest

import raydp_tpu.loadgen as ref_loadgen
import raydp_tpu_torch.loadgen as port_loadgen
from raydp_tpu_torch.utils.profiling import metrics
from torch_port_cases import (
    case_params,
    cases,
    load_port_module,
    run_case,
    time_limit,
)

PORT_REFERENCE = load_port_module("test_loadgen.py")
TEST_NAMES = [n for n in vars(PORT_REFERENCE) if n.startswith("test_")]
REFERENCE_CASES = cases(PORT_REFERENCE, TEST_NAMES)
LIMIT_S = 120

# One schedule of each kind, with its reference generator's arguments.
SCHEDULES = {
    "poisson": ("poisson_schedule", dict(seed=7)),
    "heavy_tail_pareto": ("heavy_tail_schedule", dict(seed=11)),
    "heavy_tail_lognormal": ("heavy_tail_schedule",
                             dict(seed=11, dist="lognormal", shape=1.2)),
    "diurnal": ("diurnal_schedule", dict(seed=3, cycles=2.0,
                                         amplitude=0.6)),
    "flash_crowd": ("flash_crowd_schedule",
                    dict(seed=5, burst_mult=8.0, burst_start_frac=0.3,
                         burst_duration_frac=0.25)),
}


@pytest.fixture(autouse=True)
def _fresh_metrics():
    metrics.reset()
    yield
    metrics.reset()


@pytest.mark.parametrize("name,params",
                         case_params(PORT_REFERENCE, REFERENCE_CASES))
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert len(TEST_NAMES) == 20 and len(REFERENCE_CASES) == 21


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_schedule_is_bit_identical_to_the_reference(kind):
    fn, kwargs = SCHEDULES[kind]
    args = (250.0, 20.0)
    want = getattr(ref_loadgen, fn)(*args, **kwargs)
    got = getattr(port_loadgen, fn)(*args, **kwargs)
    assert len(got) == len(want) > 1000
    assert [(e.t, e.bucket, e.size) for e in got] == [
        (e.t, e.bucket, e.size) for e in want]
    # Explicit sizes and buckets too.
    kwargs = dict(kwargs, sizes=(3, 40, 500), buckets=(16, 64))
    assert [(e.t, e.bucket, e.size)
            for e in getattr(port_loadgen, fn)(*args, **kwargs)] == [
        (e.t, e.bucket, e.size)
        for e in getattr(ref_loadgen, fn)(*args, **kwargs)]


def test_traces_cross_between_packages(tmp_path):
    events = ref_loadgen.heavy_tail_schedule(120.0, 10.0, seed=9)
    ref_path = str(tmp_path / "ref.jsonl")
    port_path = str(tmp_path / "port.jsonl")
    ref_loadgen.write_trace(ref_path, events, meta={"source": "test"})
    port_loadgen.write_trace(port_path, port_loadgen.read_trace(ref_path),
                             meta={"source": "test"})
    with open(ref_path, "rb") as a, open(port_path, "rb") as b:
        assert a.read() == b.read()
    assert [(e.t, e.bucket, e.size)
            for e in ref_loadgen.read_trace(port_path)] == [
        (e.t, e.bucket, e.size) for e in events]
