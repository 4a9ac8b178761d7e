"""The port's request queue and fault-plan parser against the JAX
package's.

One fake clock is installed in both packages' clock seams; the same
script of submits, batch pulls, completions, requeues, expiries and a
close runs through ``raydp_tpu.serve.batching.RequestQueue`` and then,
from the same start time, through the port's. The two must form the
same batches (ids, order, bucket), shed with the same eta and depth,
decompose every reply into the same phases and count the same metrics.
"""
import dataclasses

import pytest

from raydp_tpu.fault import plan as jax_plan
from raydp_tpu.serve import batching as jax_batching
from raydp_tpu.utils import clock as jax_clock
from raydp_tpu.utils import profiling as jax_profiling
from raydp_tpu.utils.profiling import metrics as jax_metrics
from raydp_tpu_torch.fault import plan as port_plan
from raydp_tpu_torch.serve import batching as port_batching
from raydp_tpu_torch.utils import clock as port_clock
from raydp_tpu_torch.utils import profiling as port_profiling
from raydp_tpu_torch.utils.profiling import metrics as port_metrics


class FakeClock(port_clock.Clock):
    """Virtual time: reads return ``now``; every wait runs out at once,
    advancing ``now`` by its timeout (nothing else notifies here)."""

    def __init__(self):
        self.now = 0.0

    def monotonic(self):
        return self.now

    def sleep(self, seconds):
        self.now += seconds

    def wait_on(self, cond, timeout=None):
        self.now += timeout or 0.0
        return False

    def wait_event(self, event, timeout=None):
        if event.is_set():
            return True
        self.now += timeout or 0.0
        return False


@pytest.fixture
def fake_clock():
    clock = FakeClock()
    jax_clock.install(clock)
    port_clock.install(clock)
    try:
        yield clock
    finally:
        jax_clock.uninstall()
        port_clock.uninstall()


def _script(mod, clock, metrics):
    """Drive one package's queue through a fixed script; return a log of
    everything observable."""
    metrics.reset()
    clock.now = 100.0
    log = []
    q = mod.RequestQueue(max_depth=6, slo_ms=60, max_batch=3,
                         buckets=[4, 16])
    reqs = {}

    def submit(rid, length, timeout_s=30.0):
        reqs[rid] = mod.ServeRequest(list(range(length)),
                                     timeout_s=timeout_s, request_id=rid)
        try:
            q.submit(reqs[rid])
            log.append(("admit", rid, q.depth()))
        except mod.QueueFullError as exc:
            log.append(("shed", rid, exc.queue_depth, exc.eta_s, str(exc)))

    def pull(wait=0.5):
        batch = q.next_batch(wait_timeout=wait)
        log.append(("batch", [r.request_id for r in batch],
                    [r.bucket for r in batch], [r.attempts for r in batch],
                    clock.now))
        return batch

    def complete(batch, exec_s, reply_s=0.002, error=None):
        clock.now += 0.001
        for r in batch:
            r.dispatched_mono = clock.now
        clock.now += exec_s + reply_s
        for r in batch:
            r.exec_s = exec_s
            ok = q.complete(r, result=None if error else sum(r.payload),
                            error=error)
            log.append(("reply", r.request_id, ok, r.result, r.error,
                        r.phases))
        q.observe_service_time((exec_s + reply_s) / max(1, len(batch)))

    for i, n in enumerate([2, 3, 9, 1, 12]):
        submit(f"a{i}", n)
        clock.now += 0.004
    first = pull()            # three short ones, no linger needed
    second = pull()           # two long ones, lingers out the SLO
    complete(first, 0.600)    # a slow batch: the shed eta grows
    log.append(("eta", q.shed_eta_s()))
    for i in range(7):        # fills the queue, then sheds
        submit(f"b{i}", 1 + (5 * i) % 15)
    assert q.requeue(second) == 2   # a replica died with `second`
    log.append(("depth", q.depth()))
    third = pull()            # the requeued pair leads
    complete(third, 0.020, error="model failed")
    complete(first[:1], 0.005)      # a late duplicate: dropped
    submit("c0", 3, timeout_s=0.05)
    clock.now += 0.1          # c0 expires in the queue
    while q.depth():
        batch = pull(wait=0.05)
        if batch:
            complete(batch, 0.004)
    log.append(("expired", reqs["c0"].cancelled, reqs["c0"].error))
    submit("d0", 2)
    q.close()
    log.append(("closed", reqs["d0"].cancelled, reqs["d0"].error,
                q.depth(), pull(wait=0.1)))
    submit("d1", 2)           # a closed queue sheds
    log.append(("counters", metrics.snapshot()["counters"]))
    lat = metrics.histogram("serve/latency")
    log.append(("latency", lat.summary(), lat.quantile(0.5),
                lat.quantile(0.99)))
    return log


def test_queue_script_matches_jax(fake_clock):
    want = _script(jax_batching, fake_clock, jax_metrics)
    got = _script(port_batching, fake_clock, port_metrics)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g == w
    kinds = {entry[0] for entry in got}
    assert {"admit", "shed", "batch", "reply", "expired",
            "closed"} <= kinds
    sheds = [e for e in got if e[0] == "shed"]
    assert sheds[0][3] > 0.1  # above the floor: the EWMA moved it
    replies = [e for e in got if e[0] == "reply" and e[5]]
    assert all(abs(sum(e[5][k] for k in port_batching.PHASE_NAMES)
                   - e[5]["total"]) < 1e-9 for e in replies)


def test_request_phases_and_ttft_match_jax(fake_clock):
    out = []
    for mod in (jax_batching, port_batching):
        fake_clock.now = 5.0
        req = mod.ServeRequest([1, 2, 3], timeout_s=10.0, request_id="r",
                               decode=mod.DecodeState([1, 2, 3], 4))
        req.dequeued_mono, req.dispatched_mono = 5.2, 5.25
        req.bucket, req.exec_s = 16, 0.5
        req.decode.first_token_mono = 5.4
        out.append((mod.request_phases(req, 6.0), req.ttft_s()))
        assert mod.request_phases(mod.ServeRequest([1]), 6.0) is None
    assert out[0] == out[1]
    assert port_batching.PHASE_LABELS == jax_batching.PHASE_LABELS
    assert port_batching.DECODE_PHASE_LABELS == \
        jax_batching.DECODE_PHASE_LABELS


def test_queue_env_defaults_match_jax(monkeypatch):
    for mod in (jax_batching, port_batching):
        q = mod.RequestQueue()
        assert (q.max_depth, q.slo_s, q.max_batch, q.buckets) == \
            (256, 0.05, 8, (16, 64, 256))
    monkeypatch.setenv("RAYDP_TPU_SERVE_BUCKETS", "32,8")
    monkeypatch.setenv("RAYDP_TPU_SERVE_MAX_BATCH", "5")
    monkeypatch.setenv("RAYDP_TPU_SERVE_SLO_MS", "12")
    got = [(q.max_batch, q.slo_s, q.buckets) for q in
           (jax_batching.RequestQueue(), port_batching.RequestQueue())]
    assert got[0] == got[1] == (5, 0.012, (8, 32))


@pytest.mark.parametrize("buckets", [None, [0.5, 0.1, 2.0]])
def test_histogram_and_timer_match_jax(buckets):
    """The serve plane's latency and phase histograms and its replica
    timer: the same observations give the same summaries and quantiles
    (a cold histogram reads None)."""
    values = [0.0003, 0.004, 0.02, 0.02, 0.07, 0.3, 1.7, 45.0, 500.0]
    out = []
    for mod in (jax_profiling, port_profiling):
        h = mod.Histogram(buckets)
        assert h.quantile(0.5) is None
        t = mod.StepTimer(window=4)
        for v in values:
            h.observe(v)
            t.observe(v)
        out.append((h.summary(),
                    [h.quantile(q) for q in (0.0, 0.25, 0.5, 0.99, 1.0)],
                    t.summary()))
    assert out[0] == out[1]


def test_registry_snapshot_matches_jax():
    out = []
    for reg in (jax_profiling.MetricsRegistry(),
                port_profiling.MetricsRegistry()):
        reg.counter_add("serve/replies", 3)
        reg.gauge_set("serve/queue_depth", 7)
        reg.histogram("serve/latency").observe(0.02)
        reg.timer("serve/replica_exec").observe(0.5)
        snap = reg.snapshot()
        out.append((snap["counters"], snap["gauges"],
                    snap["hist/serve/latency"],
                    snap["timer/serve/replica_exec"],
                    reg.gauge_value("serve/queue_depth"),
                    reg.gauge_value("never-set")))
        reg.reset()
        assert reg.snapshot() == {"counters": {}}
    assert out[0] == out[1]


GOOD_PLANS = [
    "serve_kill:replica=1,request=5,code=7",
    "latency:nth=3,delay=0.25",
    "latency:nth=0,delay=0.6,replica=0",
    "rpc_drop:method=Echo,nth=1; rpc_delay:method=S.Ping,nth=0,delay=0.4",
    "kill:rank=1,step=3",
    "kill:worker=w2,task=0,code=9",
    "kill:job=nightly,step=4",
    "preempt:step=2,rank=0,grace=1.5,job=a",
    "hb_stall:rank=0,beats=3,after=2",
    "spawn_fail:nth=1;spawn_delay:nth=0,delay=2",
    "serve_kill:replica=0,request=4,prob=0.5;latency:nth=1,delay=0.1,"
    "prob=0.3;kill:rank=2,step=1,prob=0.7",
    "  ;serve_kill:replica=0,request=40; ",
]

BAD_PLANS = [
    "serve_kill:replica=0",
    "latency:nth=3",
    "serve_kill:replica=0,request=x",
    "latency:nth=1,delay=0.1,rank=0",
    "explode:now=1",
    "serve_kill",
    "serve_kill:replica",
    "serve_kill:replica=0,replica=1,request=2",
    "kill:rank=1",
    "kill:step=1",
    "kill:worker=a,step=2,task=1",
    "preempt:rank=1",
    "hb_stall:beats=2",
    "latency:nth=1,delay=0.1,prob=1.5",
]


@pytest.mark.parametrize("text", GOOD_PLANS)
@pytest.mark.parametrize("seed", [0, 7])
def test_parse_plan_matches_jax(text, seed):
    want = [dataclasses.asdict(c) for c in jax_plan.parse_plan(text, seed)]
    got = [dataclasses.asdict(c) for c in port_plan.parse_plan(text, seed)]
    assert got == want and got


@pytest.mark.parametrize("text", BAD_PLANS)
def test_bad_plans_raise_in_both(text):
    with pytest.raises(jax_plan.FaultPlanError) as jax_err:
        jax_plan.parse_plan(text)
    with pytest.raises(port_plan.FaultPlanError) as port_err:
        port_plan.parse_plan(text)
    assert str(port_err.value) == str(jax_err.value)


def test_plan_env_names_match_jax():
    assert port_plan.FAULT_PLAN_ENV == jax_plan.FAULT_PLAN_ENV
    assert port_plan.FAULT_SEED_ENV == jax_plan.FAULT_SEED_ENV
