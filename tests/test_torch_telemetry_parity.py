"""The port's telemetry against the JAX package's on the same inputs:
every output below must be equal byte for byte, so dashboards and tools
keyed on the JAX package's names and formats read the port unchanged.

* ``render_prometheus`` on a numpy-seeded view that fills every family
  of the exposition (the port takes ``render_prometheus`` whole), worker
  labels that need escaping included;
* ``to_chrome_trace`` and ``analyze_records`` (and ``format_report``) on
  span records from several shards whose monotonic clocks are skewed
  apart, with ingest, step, phase and event records;
* ``usage_report`` on one merged view and ``mttr_report`` on one event
  timeline;
* a ``traceparent`` and a job wire string minted by either package and
  read by the other (the wire formats are shared).
"""
import json

import numpy as np
import pytest

import raydp_tpu.telemetry.accounting as jax_acct
import raydp_tpu.telemetry.analyze as jax_analyze
import raydp_tpu.telemetry.chrome_trace as jax_chrome
import raydp_tpu.telemetry.events as jax_events
import raydp_tpu.telemetry.export as jax_export
import raydp_tpu.telemetry.propagation as jax_prop
import raydp_tpu_torch.telemetry.accounting as torch_acct
import raydp_tpu_torch.telemetry.analyze as torch_analyze
import raydp_tpu_torch.telemetry.chrome_trace as torch_chrome
import raydp_tpu_torch.telemetry.events as torch_events
import raydp_tpu_torch.telemetry.export as torch_export
import raydp_tpu_torch.telemetry.propagation as torch_prop

# One name per routing branch of render_prometheus's counter section.
_COUNTERS = (
    "spans/dropped", "events/dropped", "slo/breaches/serve_p99",
    "watchdog/stalls", "rpc/payload_bytes", "shuffle/bytes",
    "shuffle/local_bytes", "shuffle/elided", "pipeline/overlap_seconds",
    "aqe/replans/coalesce", "aqe/coalesced_partitions", "aqe/salted_keys",
    "aqe/bytes_saved", "stage/rows_in/map_partitions",
    "stage/rows_out/map_partitions", "stage/bytes_in/exchange",
    "stage/bytes_out/exchange", "stage/seconds/exchange",
    "anomalies/nan_loss", "restarts/total", "preemptions/total",
    "replay/steps", "worker_restarts/w3", "usage/chip_seconds",
    "usage/task_seconds", "job/fit-spmd-0a1b2c3d/chip_seconds",
    "job/fit-spmd-0a1b2c3d/hbm_byte_seconds",
    "job/etl-9f8e7d6c/task_seconds", "job/etl-9f8e7d6c/shuffle_bytes",
    "job/etl-9f8e7d6c/staged_bytes", "job/etl-9f8e7d6c/fetched_bytes",
    "job/etl-9f8e7d6c/compile_seconds", "job/etl-9f8e7d6c/custom_kind",
    "compile/count", "compile/seconds", "compile/failures",
    "sched/preemptions/tenant-a", "sched/wait/tenant-a", "sched/sheds",
    "autoscale/decisions/up", "autoscale/drains", "autoscale/spawn_failed",
    "autoscale/denied", "serve/requests", "serve/replies",
    "decode/rounds", "decode/prefills", "decode/retired/eos",
    "loadgen/fired", "sim/arrivals", "sim/completed",
    "sim/invariant_violations", "sim/pathologies/hotspot",
    "sim/replica_deaths", "loadgen/status/ok", "worker/tasks",
    'odd/"quoted"\\name',
)
# One name per routing branch of the gauge section.
_GAUGES = (
    "mem/rss_bytes", "mem/rss_peak_bytes", "hbm/used_bytes",
    "hbm/peak_bytes", "store/occupancy_bytes", "store/occupancy_peak_bytes",
    "sched/queue_depth", "sched/queue_wait_oldest", "autoscale/pool_size",
    "autoscale/pending_spawns", "decode/batch_occupancy", "decode/page_fill",
    "decode/kv_bucket", "decode/pending", "serve/queue_depth",
    "serve/batch_fill", "serve/replicas_alive", "loadgen/offered_rps",
    "loadgen/achieved_rps", "loadgen/knee_rps", "sim/knee_rps",
    "sim/events_per_s", "mfu", "slo/status/serve_p99", "slo/burn/serve_p99",
    "phase/compute_frac",
)
_METERS = ("ingest/rows", "serve/throughput", "decode/throughput")
_TIMERS = ("train/step", "worker/task", "train/epoch")
_HISTS = ("train/step_seconds", "serve/latency", "serve/replica/0",
          "serve/phase/queue", "decode/ttft", "decode/tpot", "other/hist")
_BOUNDS = (0.001, 0.01, 0.1, 1.0, 10.0)


def _section(rng):
    """One process's registry snapshot, every value from ``rng``."""
    sec = {"counters": {n: float(rng.integers(0, 10_000))
                        for n in _COUNTERS},
           "gauges": {n: float(rng.random() * 1e9) for n in _GAUGES}}
    for n in _METERS:
        sec[f"meter/{n}"] = {"total": float(rng.integers(1, 10**6)),
                             "per_sec": float(rng.random() * 1e4)}
    for n in _TIMERS:
        xs = np.sort(rng.random(3))
        sec[f"timer/{n}"] = {"count": 3.0, "total_s": float(xs.sum()),
                             "mean_s": float(xs.mean()),
                             "p50_s": float(xs[1]), "p90_s": float(xs[2]),
                             "p99_s": float(xs[2])}
    for n in _HISTS:
        counts = np.cumsum(rng.integers(0, 5, len(_BOUNDS) + 1))
        buckets = {repr(b): float(c) for b, c in zip(_BOUNDS, counts)}
        buckets["+Inf"] = float(counts[-1])
        sec[f"hist/{n}"] = {"sum": float(rng.random() * 10),
                            "count": float(counts[-1]),
                            "buckets": buckets}
    return sec


def _view(seed=0):
    rng = np.random.default_rng(seed)
    workers = {"w0": _section(rng), "w1": _section(rng),
               'w"2\\\nx': _section(rng),
               "rank-0": _section(rng)}
    workers["w1"]["tombstone"] = True
    workers["w1"]["updated_wall"] = 1.0e9
    return {"workers": workers, "aggregate": {}, "events": [],
            "driver": _section(rng)}


def test_render_prometheus_is_byte_equal():
    view = _view()
    text = torch_export.render_prometheus(view)
    assert text == jax_export.render_prometheus(view)
    # The view reached every family: each routed name renders somewhere.
    for family in ("raydp_spans_dropped_total", "raydp_stalls_total",
                   "raydp_job_chip_seconds_total", "raydp_hbm_bytes",
                   "raydp_timer_seconds", "raydp_worker_up"):
        assert family in text, family
    assert '\\"2\\\\\\nx' in text  # escaped worker label


def _mk(pid, offset, name, span_id, parent, trace, start, dur,
        kind="span", tid=1, job=None, **attrs):
    rec = {"name": name, "span_id": span_id, "trace_id": trace,
           "parent_id": parent, "seq": int(span_id.split("-")[-1]),
           "start_wall": start, "start_mono": start - offset,
           "duration_s": dur, "status": "ok", "kind": kind,
           "attrs": attrs, "pid": pid, "tid": tid}
    if job is not None:
        rec["job"] = job
    return rec


def _records(seed=1):
    """A driver, two ETL workers and two ranks, each shard's monotonic
    clock at its own offset from the wall, durations from ``rng``."""
    rng = np.random.default_rng(seed)
    t0 = 1.7e9
    recs = [
        _mk(1, 1000.0, "cluster/job", "a-1", None, "a-1", t0, 0.0,
            kind="event"),
        _mk(1, 1000.0, "df/stage", "a-2", "a-1", "a-1", t0 + 0.1, 2.0,
            op="map_partitions"),
        _mk(1, 1000.0, "train/fit", "a-3", "a-1", "a-1", t0 + 2.5, 20.0),
        _mk(1, 1000.0, "gang/launch", "a-4", None, "a-1", t0 + 2.6, 0.0,
            kind="event", job="fit-spmd-0a1b2c3d"),
    ]
    for w, pid, off in (("w0", 2, 2000.0), ("w1", 3, 3000.0)):
        for i in range(3):
            recs.append(_mk(pid, off, "worker/task", f"{pid}-{i + 1}",
                            "a-2", "a-1", t0 + 0.2 + 0.5 * i,
                            float(rng.random() * 0.4), worker_id=w))
    for rank, pid, off in ((0, 4, 4000.5), (1, 5, 5000.25)):
        base = t0 + 3.0
        for i in range(16):
            recs.append(_mk(pid, off, "ingest/chunk", f"{pid}-{100 + i}",
                            "a-3", "a-1", base + i, float(rng.random() * 0.1),
                            rank=rank))
            recs.append(_mk(pid, off, "train/step", f"{pid}-{200 + i}",
                            "a-3", "a-1", base + i + 0.1,
                            float(0.5 + rng.random() * 0.3), step=i))
        recs.append(_mk(pid, off, "train/phases", f"{pid}-300", "a-3", "a-1",
                        base + 17, 0.0, kind="event", steps=16, wall_s=17.0,
                        input_wait_frac=0.1, dispatch_frac=0.2,
                        compute_frac=0.6, collective_frac=0.1,
                        bound="compute"))
    return recs


def _dump(obj):
    return json.dumps(obj, sort_keys=True)


def test_chrome_trace_and_analyze_are_byte_equal(tmp_path):
    recs = _records()
    assert _dump(torch_chrome.to_chrome_trace(recs)) == _dump(
        jax_chrome.to_chrome_trace(recs))
    assert torch_chrome.clock_offsets(recs) == jax_chrome.clock_offsets(recs)
    ours = torch_analyze.analyze_records(recs)
    theirs = jax_analyze.analyze_records(recs)
    assert _dump(ours) == _dump(theirs)
    assert torch_analyze.format_report(ours) == jax_analyze.format_report(
        theirs)
    # Both ranks' 16 steps in the skew table, data-wait split from compute.
    assert len(ours["step_skew"]["ranks"]) == 2
    assert ours["data_compute"]
    # The shards on disk, merged by each package's loader.
    by_pid = {}
    for rec in recs:
        by_pid.setdefault(rec["pid"], []).append(rec)
    for pid, rs in by_pid.items():
        with open(tmp_path / f"spans-{pid}.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in rs)
    assert _dump(torch_chrome.load_span_records(str(tmp_path))) == _dump(
        jax_chrome.load_span_records(str(tmp_path)))


def test_usage_and_mttr_reports_are_byte_equal():
    view = _view(seed=2)
    assert _dump(torch_acct.usage_report(view)) == _dump(
        jax_acct.usage_report(view))
    rng = np.random.default_rng(3)
    kinds = ("gang/launch", "rank/dead", "gang/teardown",
             "checkpoint/emergency", "train/resume", "preempt/request",
             "preempt/drain", "worker/dead", "worker/restart")
    events = [{"name": kinds[int(rng.integers(len(kinds)))],
               "job": f"j{int(rng.integers(3))}",
               "start_wall": 1.7e9 + float(i) + float(rng.random()),
               "seq": i} for i in range(60)]
    assert _dump(torch_events.mttr_report(events)) == _dump(
        jax_events.mttr_report(events))


@pytest.mark.parametrize("minter,reader", [
    (jax_prop, torch_prop), (torch_prop, jax_prop)])
def test_traceparent_crosses_packages(minter, reader):
    ctx = minter.mint_context("parity/root")
    wire = minter.to_traceparent(ctx)
    back = reader.from_traceparent(wire)
    assert (back.trace_id, back.span_id) == (ctx.trace_id, ctx.span_id)
    assert reader.to_traceparent(back) == wire
    minter.set_process_context(None)
    reader.set_process_context(None)


@pytest.mark.parametrize("minter,reader", [
    (jax_acct, torch_acct), (torch_acct, jax_acct)])
def test_job_wire_crosses_packages(minter, reader):
    job = minter.mint_job("parity-job", priority=3)
    wire = minter.to_wire(job)
    back = reader.from_wire(wire)
    assert (back.job_id, back.name, back.priority) == (
        job.job_id, job.name, job.priority)
    assert reader.to_wire(back) == wire
    env = minter.env_for_child(job)
    assert reader.from_wire(env[reader.JOB_ENV]) == back
