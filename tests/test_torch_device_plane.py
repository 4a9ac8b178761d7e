"""The port's device plane (``raydp_tpu_torch/telemetry/device_profiler.py``,
``utils/profiling.py``'s ``trace``/``annotate``/compile accounting/cost
count, the estimator's hooks, ``SPMDJob.capture_profile`` and
``resource_report``, ``/debug/profile``, ``analyze``'s device plane)
against ``tests/test_device_plane.py``.

* The reference's cases that name ported modules only run against the
  port through ``tests/torch_port_cases.py``; each starts from a reset
  registry and cost table, as the reference's autouse fixture gives it.
* Cases that fit a ``JAXEstimator``, call ``jax`` or the JAX loader's
  ``_background`` are mirrored here on the port's ``Estimator`` with
  ``device="cpu"``, ``torch`` and the port's ``_background``.
  ``test_bench_compare_exit_codes`` tests the JAX package's
  ``scripts/bench_compare.py`` and is not the port's.
* ``tests/test_profiling.py::test_trace_writes_profile`` and
  ``tests/test_query_profiling.py::test_compile_error_enrichment`` are
  mirrored on ``torch.profiler`` and on the port's compiles (an ``nvcc``
  killed by a signal is the retryable failure; a diagnostic is not).
* FLOP counts: a matmul counts exactly 2·M·N·K; the flash wrappers'
  count equals their plain versions' under ``FlopCounterMode`` (on the
  CPU they run them; on a card the wrappers add their tiles' count, held
  here equal to the counter's count of the plain versions, exactly; on
  meta tensors they add it and launch nothing); one train step of a
  2-layer narrow flash transformer, counted on the meta device as the
  estimator counts it, within 5% of the closed form (its linear layers'
  2·T·in·out three times over, the attention tiles' four matmuls
  forward and seven backward), the model left as it was.
* The estimator's step clock: folded as its events complete, the
  host-paced part of each span from the host's clock.
"""
import importlib
import json
import os
import re
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import raydp_tpu_torch
from raydp_tpu_torch.data.loader import _background
from raydp_tpu_torch.models import SequenceClassifier, tiny_transformer
from raydp_tpu_torch.telemetry import device_profiler as dp
from raydp_tpu_torch.telemetry import latest_bundle
from raydp_tpu_torch.train import Estimator
from raydp_tpu_torch.utils import profiling
from raydp_tpu_torch.utils.profiling import metrics
from torch_port_cases import cases, load_port_module, run_case, time_limit

fa = importlib.import_module("raydp_tpu_torch.ops.flash_attention")

MIRRORED = (
    "test_phase_fractions_sum_to_one_on_stream_fit",
    "test_device_plane_kill_switch",
    "test_cost_analysis_summary_counts_flops",
    "test_ingest_wait_counter_matches_input_wait_phase",
    "test_training_nan_trips_sentinel",
    "test_capture_local_trace_archive",
    "test_gang_capture_two_rank_spmd",
)
NOT_THE_PORTS = ("test_bench_compare_exit_codes",)
PORT_REFERENCE = load_port_module("test_device_plane.py")
REFERENCE_CASES = cases(PORT_REFERENCE, [
    n for n in vars(PORT_REFERENCE)
    if n.startswith("test_") and n not in MIRRORED + NOT_THE_PORTS])
LIMIT_S = 180


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    dp.clear_costs()
    yield
    metrics.reset()
    dp.clear_costs()


@pytest.mark.parametrize("name,params",
                         [(n, p) for _, n, p in REFERENCE_CASES],
                         ids=[i for i, _, _ in REFERENCE_CASES])
def test_reference_case_on_port(name, params, request):
    with time_limit(LIMIT_S):
        run_case(PORT_REFERENCE, name, params, request)


def test_cases_cover_the_reference_module():
    assert (len(REFERENCE_CASES) + len(MIRRORED) + len(NOT_THE_PORTS)
            == 20)


# -- the reference's estimator and jax cases, mirrored ------------------------

def _fit_df(n_rows=4096, n_feat=6, seed=3):
    rs = np.random.RandomState(seed)
    x = rs.rand(n_rows, n_feat).astype(np.float32)
    w = rs.rand(n_feat, 1).astype(np.float32)
    df = pd.DataFrame(x, columns=[f"f{i}" for i in range(n_feat)])
    df["label"] = (x @ w).astype(np.float32)
    return df, [f"f{i}" for i in range(n_feat)]


def _estimator(cols, **kw):
    torch.manual_seed(0)
    defaults = dict(
        model=raydp_tpu_torch.MLP(len(cols), hidden=(16,), out_dim=1,
                                  device="cpu"),
        loss="mse", num_epochs=2, batch_size=256, feature_columns=cols,
        label_column="label", epoch_mode="stream", device="cpu")
    defaults.update(kw)
    return Estimator(**defaults)


def test_phase_fractions_sum_to_one_on_stream_fit():
    df, cols = _fit_df()
    est = _estimator(cols)
    history = est.fit_on_df(df)
    phases = history[-1].get("phases")
    assert phases, history[-1]
    frac_sum = sum(phases[k] for k in ("input_wait_frac", "dispatch_frac",
                                       "compute_frac", "collective_frac"))
    assert frac_sum == pytest.approx(1.0, abs=1e-3)
    assert phases["steps"] > 0
    assert phases["wall_s"] > 0
    assert history[-1]["bound"] in ("input-bound", "collective-bound",
                                    "compute-bound", "memory-bound",
                                    "host-bound")
    snap = metrics.snapshot()
    hist = snap.get("hist/train/step_seconds")
    assert hist and hist["count"] >= phases["steps"]
    assert snap["gauges"].get("cost/train_step/flops", 0) > 0
    assert snap["counters"].get("phase/dispatch_seconds", 0) > 0
    # No MFU on the CPU: no peak is known, none is invented.
    assert "mfu" not in snap["gauges"]
    # The first step's count: the MLP's two linear layers, the first
    # with no input gradient (2x forward), the second 3x.
    assert dp.get_cost("train_step")["flops"] == (
        2 * 2 * 256 * 6 * 16 + 3 * 2 * 256 * 16 * 1)


def test_device_plane_kill_switch(monkeypatch):
    monkeypatch.setenv("RAYDP_TPU_DEVICE_PLANE", "0")
    df, cols = _fit_df(n_rows=1024)
    est = _estimator(cols, num_epochs=1)
    history = est.fit_on_df(df)
    assert "phases" not in history[-1]
    assert "hist/train/step_seconds" not in metrics.snapshot()
    assert est._sentinel is None


def test_cost_analysis_summary_counts_flops():
    a = torch.ones((32, 48))
    b = torch.ones((48, 16))
    summary = profiling.cost_analysis_summary(lambda x, y: (x @ y).sum(),
                                              (a, b))
    assert summary is not None
    assert summary["flops"] == 2 * 32 * 16 * 48  # exactly 2·M·N·K
    assert summary["bytes"] > 0
    assert summary["dtype"] == "float32"
    assert summary["collective_bytes"] == 0.0


def test_ingest_wait_counter_matches_input_wait_phase():
    """The loader's ``ingest/wait_seconds`` (the consumer blocked on its
    queue) and the accumulator's input wait (the loop blocked in
    ``next``) account the same starvation when the producer is slow."""
    def slow_producer():
        for i in range(8):
            time.sleep(0.02)
            yield i

    stop = threading.Event()
    source = _background(slow_producer(), 1, stop)
    acc = dp.StepPhaseAccumulator("unit")
    consumed = []
    it = iter(source)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            break
        acc.note_input_wait(time.perf_counter() - t0)
        consumed.append(item)
        acc.step(0.001)
    stop.set()
    assert consumed == list(range(8))
    counter = metrics.snapshot()["counters"]["ingest/wait_seconds"]
    input_wait = acc.epoch_phases["input_wait_s"]
    assert counter > 0.05  # 8 x 20 ms producer sleeps, minus pipelining
    assert input_wait > 0.05
    assert counter / input_wait == pytest.approx(1.0, rel=1.0)


def test_training_nan_trips_sentinel(tmp_path, monkeypatch):
    """A NaN planted in the labels surfaces as a NaN loss, the sampled
    check catches it, and a flight bundle lands."""
    monkeypatch.setenv("RAYDP_TPU_POSTMORTEM_DIR", str(tmp_path))
    monkeypatch.setenv("RAYDP_TPU_SENTINEL_EVERY", "1")
    df, cols = _fit_df(n_rows=1024)
    df.loc[5, "label"] = np.nan
    est = _estimator(cols, num_epochs=1)
    est.fit_on_df(df)
    assert est._sentinel is not None
    kinds = {t["kind"] for t in est._sentinel.tripped}
    assert "nan_loss" in kinds or "nan_grad_norm" in kinds
    counters = metrics.snapshot()["counters"]
    assert (counters.get("anomalies/nan_loss", 0)
            + counters.get("anomalies/nan_grad_norm", 0)) >= 1
    assert latest_bundle(str(tmp_path)) is not None


def test_scan_path_checks_the_epoch_loss(tmp_path, monkeypatch):
    """The scan path has no step loop: the sentinel checks each epoch's
    synced loss."""
    monkeypatch.setenv("RAYDP_TPU_POSTMORTEM_DIR", str(tmp_path))
    df, cols = _fit_df(n_rows=1024)
    df.loc[5, "label"] = np.nan
    est = _estimator(cols, num_epochs=1, epoch_mode="scan")
    history = est.fit_on_df(df)
    assert est.effective_epoch_mode == "scan"
    assert "phases" not in history[-1]
    assert [t["kind"] for t in est._sentinel.tripped] == ["nan_loss"]


def test_capture_local_trace_archive(tmp_path):
    x = torch.randn(64, 64)
    payload = dp.capture_trace_archive(seconds=0.2, rank=7)
    assert payload["rank"] == 7
    assert payload["wall_stop"] > payload["wall_start"]
    assert len(payload["zip"]) > 0
    dest = tmp_path / "unpacked"
    dp.unpack_trace_archive(payload, str(dest))
    events = dp._load_torch_chrome_events(str(dest))
    assert isinstance(events, list) and events
    assert (x @ x).shape == (64, 64)


def _import_torch(ctx):
    import torch as _torch

    return _torch.__version__


def _busy(ctx):
    import time as _time

    import torch as _torch

    x = _torch.ones((128, 128))
    t0 = _time.time()
    while _time.time() - t0 < 4.0:
        (x @ x).sum()
    return ctx.rank


def test_gang_capture_two_rank_spmd(tmp_path):
    """A 2-rank gang: one ``ProfileRequest`` fan-out gives ONE merged
    Perfetto file with a process of each rank."""
    from raydp_tpu_torch.spmd.job import SPMDJob

    job = SPMDJob("gangprof", world_size=2, timeout=120.0)
    with time_limit(LIMIT_S):
        job.start()
        try:
            # torch is in the ranks before the capture imports its
            # profiler beside the running function (two threads importing
            # torch at once can see it half-initialised).
            job.run(_import_torch, timeout=120.0)
            results = {}
            t = threading.Thread(
                target=lambda: results.update(r=job.run(_busy,
                                                        timeout=120.0)),
                daemon=True)
            t.start()
            time.sleep(0.5)
            merged = job.capture_profile(seconds=1.5,
                                         out_dir=str(tmp_path / "gang"))
            t.join(timeout=120.0)
        finally:
            job.stop()
    assert results.get("r") == [0, 1]
    assert not merged.get("errors")
    with open(merged["merged_trace"]) as f:
        doc = json.load(f)
    procs = {e["args"]["name"] for e in doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert any("rank 0" in p for p in procs), procs
    assert any("rank 1" in p for p in procs), procs


# -- tests/test_profiling.py and tests/test_query_profiling.py, mirrored ---

def test_trace_writes_profile(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("matmul"):
            x = torch.ones((64, 64))
            (x @ x).sum()
    found = [f for _, _, files in os.walk(tmp_path) for f in files
             if f.endswith(".json")]
    assert found, f"no profile artifacts under {tmp_path}"
    with open(tmp_path / found[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "matmul" in names and "aten::mm" in names


def test_compile_error_enrichment():
    killed = "nvcc failed on flash_fwd.cu (exit -9):\n"
    calls = {"n": 0}

    def build(x):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError(killed)
        return x + 1

    before = metrics.snapshot().get("counters", {}).get("compile/failures",
                                                       0.0)
    # A compiler killed by a signal costs one automatic retry, not the run.
    assert profiling.run_compile(build, "nvcc:flash_fwd.cu", 1) == 2
    assert calls["n"] == 2
    after = metrics.snapshot()["counters"]["compile/failures"]
    assert after == before + 1  # the failed attempt still counts

    def always_killed(x):
        raise RuntimeError(killed)

    with pytest.raises(profiling.CompileError) as exc_info:
        profiling.run_compile(always_killed, "nvcc:flash_fwd.cu", 1)
    msg = str(exc_info.value)
    assert "nvcc:flash_fwd.cu" in msg
    assert "exit -9" in msg
    assert re.search(r"after \d+\.\d+s", msg)
    assert exc_info.value.retryable is True
    assert exc_info.value.exit_code == -9
    assert exc_info.value.__cause__ is not None

    # A diagnostic is deterministic: raised at once, no retry.
    calls_diag = {"n": 0}

    def diagnostic(x):
        calls_diag["n"] += 1
        raise RuntimeError("nvcc failed on flash_bwd.cu (exit 1):\n"
                           "flash_bwd.cu(12): error: identifier undefined")

    with pytest.raises(profiling.CompileError) as exc_info:
        profiling.run_compile(diagnostic, "nvcc:flash_bwd.cu", 1)
    assert calls_diag["n"] == 1
    assert exc_info.value.retryable is False
    assert "identifier undefined" in exc_info.value.detail


def test_compiles_are_counted_and_billed():
    """A successful compile counts in ``compile/*`` once the listener is
    installed, and bills ``compile_seconds`` to the job in scope."""
    from raydp_tpu_torch.telemetry import accounting

    profiling.install_compile_listener()
    with accounting.job_scope(accounting.mint_job("compile-bill")):
        profiling.run_compile(lambda: time.sleep(0.01), "unit")
    counters = metrics.snapshot()["counters"]
    assert counters["compile/count"] == 1
    assert counters["compile/seconds"] >= 0.01
    billed = [v for k, v in counters.items()
              if k.startswith("job/") and k.endswith("/compile_seconds")]
    assert billed and billed[0] >= 0.01


# -- FLOP counts ---------------------------------------------------------------

def _qkv(b, s, h, d, dtype=torch.float32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=g, dtype=torch.float32)
            .to(dtype).requires_grad_() for _ in range(3)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,block", [(64, 128), (128, 32)])
def test_flash_wrapper_counts_as_its_plain_version(causal, s, block):
    """Forward and backward through the wrapper count what the plain
    forward and backward count under ``FlopCounterMode``."""
    q, k, v = _qkv(2, s, 2, 16)
    with FlopCounterMode(display=False) as wrapped:
        out = fa.flash_attention(q, k, v, causal, block, block)
        out.sum().backward()
    q2, k2, v2 = (x.detach() for x in (q, k, v))
    with FlopCounterMode(display=False) as plain:
        o, lse = fa.flash_attention_plain(q2, k2, v2, causal, block, block)
        fa.flash_attention_backward_plain(q2, k2, v2, o, lse,
                                          torch.ones_like(o), causal,
                                          block, block)
    assert wrapped.get_total_flops() == plain.get_total_flops() > 0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,block", [(64, 128), (128, 32)])
def test_kernel_count_equals_the_plain_count(causal, s, block):
    """The count a wrapper adds on a card (``_count_kernel``: its live
    tiles' matmuls) equals the counter's count of the plain version it
    replaces, kernel by kernel."""
    b, h, d = 2, 2, 16
    q, k, v = (x.detach() for x in _qkv(b, s, h, d))
    o, lse = fa.flash_attention_plain(q, k, v, causal, block, block)
    g = torch.ones_like(o)
    delta = fa.flash_bwd_delta_plain(o, g)
    plain_calls = {
        2: lambda: fa.flash_attention_plain(q, k, v, causal, block, block),
        3: lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal,
                                         block, block),
        4: lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal,
                                          block, block),
    }
    for matmuls, call in plain_calls.items():
        with FlopCounterMode(display=False) as counter:
            call()
        tally = {"flops": 0.0}
        profiling._kernel_tally = tally
        try:
            fa._count_kernel(q, matmuls, causal, block, block)
        finally:
            profiling._kernel_tally = None
        assert tally["flops"] == counter.get_total_flops(), matmuls


@pytest.mark.parametrize("causal", [False, True])
def test_wrappers_on_meta_tensors_count_and_launch_nothing(causal):
    """On meta tensors (the step count's pass) the wrappers and their
    autograd backward return their outputs' shapes, add the count the
    plain versions get on the CPU, and launch nothing."""
    b, s, h, d = 2, 64, 2, 16
    q, k, v = _qkv(b, s, h, d)
    with FlopCounterMode(display=False) as plain:
        fa.flash_attention(q, k, v, causal, 32, 32).sum().backward()
    qm, km, vm = (torch.empty_like(x, device="meta").requires_grad_()
                  for x in (q, k, v))
    before = [fn.launches for fn in fa._COUNTED]
    out, cost = profiling.count_cost(
        lambda: fa.flash_attention(qm, km, vm, causal, 32, 32)
        .float().sum().backward())
    assert cost["flops"] == plain.get_total_flops() > 0
    assert qm.grad.shape == qm.shape and qm.grad.is_meta
    assert [fn.launches for fn in fa._COUNTED] == before


def test_transformer_step_counts_the_closed_form():
    """One train step of a 2-layer narrow flash classifier (batch 4,
    sequence 64, width 64, 4 heads, d_ff 128), counted on the meta device
    (``count_train_step``, what the estimator registers), against the
    closed form, within 5%: every linear layer 2·T·in·out forward and
    twice that backward, the attention tiles 4·B·S²·d forward and
    14·B·S²·d backward (dq and dk/dv each recompute S and dP, as the
    kernels do). The model is left as it was, and a second call with
    the same shapes is the cached count."""
    B, S, D, F, L, C = 4, 64, 64, 128, 2, 2
    cfg = tiny_transformer(vocab_size=97, d_model=D, n_heads=4, n_layers=L,
                           d_ff=F, max_len=S, attention_impl="flash")
    model = SequenceClassifier(cfg, num_classes=C, device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ids = torch.randint(0, 97, (B, S), generator=torch.Generator()
                        .manual_seed(0))
    profiling._STEP_COSTS.clear()
    cost = profiling.count_train_step(model, (ids,))
    T = B * S
    linears = L * 2 * T * (4 * D * D + 2 * D * F) + 2 * B * (D * D + D * C)
    attention = L * (4 + 14) * B * S * S * D
    closed = 3 * linears + attention
    assert cost["flops"] == pytest.approx(closed, rel=0.05)
    assert cost["dtype"] == "bfloat16"  # float32 weights, bf16 compute
    assert cost["count_s"] > 0
    assert model.training
    for n, p in model.named_parameters():
        assert p.device.type == "cpu" and p.grad is None, n
        assert torch.equal(p, before[n]), n
    assert profiling.count_train_step(model, (ids,)) == cost


def test_device_peaks_without_a_card_are_none():
    peaks = dp.device_peaks()
    assert peaks["flops_per_sec"] is None and peaks["kind"] is None
    assert dp.peak_flops("bfloat16", peaks) is None


def test_peak_table_rows_for_h100():
    """The data sheet's dense peaks: SXM (the name an SXM card reports)
    and PCIe, picked by name; an unknown card has none."""
    def rows(kind):
        for tag, by_dtype, bw in dp._DEVICE_PEAKS:
            if tag in kind:
                return by_dtype, bw
        return None

    sxm, bw = rows("NVIDIA H100 80GB HBM3")
    assert (sxm["bfloat16"], sxm["tf32"], sxm["float32"], bw) == (
        989e12, 495e12, 67e12, 3.35e12)
    pcie, bw = rows("NVIDIA H100 PCIe")
    assert (pcie["bfloat16"], bw) == (756e12, 2.0e12)
    assert rows("NVIDIA A100-SXM4-80GB") is None


def test_phase_split_from_device_spans():
    """The epoch's wall splits into the steps' device spans (collective,
    the rest compute) and the host time outside them (the loop's input
    wait where it fell there, the rest dispatch); the fractions sum to
    one."""
    acc = dp.StepPhaseAccumulator("unit-split")
    acc.note_input_wait(0.2)
    for _ in range(4):
        acc.step(0.01)
    out = acc.epoch_summary(wall_s=1.0, device_s=0.7, collective_s=0.5)
    assert out["steps"] == 4
    assert out["collective_s"] == pytest.approx(0.5)
    assert out["compute_s"] == pytest.approx(0.2)
    assert out["input_wait_s"] == pytest.approx(0.2)
    assert out["dispatch_s"] == pytest.approx(0.1)
    assert out["bound"] == "collective-bound"
    assert sum(out[k] for k in ("input_wait_frac", "dispatch_frac",
                                "compute_frac", "collective_frac")) == \
        pytest.approx(1.0, abs=1e-3)
    # Input wait hidden under the device spans is not exposed wait.
    acc.note_input_wait(0.5)
    acc.step(0.01)
    out = acc.epoch_summary(wall_s=1.0, device_s=0.9)
    assert out["input_wait_s"] == pytest.approx(0.1)
    assert out["dispatch_s"] == pytest.approx(0.0)
    # Spans the host paced (launching onto an idle card) are dispatch:
    # a host-bound epoch reads host-bound, not compute.
    acc.step(0.01)
    out = acc.epoch_summary(wall_s=1.0, device_s=0.9, paced_s=0.8)
    assert out["dispatch_s"] == pytest.approx(0.9)
    assert out["compute_s"] == pytest.approx(0.1)
    assert out["bound"] == "host-bound"


class _Event:
    """A CUDA event's stand-in: completed once ``done``, its time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_step_clock_folds_completed_steps_and_splits_paced_time():
    """The estimator's step clock holds only the steps the card has not
    finished (polled, never waited on), puts the events on the host's
    clock by the epoch's first step, and counts the part of a step's span
    from the card's start of it to the host's last launch (less the
    host's exchange) as paced; the rest folds at the epoch's end."""
    from raydp_tpu_torch.train.estimator import _StepClock

    clock = _StepClock(torch.device("cpu"))
    clock.cuda = True
    # Step 1 starts on an idle card; the host launches it over 8 ms of
    # its 10 ms span.
    clock.begin()
    clock.end((_Event(0.0), None, None, _Event(10.0)), 100.0, 100.008, 0.0)
    clock.begin()
    assert not clock._pending  # finished: folded
    # Step 2: the host starts 1 ms before the card finishes step 1 and
    # launches until 1 ms after the card starts it: 1 ms paced.
    ends = [_Event(25.0, done=False), _Event(60.0, done=False)]
    clock.end((_Event(10.0), None, None, ends[0]), 100.009, 100.011, 0.0)
    clock.begin()
    assert len(clock._pending) == 1  # the card is still on step 2
    # Step 3 carries a 20 ms exchange the host waits 21 ms in; the host
    # ends its launches 26 ms after the card starts it: 5 ms paced.
    clock.end((_Event(25.0), _Event(30.0), _Event(50.0), ends[1]),
              100.012, 100.051, 0.021)
    assert len(clock._pending) == 2
    ends[0].done = True
    clock.begin()
    assert len(clock._pending) == 1
    ends[1].done = True
    totals = clock.epoch_totals()
    assert totals["steps"] == 3
    assert totals["step_ms"] == pytest.approx(60.0)
    assert totals["allreduce_ms"] == pytest.approx(20.0)
    assert totals["paced_ms"] == pytest.approx(8.0 + 1.0 + 5.0)
    assert not clock._pending and clock.epoch_totals()["steps"] == 0
    # A host far ahead of the card paces none of the span.
    clock.end((_Event(0.0), None, None, _Event(10.0)), 200.0, 200.001, 0.0)
    clock.end((_Event(10.0), None, None, _Event(20.0)), 200.002, 200.003,
              0.0)
    assert clock.epoch_totals()["paced_ms"] == pytest.approx(1.0)
    # On the CPU the host's clock is the device's: nothing is paced.
    cpu = _StepClock(torch.device("cpu"))
    cpu.end((0.0, None, None, 0.01), 0.0, 0.01, 0.0)
    assert cpu.epoch_totals() == {"steps": 1, "step_ms": 10.0,
                                  "allreduce_ms": 0.0, "paced_ms": 0.0}


_CLIENT_CAPTURE = """
import json, sys
import raydp_tpu_torch
s = raydp_tpu_torch.connect(sys.argv[1])
merged = s.cluster.capture_profile(0.3, out_dir=sys.argv[2])
print("RESULT " + json.dumps({"ranks": len(merged["ranks"]),
                              "errors": merged.get("errors")}))
raydp_tpu_torch.stop()
"""


def test_cluster_capture_dashboard_and_debug_routes(tmp_path, monkeypatch):
    """A port session captures the driver and its workers into one
    merged trace, serves ``/debug/profile`` and ``/debug/dashboard`` on
    its metrics endpoint, samples its time series for the SLO engine,
    and a ``connect()``ed driver captures the workers too."""
    import subprocess
    import sys
    import urllib.request

    monkeypatch.setenv("RAYDP_TPU_METRICS_PORT", "0")
    s = raydp_tpu_torch.init(app_name="capture-routes", num_workers=2)
    try:
        with time_limit(LIMIT_S):
            merged = s.cluster.capture_profile(0.3,
                                               out_dir=str(tmp_path / "m"))
            assert len(merged["ranks"]) == 3 and not merged.get("errors")
            with open(merged["merged_trace"]) as f:
                doc = json.load(f)
            procs = {e["args"]["name"] for e in doc["traceEvents"]
                     if e.get("ph") == "M"
                     and e.get("name") == "process_name"}
            assert {p.split(":")[0] for p in procs} >= {
                "rank 0", "rank 1", "rank 2"}, procs

            base = f"http://127.0.0.1:{s.cluster._metrics_server.port}"
            with urllib.request.urlopen(f"{base}/debug/profile?seconds=0.2",
                                        timeout=60) as resp:
                assert resp.status == 200
                assert json.loads(resp.read())["merged_trace"]
            with urllib.request.urlopen(f"{base}/debug/dashboard",
                                        timeout=60) as resp:
                assert resp.status == 200
                dash = json.loads(resp.read())
            assert {"train", "etl", "serve", "slo", "jobs"} <= set(dash)
            assert set(s.cluster.dashboard_report()) == set(dash)

            sampler = s.cluster._ts_sampler
            assert sampler is not None and s.cluster._slo_engine is not None
            sampler.sample()
            assert sampler.store.names()

            out = subprocess.run(
                [sys.executable, "-c", _CLIENT_CAPTURE,
                 s.cluster.master.address, str(tmp_path / "client")],
                capture_output=True, text=True, timeout=120)
            assert out.returncode == 0, out.stderr[-2000:]
            line = next(l for l in out.stdout.splitlines()
                        if l.startswith("RESULT "))
            assert json.loads(line[len("RESULT "):]) == {"ranks": 2,
                                                         "errors": None}
    finally:
        raydp_tpu_torch.stop()
