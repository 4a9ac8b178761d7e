"""Process-wide counters, gauges, timers, histograms and throughput
meters, and the profiler hooks.

The port's copy of the JAX package's ``utils/profiling.py``: the registry
(``counter_add``, ``gauge_set``/``gauge_value``/``gauge_max``, ``meter``
(:class:`ThroughputMeter`), ``timer`` (:class:`StepTimer`), ``histogram``
(:class:`Histogram`), ``snapshot``/``reset``),
:func:`sample_resource_gauges`, and the counterparts of its XLA hooks on
``torch.profiler``:

* :func:`trace` writes a Chrome trace of the block (host ops always,
  CUDA kernels where a card is present); :func:`annotate` names a region
  in it (and an NVTX range on a card).
* :func:`install_compile_listener` counts the port's compiles
  (``compile/count``, ``compile/seconds``): a kernel library built by
  ``nvcc`` (``ops/_build.py``) and a step captured into a CUDA graph
  (``utils/graphed.py``), both reported through :func:`run_compile`,
  which also bills ``compile_seconds`` to the job and turns a failure
  into a :class:`CompileError` (:func:`enrich_compile_error`).
* :func:`cost_analysis_summary` counts a call's FLOPs with
  ``torch.utils.flop_counter.FlopCounterMode``. The flash-attention
  wrappers launch their kernels without the dispatcher, so on a card
  (and on meta tensors) they add their own count (:func:`add_kernel_cost`):
  the FLOPs of the tiles they compute, equal to what the counter gives
  their plain versions on the CPU, so a step counts the same everywhere.
  The JAX package's XLA cost analysis sees no FLOPs inside its Pallas
  calls (they carry no ``cost_estimate``); the port counts attention.
  :func:`count_train_step` counts a train step on the meta device, once
  a process per configuration, for the device plane's ``mfu``: no step
  runs under the counter.
"""
from __future__ import annotations

import bisect
import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

__all__ = [
    "CompileError",
    "Histogram",
    "MetricsRegistry",
    "StepTimer",
    "ThroughputMeter",
    "add_kernel_cost",
    "annotate",
    "cost_analysis_summary",
    "compute_dtype",
    "count_cost",
    "count_train_step",
    "enrich_compile_error",
    "install_compile_listener",
    "metrics",
    "quantile_from_hist_summary",
    "run_compile",
    "sample_resource_gauges",
    "trace",
]


class StepTimer:
    """Rolling window of step durations with percentiles. A per-timer
    lock covers the deque: ``snapshot()`` from a monitoring thread must
    not race a mutating append."""

    def __init__(self, window: int = 1024):
        self.window = window
        self._times: "deque[float]" = deque(maxlen=window)
        self._total = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, seconds: float) -> None:
        with self._mu:
            self._times.append(seconds)
            self._total += seconds
            self._count += 1

    @contextlib.contextmanager
    def time(self) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0)

    def percentile(self, q: float) -> float:
        with self._mu:
            xs = sorted(self._times)
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]

    def summary(self) -> Dict[str, float]:
        with self._mu:
            xs = sorted(self._times)
            total, count = self._total, self._count

        def pct(q: float) -> float:
            if not xs:
                return 0.0
            return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]

        return {
            "count": float(count),
            "total_s": total,
            "mean_s": total / max(1, count),
            "p50_s": pct(50),
            "p90_s": pct(90),
            "p99_s": pct(99),
        }


class ThroughputMeter:
    """Counts units (tokens, rows) against wall time since the first add."""

    def __init__(self):
        self._units = 0.0
        self._start: Optional[float] = None
        self._last: Optional[float] = None
        self._mu = threading.Lock()

    def add(self, units: float) -> None:
        now = time.perf_counter()
        with self._mu:
            if self._start is None:
                self._start = now
            self._last = now
            self._units += units

    def _rate_locked(self) -> float:
        if self._start is None or self._last is None or self._last <= self._start:
            return 0.0
        return self._units / (self._last - self._start)

    @property
    def total(self) -> float:
        with self._mu:
            return self._units

    def rate(self) -> float:
        with self._mu:
            return self._rate_locked()

    def summary(self) -> Dict[str, float]:
        with self._mu:
            return {"total": self._units, "per_sec": self._rate_locked()}


class Histogram:
    """Fixed-bucket distribution, cumulative over the process lifetime.

    Buckets are upper bounds; counts are stored per bucket and emitted
    cumulatively by :meth:`summary`, so summaries of several processes
    merge by summation."""

    # Log-spaced bounds from ~100 µs to minutes keep quantile error
    # within one bucket.
    DEFAULT_BUCKETS = (
        0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
        0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
    )

    def __init__(self, buckets: Optional[List[float]] = None):
        bounds = tuple(sorted(buckets)) if buckets else self.DEFAULT_BUCKETS
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1: the +Inf bucket
        self._sum = 0.0
        self._count = 0
        self._mu = threading.Lock()

    def observe(self, value: float) -> None:
        idx = bisect.bisect_left(self.bounds, value)
        with self._mu:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    def summary(self) -> Dict[str, object]:
        """``{"sum", "count", "buckets": {"<le>": cumulative, ...,
        "+Inf": count}}``."""
        with self._mu:
            counts = list(self._counts)
            total, n = self._sum, self._count
        buckets: Dict[str, float] = {}
        running = 0
        for bound, c in zip(self.bounds, counts):
            running += c
            buckets[repr(bound)] = float(running)
        buckets["+Inf"] = float(n)
        return {"sum": total, "count": float(n), "buckets": buckets}

    def quantile(self, q: float) -> Optional[float]:
        """Quantile to within one bucket (linear inside the containing
        bucket); ``None`` when nothing was observed."""
        return quantile_from_hist_summary(self.summary(), q)


def quantile_from_hist_summary(
    summary: Dict[str, object], q: float
) -> Optional[float]:
    """Quantile from a :meth:`Histogram.summary` dict (also a merged
    one). ``None`` on zero observations; values in the +Inf bucket
    report the largest finite bound."""
    try:
        count = float(summary.get("count", 0.0))  # type: ignore[union-attr]
        buckets = summary.get("buckets") or {}
    except AttributeError:
        return None
    if count <= 0 or not buckets:
        return None
    q = min(max(q, 0.0), 1.0)
    rank = q * count
    finite = sorted(
        (float(le), float(c)) for le, c in buckets.items() if le != "+Inf"
    )
    prev_bound, prev_cum = 0.0, 0.0
    for bound, cum in finite:
        if cum >= rank:
            span = cum - prev_cum
            if span <= 0:
                return bound
            frac = (rank - prev_cum) / span
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return finite[-1][0] if finite else None


@dataclass
class MetricsRegistry:
    """Named counters, gauges, timers, meters and histograms; one
    process-wide instance at :data:`metrics`."""

    _lock: threading.Lock = field(default_factory=threading.Lock)
    _counters: Dict[str, float] = field(default_factory=dict)
    _timers: Dict[str, StepTimer] = field(default_factory=dict)
    _meters: Dict[str, ThroughputMeter] = field(default_factory=dict)
    _gauges: Dict[str, float] = field(default_factory=dict)
    _hists: Dict[str, Histogram] = field(default_factory=dict)

    def counter_add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value

    def gauge_set(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)

    def gauge_value(self, name: str) -> Optional[float]:
        """Last value set on a gauge (None when never set)."""
        with self._lock:
            return self._gauges.get(name)

    def gauge_max(self, name: str, value: float) -> None:
        """Watermark gauge: keeps the max ever observed."""
        with self._lock:
            prev = self._gauges.get(name)
            if prev is None or value > prev:
                self._gauges[name] = float(value)

    def timer(self, name: str) -> StepTimer:
        with self._lock:
            if name not in self._timers:
                self._timers[name] = StepTimer()
            return self._timers[name]

    def meter(self, name: str) -> ThroughputMeter:
        with self._lock:
            if name not in self._meters:
                self._meters[name] = ThroughputMeter()
            return self._meters[name]

    def histogram(
        self, name: str, buckets: Optional[List[float]] = None
    ) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(buckets)
            return self._hists[name]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            out: Dict[str, Dict[str, float]] = {
                "counters": dict(self._counters)
            }
            if self._gauges:
                out["gauges"] = dict(self._gauges)
            for name, t in self._timers.items():
                out[f"timer/{name}"] = t.summary()
            for name, m in self._meters.items():
                out[f"meter/{name}"] = m.summary()
            for name, h in self._hists.items():
                out[f"hist/{name}"] = h.summary()
            return out

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._timers.clear()
            self._meters.clear()
            self._gauges.clear()
            self._hists.clear()


metrics = MetricsRegistry()


def _cuda_ready() -> bool:
    """True when torch is loaded and has a CUDA context in this process
    (never imports torch, never starts a context)."""
    import sys

    torch = sys.modules.get("torch")
    try:
        return torch is not None and torch.cuda.is_initialized()
    except Exception:
        return False


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` and write its Chrome
    trace to ``log_dir/trace-<pid>.json``: host ops always, the card's
    kernels and copies where this process has a CUDA context (CUPTI
    records every thread's launches)."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if _cuda_ready():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace-{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named region on the trace's host timeline
    (``torch.profiler.record_function``), and an NVTX range on a card."""
    import torch

    nvtx = _cuda_ready()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


# -- compile accounting ----------------------------------------------------
_COMPILE_LISTENER_INSTALLED = False
COMPILE_RETRIES_ENV = "RAYDP_TPU_COMPILE_RETRIES"


def install_compile_listener() -> bool:
    """Count the port's compiles (kernel builds, CUDA graph captures)
    into ``compile/count`` and ``compile/seconds`` from now on, in this
    process. Idempotent; returns True."""
    global _COMPILE_LISTENER_INSTALLED
    _COMPILE_LISTENER_INSTALLED = True
    return True


class CompileError(RuntimeError):
    """A structured compile failure: ``label`` (what was compiled: a
    kernel source, a captured step), ``duration_s``, ``exit_code`` (the
    compiler's, where a process ran one; negative for a signal),
    ``payload_bytes`` (the inputs' size, where known), ``detail`` (the
    compiler's own diagnostics) and ``retryable``: True only where the
    compiler was killed by a signal (an OOM kill under a parallel build),
    which an identical retry can survive; a diagnostic is deterministic
    and retrying it burns time."""

    def __init__(self, message: str, *, label: str, duration_s: float,
                 exit_code: Optional[int] = None,
                 payload_bytes: Optional[int] = None, detail: str = "",
                 retryable: bool = False):
        super().__init__(message)
        self.label = label
        self.duration_s = duration_s
        self.exit_code = exit_code
        self.payload_bytes = payload_bytes
        self.detail = detail
        self.retryable = retryable


_EXIT_RE = None


def enrich_compile_error(exc: BaseException, duration_s: float, label: str,
                         payload_bytes: Optional[int] = None
                         ) -> CompileError:
    """An actionable :class:`CompileError` for a failed compile: the
    label, how long it ran, the compiler's exit code where the text
    carries one (``ops/_build.py``: ``nvcc failed on <src> (exit N)``),
    every line of its diagnostics, and ``retryable`` for a compiler
    killed by a signal. Counts ``compile/failures`` and the seconds, and
    puts ``compile/failed`` on the event timeline. Chain it with
    ``raise ... from exc``."""
    global _EXIT_RE
    if _EXIT_RE is None:
        import re

        _EXIT_RE = re.compile(r"\(exit (-?\d+)\)")
    text = str(exc)
    lines = [f"Compilation failed in {label!r} after {duration_s:.1f}s "
             f"({type(exc).__name__})."]
    m = _EXIT_RE.search(text)
    exit_code = int(m.group(1)) if m else None
    # Killed by a signal: negative from Popen, 128 + N from a shell.
    retryable = exit_code is not None and (exit_code < 0 or exit_code > 128)
    detail = text.strip()
    lines.append(f"Compiler said: {detail or '(empty message)'}")
    if exit_code is not None:
        lines.append(f"Compiler exit code: {exit_code}.")
    if payload_bytes:
        lines.append(f"Input payload: {payload_bytes} bytes.")
    if retryable:
        lines.append(
            "The compiler was killed by a signal (often the OOM killer "
            "under parallel builds): transient (CompileError.retryable="
            f"True); {COMPILE_RETRIES_ENV} controls automatic retries.")
    err = CompileError("\n".join(lines), label=label, duration_s=duration_s,
                       exit_code=exit_code, payload_bytes=payload_bytes,
                       detail=detail, retryable=retryable)
    metrics.counter_add("compile/failures")
    metrics.counter_add("compile/seconds", duration_s)
    try:  # timeline correlation (lazy: events imports this registry)
        from raydp_tpu_torch.telemetry import events as _events

        _events.emit("compile/failed", label=label,
                     duration_s=round(duration_s, 3), retryable=retryable,
                     **{k: v for k, v in (("exit_code", exit_code),
                                          ("payload_bytes", payload_bytes))
                        if v})
    except Exception:
        pass
    return err


def run_compile(fn: Callable, label: str, *args, **kwargs):
    """``fn(*args, **kwargs)`` as one compile: timed into
    ``compile/count``/``compile/seconds`` (with the listener installed)
    and billed as the job's ``compile_seconds``; a failure raises a
    :class:`CompileError` chained to it, after up to
    ``RAYDP_TPU_COMPILE_RETRIES`` (default 1) retries of a retryable
    one."""
    import os

    try:
        retries = max(0, int(os.environ.get(COMPILE_RETRIES_ENV, "1")))
    except ValueError:
        retries = 1
    attempt = 0
    while True:
        start = time.monotonic()
        try:
            out = fn(*args, **kwargs)
            break
        except Exception as exc:
            enriched = enrich_compile_error(exc, time.monotonic() - start,
                                            label)
            if enriched.retryable and attempt < retries:
                attempt += 1
                continue
            raise enriched from exc
    seconds = time.monotonic() - start
    if _COMPILE_LISTENER_INSTALLED:
        metrics.counter_add("compile/count")
        metrics.counter_add("compile/seconds", seconds)
    try:
        from raydp_tpu_torch.telemetry import accounting as _acct

        _acct.add_usage(_acct.COMPILE_SECONDS, seconds)
    except Exception:
        pass
    return out


# -- cost analysis ---------------------------------------------------------
# The FLOPs of a counting call in flight (``count_cost``), which the
# kernel wrappers add to. None outside one.
_kernel_tally: Optional[Dict[str, float]] = None


def add_kernel_cost(flops: float) -> None:
    """Called by a kernel wrapper where it launches a kernel the
    dispatcher does not see, or stands in for one on meta tensors: add
    its FLOPs to the counting call in flight (nothing outside one)."""
    tally = _kernel_tally
    if tally is not None:
        tally["flops"] += flops


def _tensors(tree) -> List[Any]:
    import torch
    from torch.utils._pytree import tree_flatten

    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def count_cost(fn: Callable, args=(), kwargs=None
               ) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Run ``fn(*args, **kwargs)`` once under ``FlopCounterMode``; returns
    ``(its result, {"flops", "bytes", "collective_bytes", "dtype"})``.
    ``flops`` adds the kernel wrappers' own counts; ``bytes`` are the
    call's tensor arguments and results, each once (the least it moves:
    the count sees no op's traffic); ``collective_bytes`` is 0.0, as the
    JAX package's where its analysis reports none; ``dtype`` is that of
    the floating-point arguments with most elements (None without any).
    The summary is None where nothing was counted. The call runs for
    real (its effects stay)."""
    global _kernel_tally
    from torch.utils.flop_counter import FlopCounterMode

    tally = {"flops": 0.0}
    counter = FlopCounterMode(display=False)
    _kernel_tally = tally
    try:
        with counter:
            out = fn(*args, **(kwargs or {}))
    finally:
        _kernel_tally = None
    flops = float(counter.get_total_flops()) + tally["flops"]
    nbytes = float(sum(t.numel() * t.element_size()
                       for t in _tensors((args, kwargs, out))))
    if flops <= 0.0 and nbytes <= 0.0:
        return out, None
    floats: Dict[str, int] = {}
    for t in _tensors((args, kwargs)):
        if t.is_floating_point():
            key = str(t.dtype).replace("torch.", "")
            floats[key] = floats.get(key, 0) + t.numel()
    dtype = max(floats, key=floats.get) if floats else None
    return out, {"flops": flops, "bytes": nbytes,
                 "collective_bytes": 0.0, "dtype": dtype}


def cost_analysis_summary(fn: Callable, args=(), kwargs=None
                          ) -> Optional[Dict[str, Any]]:
    """``{"flops", "bytes", "collective_bytes", "dtype"}`` of one call of
    ``fn`` (:func:`count_cost`; the call runs), or None where nothing was
    counted."""
    return count_cost(fn, args, kwargs)[1]


def compute_dtype(model) -> Optional[str]:
    """The dtype most of ``model``'s parameters compute in: a module's
    ``compute_dtype`` where it declares one (the transformer's layers
    keep float32 weights and compute in ``cfg.dtype``), else the
    parameter's own dtype; weighed by element count."""
    by: Dict[str, int] = {}
    for m in model.modules():
        declared = getattr(m, "compute_dtype", None)
        for p in m.parameters(recurse=False):
            key = str(declared or p.dtype).replace("torch.", "")
            by[key] = by.get(key, 0) + p.numel()
    return max(by, key=by.get) if by else None


# Step counts by (model class, parameter shapes, input shapes), so a
# process counts each configuration once, whatever its number of fits.
_STEP_COSTS: Dict[Any, Dict[str, Any]] = {}
_STEP_COSTS_MAX = 64


def _meta_clone(model):
    """A copy of ``model`` whose parameters, buffers and tensor attributes
    are empty tensors of the same shapes on the meta device (no data is
    copied); generators are shared, never copied."""
    import copy

    import torch

    memo: Dict[int, Any] = {}
    for m in model.modules():
        for value in vars(m).values():
            if isinstance(value, torch.Generator):
                memo[id(value)] = value
            elif isinstance(value, torch.Tensor):
                memo[id(value)] = torch.empty_like(value, device="meta")
    for p in model.parameters():
        memo[id(p)] = torch.nn.Parameter(
            torch.empty_like(p, device="meta"), p.requires_grad)
    for b in model.buffers():
        memo[id(b)] = torch.empty_like(b, device="meta")
    return copy.deepcopy(model, memo)


def count_train_step(model, inputs: Tuple[Any, ...]
                     ) -> Optional[Dict[str, Any]]:
    """``{"flops", "dtype", "count_s"}`` of one train step of ``model``
    on inputs shaped like ``inputs``: the forward and the backward of
    its outputs' sum, run on a meta-device copy of it under
    :func:`count_cost` (shapes only: no kernel runs, ``model`` and its
    generators are left as they were), in eval mode (dropout draws
    nothing). A loss adds no matmul, so it is left out; the optimizer's
    update is elementwise and counts none either. ``count_s`` is the
    host seconds of the pass that counted it; a later call with the same
    model class, parameter shapes and input shapes returns the cached
    count. None where the model cannot run on meta tensors (an op with
    no meta kernel, a value read on the host)."""
    import torch
    from torch.utils._pytree import tree_map

    def shape(t):
        return ((tuple(t.shape), t.dtype) if isinstance(t, torch.Tensor)
                else t)

    key = (type(model).__qualname__,
           tuple((n, tuple(p.shape), p.dtype)
                 for n, p in model.named_parameters()),
           repr(tree_map(shape, inputs)))
    cached = _STEP_COSTS.get(key)
    if cached is not None:
        return dict(cached)
    t0 = time.perf_counter()
    meta_inputs = tree_map(
        lambda t: torch.empty_like(t, device="meta")
        if isinstance(t, torch.Tensor) else t, inputs)

    def step(clone):
        grads = [t for t in _tensors(clone(*meta_inputs))
                 if t.requires_grad and t.is_floating_point()]
        if grads:
            sum(t.float().sum() for t in grads).backward()

    try:
        _, cost = count_cost(step, (_meta_clone(model).eval(),))
    except Exception as exc:  # no meta path: no count, no invented MFU
        metrics.counter_add("cost/uncounted")
        import logging

        logging.getLogger(__name__).info(
            "train step not counted on the meta device: %s", exc)
        return None
    if not cost or cost["flops"] <= 0.0:
        return None
    out = {"flops": cost["flops"], "dtype": compute_dtype(model),
           "count_s": time.perf_counter() - t0}
    if len(_STEP_COSTS) >= _STEP_COSTS_MAX:
        _STEP_COSTS.pop(next(iter(_STEP_COSTS)))
    _STEP_COSTS[key] = out
    return dict(out)


def sample_resource_gauges(registry: Optional[MetricsRegistry] = None) -> None:
    """Refresh the resource gauges on ``registry`` (default: the process
    registry): host RSS current/peak, the CUDA memory this process holds
    (``hbm/used_bytes`` and ``hbm/peak_bytes``: the JAX package's names,
    here ``torch.cuda.memory_allocated``/``max_memory_allocated`` summed
    over the process's cards), and the shm object store's occupancy when
    a store is open in this process. Called from worker heartbeats, SPMD
    pings and driver snapshots: one procfs read and dict lookups.

    ``torch`` is looked up in ``sys.modules``, never imported, and the
    card is read only once CUDA is initialised, so a torch-free ETL
    worker stays torch-free and no process starts a CUDA context here."""
    reg = registry if registry is not None else metrics
    from raydp_tpu_torch.utils.memory import host_rss_bytes

    rss, peak = host_rss_bytes()
    if rss:
        reg.gauge_set("mem/rss_bytes", rss)
        reg.gauge_max("mem/rss_peak_bytes", peak)
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is not None and torch.cuda.is_initialized():
            used = hwm = 0
            for dev in range(torch.cuda.device_count()):
                used += int(torch.cuda.memory_allocated(dev))
                hwm += int(torch.cuda.max_memory_allocated(dev))
            reg.gauge_set("hbm/used_bytes", used)
            reg.gauge_max("hbm/peak_bytes", hwm)
    except Exception:
        pass  # no card or a partial torch: skip the device gauges
    try:
        from raydp_tpu_torch.store.object_store import get_current_store

        store = get_current_store()
        if store is not None:
            occ = store.occupancy_bytes()
            reg.gauge_set("store/occupancy_bytes", occ)
            reg.gauge_max("store/occupancy_peak_bytes", occ)
    except Exception:
        pass
