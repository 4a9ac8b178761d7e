"""Device performance plane: where does a training step's time go?

The port's counterpart of ``raydp_tpu/telemetry/device_profiler.py``
(the names kept). Four pieces:

* **Step-phase accounting.** :class:`StepPhaseAccumulator` splits a
  stream epoch's loop wall (the host clock from the loop's start to the
  epoch's one loss sync) into ``input_wait``, ``dispatch``, ``compute``
  and ``collective``. The reference reads device time off its
  donated-buffer block; the port donates nothing, so the device side
  comes from CUDA events around each step and around its gradient
  exchange (the estimator's step clock), folded as they complete: no
  per-step host sync. ``collective`` is the measured exchange. From the
  card's start of a step until the host's last launch of it (the events
  put on the host's clock by the epoch's first step, begun on an idle
  card), the card can only run what the host has launched: that part of
  the span is ``dispatch`` (the host paces it), the rest ``compute``. A
  host far ahead of the card paces none of it. The host time outside the
  spans is the exposed ``input_wait`` (the loop blocked on the next
  batch, as ``ingest/wait_seconds`` counts it) and, the rest,
  ``dispatch``. The four sum to the wall, so the fractions sum to 1.
  The bound verdict (:func:`classify_fractions`) reads these measured
  fractions only.
* **MFU.** :func:`note_compiled` registers a step's FLOPs
  (``utils/profiling.count_train_step``: the step counted once on the
  meta device); with the measured wall this gives the ``mfu`` gauge
  against the card's peak for the dtype the model computes in
  (:func:`device_peaks`).
* **Trace capture across a gang.** :func:`capture_trace_archive` runs
  ``utils/profiling.trace`` (``torch.profiler``) for N seconds, flushes
  the span ring beside it and zips the directory; a driver fans a
  ``ProfileRequest`` to every rank or worker at once and
  :func:`merge_rank_traces` aligns the per-rank Chrome traces and span
  shards into ONE Perfetto-loadable JSON.
* **Anomaly sentinels.** :class:`AnomalySentinel` checks loss and global
  grad-norm finiteness on a sampled cadence (a ``float()`` every step
  would sync the host with the device) and flags step-time regressions
  against a rolling median; both leave flight records, events and
  ``anomalies/*`` counters.

Kill switch: ``RAYDP_TPU_DEVICE_PLANE=0`` turns off the phase
accounting, the step count and the sentinels (a capture is explicit and
stays available).
"""
from __future__ import annotations

import glob
import io
import json
import os
import tempfile
import threading
import time
import zipfile
from collections import deque
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.utils.profiling import metrics

__all__ = [
    "enabled",
    "device_peaks",
    "note_compiled",
    "get_cost",
    "StepPhaseAccumulator",
    "classify_fractions",
    "AnomalySentinel",
    "capture_local_trace",
    "capture_trace_archive",
    "merge_rank_traces",
    "unpack_trace_archive",
]

_ENABLE_ENV = "RAYDP_TPU_DEVICE_PLANE"
_SENTINEL_EVERY_ENV = "RAYDP_TPU_SENTINEL_EVERY"
_SENTINEL_COOLDOWN_ENV = "RAYDP_TPU_SENTINEL_COOLDOWN_S"
_REGRESSION_FACTOR_ENV = "RAYDP_TPU_STEP_REGRESSION_FACTOR"
_REGRESSION_MIN_ENV = "RAYDP_TPU_STEP_REGRESSION_MIN_STEPS"


def enabled() -> bool:
    return os.environ.get(_ENABLE_ENV, "1") not in ("0", "false", "no")


# -- device peaks (roofline ceilings) ---------------------------------------

# Device name substring -> (dense peak FLOP/s by compute dtype, memory
# bytes/s) of one card, from NVIDIA's H100 data sheet (dense, without
# sparsity). The PCIe row comes first: its name also holds "H100". A
# float32 matmul runs at the TF32 rate when torch allows TF32, else at
# the CUDA cores' float32 rate. Unknown cards and the CPU get no entry:
# no MFU is reported rather than one invented.
_DEVICE_PEAKS = (
    ("H100 PCIe", {"bfloat16": 756e12, "float16": 756e12,
                   "tf32": 378e12, "float32": 51e12}, 2.0e12),
    ("H100", {"bfloat16": 989e12, "float16": 989e12,
              "tf32": 495e12, "float32": 67e12}, 3.35e12),
)


def device_peaks() -> Dict[str, Any]:
    """``{"flops_per_sec", "mem_bw", "devices", "kind", "flops_by_dtype"}``
    of the card this process computes on (one a process):
    ``flops_per_sec`` is the bfloat16 peak, ``flops_by_dtype`` each
    dtype's. All None where torch is not loaded, has no CUDA context in
    this process (nothing here imports torch or starts a context), or
    the card is not in the table."""
    out: Dict[str, Any] = {"flops_per_sec": None, "mem_bw": None,
                           "devices": None, "kind": None,
                           "flops_by_dtype": None}
    try:
        import sys

        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return out
        kind = torch.cuda.get_device_name(torch.cuda.current_device())
        out["devices"] = 1.0
        out["kind"] = kind
        for tag, by_dtype, bw in _DEVICE_PEAKS:
            if tag in kind:
                out["flops_by_dtype"] = dict(by_dtype)
                out["flops_per_sec"] = by_dtype["bfloat16"]
                out["mem_bw"] = bw
                break
    except Exception:
        pass
    return out


def peak_flops(dtype: Optional[str],
               peaks: Optional[Dict[str, Any]] = None) -> Optional[float]:
    """The card's peak FLOP/s for matmuls in ``dtype`` (a torch dtype's
    name, e.g. ``"bfloat16"``), None where unknown."""
    peaks = peaks if peaks is not None else device_peaks()
    table = peaks.get("flops_by_dtype")
    if not table or dtype is None:
        return None
    if dtype == "float32":
        import sys

        torch = sys.modules.get("torch")  # loaded: there are peaks
        if torch is not None and torch.backends.cuda.matmul.allow_tf32:
            dtype = "tf32"
    return table.get(dtype)


# -- per-step cost registry ---------------------------------------------------

_cost_mu = threading.Lock()
_costs: Dict[str, Dict[str, Any]] = {}


def note_compiled(label: str, cost: Optional[Dict[str, Any]]) -> None:
    """Register ``label``'s counted cost (``{"flops", "dtype"}``, as
    ``utils/profiling.count_train_step`` gives it) for the MFU gauge.
    Each fit registers its own step, so a later registration replaces an
    earlier one (a process may fit several models); None is ignored."""
    if not enabled() or not cost:
        return
    with _cost_mu:
        _costs[label] = dict(cost)
    metrics.gauge_set(f"cost/{label}/flops", cost["flops"])


def get_cost(label: str) -> Optional[Dict[str, Any]]:
    with _cost_mu:
        cost = _costs.get(label)
        return dict(cost) if cost else None


def clear_costs() -> None:
    """Test hook: forget registered costs (labels are global)."""
    with _cost_mu:
        _costs.clear()


# -- step-phase accounting ---------------------------------------------------

def classify_fractions(
    fractions: Dict[str, float],
    intensity: Optional[float] = None,
    balance: Optional[float] = None,
) -> str:
    """Bound-ness verdict from phase fractions (and the roofline where a
    caller gives it): ``input-bound`` and ``collective-bound`` straight
    from the fractions; compute against memory from an arithmetic
    intensity (FLOPs a byte) against the machine balance (peak FLOP/s
    over bytes/s) where both are given; else a dominant compute fraction
    reads ``compute-bound`` and a dominant dispatch ``host-bound``. The
    estimator's epochs give measured fractions only."""
    inp = fractions.get("input_wait_frac", 0.0)
    coll = fractions.get("collective_frac", 0.0)
    comp = fractions.get("compute_frac", 0.0)
    disp = fractions.get("dispatch_frac", 0.0)
    if inp >= 0.35 and inp >= comp:
        return "input-bound"
    if coll >= 0.25 and coll >= comp:
        return "collective-bound"
    if intensity is not None and balance is not None and balance > 0:
        return "compute-bound" if intensity >= balance else "memory-bound"
    return "compute-bound" if comp >= disp else "host-bound"


class StepPhaseAccumulator:
    """Per-epoch phase totals of one stream training loop (the module
    docstring). The loop reports :meth:`note_input_wait` (host seconds
    blocked on the next batch) and :meth:`step` (the step call's host
    seconds); at the epoch's end :meth:`epoch_summary` takes the loop
    wall and the device seconds of the epoch's steps and exchanges, as
    the step clock measured them."""

    def __init__(self, label: str = "train_step"):
        self.label = label
        self._hist = metrics.histogram("train/step_seconds")
        self.total_steps = 0
        self.reset_epoch()

    def reset_epoch(self) -> None:
        self.epoch_phases = {
            "input_wait_s": 0.0, "dispatch_s": 0.0,
            "compute_s": 0.0, "collective_s": 0.0,
        }
        self.epoch_steps = 0

    def note_input_wait(self, seconds: float) -> None:
        """Host seconds the loop blocked pulling the next batch."""
        self.epoch_phases["input_wait_s"] += max(0.0, seconds)

    def step(self, call_s: float) -> None:
        """Fold one completed step: its host call time into the
        ``train/step_seconds`` histogram."""
        self._hist.observe(max(0.0, call_s))
        self.epoch_steps += 1
        self.total_steps += 1

    def epoch_summary(self, wall_s: float, device_s: float,
                      collective_s: float = 0.0, paced_s: float = 0.0,
                      reset: bool = True) -> Dict[str, Any]:
        """The epoch's phases and fractions from its loop wall
        ``wall_s`` and, as the step clock measured them, the device
        seconds of its steps (``device_s``, exchanges included), of their
        exchanges (``collective_s``) and the host-paced part of the
        steps' spans (``paced_s``, the module docstring); refreshes the
        ``phase/*`` gauges and counters and ``mfu``, then (by default)
        resets the epoch window."""
        device_s = max(0.0, device_s)
        coll = min(max(0.0, collective_s), device_s)
        paced = min(max(0.0, paced_s), device_s - coll)
        wall = max(wall_s, device_s)
        # Host time outside the steps' device spans: the loop's blocked
        # input wait where it fell there, then everything else.
        outside = wall - device_s
        waited = min(self.epoch_phases["input_wait_s"], outside)
        ph = {"input_wait_s": waited, "dispatch_s": outside - waited + paced,
              "compute_s": device_s - coll - paced, "collective_s": coll}
        self.epoch_phases = ph
        steps = self.epoch_steps
        fractions = {f"{k[:-2]}_frac": (v / wall if wall else 0.0)
                     for k, v in ph.items()}
        for name, value in ph.items():
            metrics.counter_add(f"phase/{name[:-2]}_seconds", value)
        for name, value in fractions.items():
            metrics.gauge_set(f"phase/{name}", round(value, 4))

        cost = get_cost(self.label)
        peak = peak_flops(cost.get("dtype") if cost else None)
        mfu = None
        if cost and steps and wall and peak:
            # Four significant digits: a small model's MFU is far below
            # 1e-4 and must not round to 0.
            mfu = float(f"{(cost['flops'] * steps) / (wall * peak):.4g}")
            metrics.gauge_set("mfu", mfu)
        out: Dict[str, Any] = {
            "steps": steps,
            "wall_s": round(wall, 6),
            "bound": classify_fractions(fractions),
            "device_s": round(device_s, 6),
            **{k: round(v, 6) for k, v in ph.items()},
            **{k: round(v, 4) for k, v in fractions.items()},
        }
        if mfu is not None:
            out["mfu"] = mfu
        if reset:
            self.reset_epoch()
        return out


# -- anomaly sentinels -------------------------------------------------------

class AnomalySentinel:
    """NaN/Inf and step-time-regression detection for a training loop.

    Finiteness checks sync the host with the device, so they run every
    ``check_every`` steps (``RAYDP_TPU_SENTINEL_EVERY``, default 64); a
    NaN persists once it appears, so the cadence bounds the lag. A NaN
    fires ONE flight-recorder bundle (cooldown-limited). The regression
    detector compares each step against the rolling median: a step over
    ``median × factor`` (default 2.5) with at least ``min_steps`` of
    history fires an event and a counter (no bundle: slow is not
    crashed), rate-limited by the same cooldown.
    """

    def __init__(
        self,
        check_every: Optional[int] = None,
        cooldown_s: Optional[float] = None,
        regression_factor: Optional[float] = None,
        regression_min_steps: Optional[int] = None,
    ):
        def _env(name, cast, default):
            raw = os.environ.get(name)
            if raw is None:
                return default
            try:
                return cast(raw)
            except ValueError:
                return default

        self.check_every = (
            check_every if check_every is not None
            else max(1, _env(_SENTINEL_EVERY_ENV, int, 64))
        )
        self.cooldown_s = (
            cooldown_s if cooldown_s is not None
            else _env(_SENTINEL_COOLDOWN_ENV, float, 60.0)
        )
        self.regression_factor = (
            regression_factor if regression_factor is not None
            else _env(_REGRESSION_FACTOR_ENV, float, 2.5)
        )
        self.regression_min_steps = (
            regression_min_steps if regression_min_steps is not None
            else _env(_REGRESSION_MIN_ENV, int, 8)
        )
        self._recent: "deque[float]" = deque(maxlen=128)
        self._last_fire: Dict[str, float] = {}
        self.tripped: List[Dict[str, Any]] = []

    def _fire(self, kind: str, bundle: bool, **attrs: Any) -> bool:
        now = time.monotonic()
        last = self._last_fire.get(kind)
        metrics.counter_add(f"anomalies/{kind}")
        if last is not None and now - last < self.cooldown_s:
            return False
        self._last_fire[kind] = now
        self.tripped.append({"kind": kind, **attrs})
        from raydp_tpu_torch.telemetry import flight_recorder as _flight

        _flight.record("anomaly", kind, **attrs)
        try:  # timeline correlation (lazy: events imports this module)
            from raydp_tpu_torch.telemetry import events as _events

            _events.emit("sentinel/anomaly", kind=kind, **attrs)
        except Exception:
            pass
        if bundle:
            try:
                _flight.dump_bundle(f"anomaly:{kind}")
            except Exception:
                pass
        return True

    def wants_check(self, step: int) -> bool:
        """True on the steps whose loss and grad-norm should be synced."""
        return step % self.check_every == 0

    def check_loss(self, value: float, step: int, epoch: int = -1) -> bool:
        """``value`` is an already-synced float. True when the NaN
        sentinel fired (bundle written)."""
        import math

        if math.isfinite(value):
            return False
        return self._fire(
            "nan_loss", bundle=True, step=step, epoch=epoch, value=str(value)
        )

    def check_grad_norm(self, value: float, step: int,
                        epoch: int = -1) -> bool:
        import math

        if math.isfinite(value):
            return False
        return self._fire(
            "nan_grad_norm", bundle=True, step=step, epoch=epoch,
            value=str(value),
        )

    def observe_step(self, duration_s: float, step: int,
                     epoch: int = -1) -> bool:
        """Feed one step duration; True when a regression event fired."""
        fired = False
        if len(self._recent) >= self.regression_min_steps:
            xs = sorted(self._recent)
            median = xs[len(xs) // 2]
            if median > 0 and duration_s > median * self.regression_factor:
                fired = self._fire(
                    "step_regression", bundle=False, step=step, epoch=epoch,
                    duration_s=round(duration_s, 6),
                    median_s=round(median, 6),
                    factor=round(duration_s / median, 2),
                )
        self._recent.append(duration_s)
        return fired


# -- trace capture across a gang ---------------------------------------------

def capture_local_trace(seconds: float, out_dir: Optional[str] = None,
                        ) -> Dict[str, Any]:
    """Profile THIS process with ``torch.profiler`` for ``seconds``
    (blocking the calling thread; the profiler records every thread's
    host ops and, with a CUDA context, the card's kernels), flush the
    span ring into the same directory, and return ``{"dir",
    "wall_start", "wall_stop"}``."""
    from raydp_tpu_torch.telemetry.export import flush_spans
    from raydp_tpu_torch.utils.profiling import trace

    out_dir = out_dir or tempfile.mkdtemp(prefix="raydp-profile-")
    os.makedirs(out_dir, exist_ok=True)
    wall_start = time.time()
    with trace(out_dir):
        time.sleep(max(0.0, float(seconds)))
    wall_stop = time.time()
    try:
        flush_spans(out_dir)
    except Exception:
        pass
    return {"dir": out_dir, "wall_start": wall_start,
            "wall_stop": wall_stop}


# Seconds an ETL worker's capture may take beyond the capture itself: the
# first one imports torch and its profiler into a torch-free worker, which
# took 24-31 s on the card's machine with four workers importing at once
# (the JAX package allows 30 s).
WORKER_CAPTURE_SLACK_S = 120.0


def capture_trace_archive(seconds: float, rank: Any = None,
                          ) -> Dict[str, Any]:
    """The ``ProfileRequest`` handler's body: capture locally, zip the
    directory, return ``{"zip": bytes, "wall_start", "wall_stop",
    "rank", "pid"}``; the local directory is removed."""
    import shutil

    info = capture_local_trace(seconds)
    out_dir = info["dir"]
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, _dirs, files in os.walk(out_dir):
            for name in files:
                path = os.path.join(root, name)
                zf.write(path, os.path.relpath(path, out_dir))
    shutil.rmtree(out_dir, ignore_errors=True)
    return {
        "zip": buf.getvalue(),
        "wall_start": info["wall_start"],
        "wall_stop": info["wall_stop"],
        "rank": rank,
        "pid": os.getpid(),
    }


def unpack_trace_archive(payload: Dict[str, Any], dest: str) -> str:
    """Unpack one rank's archive into ``dest`` and return it."""
    os.makedirs(dest, exist_ok=True)
    with zipfile.ZipFile(io.BytesIO(payload["zip"])) as zf:
        zf.extractall(dest)
    return dest


def _load_torch_chrome_events(rank_dir: str) -> List[Dict[str, Any]]:
    """traceEvents of the ``torch.profiler`` Chrome traces
    (``trace-<pid>.json``) under one rank's unpacked directory."""
    events: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(rank_dir, "trace-*.json"))):
        try:
            with open(path, encoding="utf-8") as f:
                data = json.load(f)
        except Exception:
            continue
        events.extend(data.get("traceEvents", []) or [])
    return events


def _pid_number(pid: Any) -> int:
    """An event's pid as a number (the profiler names some tracks with
    strings)."""
    try:
        return int(pid)
    except (TypeError, ValueError):
        return sum(ord(c) for c in str(pid))


def merge_rank_traces(
    payloads: List[Dict[str, Any]], out_dir: Optional[str] = None,
) -> Dict[str, Any]:
    """Merge per-rank capture payloads into one Perfetto-loadable file.

    Each payload (:func:`capture_trace_archive`) is unpacked under
    ``out_dir/rank-<n>/`` (a temporary directory by default; kept, with
    the rank's raw trace). The merged
    Chrome trace holds, per rank, the profiler's events (host ops, CUDA
    kernels and copies) shifted so the rank's first event lands at its
    recorded capture start, and the span shards captured in the window,
    aligned as ``chrome_trace.py`` aligns them. Rank pids are remapped
    into disjoint ranges and process names prefixed ``rank N:``. Returns
    ``{"merged_trace", "out_dir", "ranks"}``.
    """
    from raydp_tpu_torch.telemetry.chrome_trace import (
        aligned_interval, clock_offsets, load_span_records, to_chrome_trace,
    )

    out_dir = out_dir or tempfile.mkdtemp(prefix="raydp-merged-profile-")
    os.makedirs(out_dir, exist_ok=True)
    merged: List[Dict[str, Any]] = []
    base_wall = min(
        (p["wall_start"] for p in payloads if p.get("wall_start")),
        default=time.time(),
    )
    ranks: List[Any] = []
    for idx, payload in enumerate(payloads):
        rank = payload.get("rank")
        rank = idx if rank is None else rank
        ranks.append(rank)
        rank_dir = os.path.join(out_dir, f"rank-{rank}")
        unpack_trace_archive(payload, rank_dir)
        pid_base = (idx + 1) * 100000

        events = _load_torch_chrome_events(rank_dir)
        first_ts = min(
            (float(e["ts"]) for e in events if "ts" in e), default=None
        )
        shift = (
            (payload.get("wall_start", base_wall) - base_wall) * 1e6
            - (first_ts or 0.0)
        )
        named = set()
        for ev in events:
            ev = dict(ev)
            pid = pid_base + _pid_number(ev.get("pid", 0)) % 50000
            ev["pid"] = pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                args = dict(ev.get("args") or {})
                args["name"] = f"rank {rank}: {args.get('name', '?')}"
                ev["args"] = args
                named.add(pid)
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + shift
            merged.append(ev)
        for pid in sorted({e["pid"] for e in merged
                           if pid_base <= e["pid"] < pid_base + 50000}
                          - named):
            merged.append({"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": f"rank {rank}: profiler"}})

        records = load_span_records(rank_dir)
        if records:
            offsets = clock_offsets(records)
            rank_base = min(
                aligned_interval(r, offsets)[0] for r in records
            )
            span_doc = to_chrome_trace(records)
            for ev in span_doc.get("traceEvents", []):
                ev = dict(ev)
                ev["pid"] = (pid_base + 50000
                             + _pid_number(ev.get("pid", 0)) % 50000)
                if ev.get("ph") == "M" and ev.get("name") == "process_name":
                    args = dict(ev.get("args") or {})
                    args["name"] = (f"rank {rank} spans: "
                                    f"{args.get('name', '?')}")
                    ev["args"] = args
                elif "ts" in ev:
                    # µs since the rank's earliest span, whose wall time
                    # compares across ranks: re-based onto the window.
                    ev["ts"] = float(ev["ts"]) + (
                        rank_base - base_wall
                    ) * 1e6
                merged.append(ev)

    out_path = os.path.join(out_dir, "merged_trace.json")
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"displayTimeUnit": "ns", "traceEvents": merged}, f)
    os.replace(tmp, out_path)
    return {"merged_trace": out_path, "out_dir": out_dir, "ranks": ranks}
