"""Load observatory: trace-replay load generation, capacity-knee
finding, and per-request latency provenance rendering.

The port's counterpart of ``raydp_tpu/loadgen/``. The serving plane's
policies (continuous batching, shed/429, drain, autoscaling) under an
open-loop offered load, measured. Three layers:

- :mod:`~raydp_tpu_torch.loadgen.schedules` +
  :mod:`~raydp_tpu_torch.loadgen.trace` — arrival-schedule generators
  (Poisson, heavy-tail, diurnal, flash crowd), a JSONL trace format,
  and a recorder that captures a live
  :class:`~raydp_tpu_torch.serve.batching.RequestQueue`'s real arrivals
  for later replay.
- :mod:`~raydp_tpu_torch.loadgen.runner` — the open-loop runner: a timer
  wheel fires requests at their scheduled offsets regardless of how
  the backend is doing (late replies never throttle offered load),
  recording per-request outcome, latency, and phase provenance.
- :mod:`~raydp_tpu_torch.loadgen.knee` — a stepped-ramp controller that
  sweeps offered RPS until the SLO breaches for two consecutive
  steps, then bisects to the capacity knee.

``python -m raydp_tpu_torch.loadgen report results.jsonl`` renders the knee
curve and phase breakdown offline from a saved results file.
"""
from raydp_tpu_torch.loadgen.knee import (
    KneeConfig,
    KneePoint,
    KneeResult,
    find_knee,
    write_results,
)
from raydp_tpu_torch.loadgen.runner import (
    GroupTarget,
    HttpTarget,
    LoadResult,
    QueueTarget,
    RequestOutcome,
    run_schedule,
)
from raydp_tpu_torch.loadgen.schedules import (
    TraceEvent,
    diurnal_schedule,
    flash_crowd_schedule,
    heavy_tail_schedule,
    poisson_schedule,
)
from raydp_tpu_torch.loadgen.trace import (
    TraceRecorder,
    read_trace,
    write_trace,
)

__all__ = [
    "TraceEvent",
    "poisson_schedule",
    "heavy_tail_schedule",
    "diurnal_schedule",
    "flash_crowd_schedule",
    "TraceRecorder",
    "read_trace",
    "write_trace",
    "RequestOutcome",
    "LoadResult",
    "GroupTarget",
    "QueueTarget",
    "HttpTarget",
    "run_schedule",
    "KneeConfig",
    "KneePoint",
    "KneeResult",
    "find_knee",
    "write_results",
]
