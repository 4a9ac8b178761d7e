"""raydpcheck over the port: framework-aware static analysis for
``raydp_tpu_torch``.

The port's own copy of the JAX package's checker (``raydp_tpu.analysis``;
the port imports nothing of that package). An AST-based rule engine
tuned to the concurrency and telemetry idioms of this codebase — not a
general linter. Each rule is grounded in a bug class the code base has
already shipped and fixed by hand:

* **R1 lock-discipline** — lock-order inversions and locks held across
  blocking calls (RPC send/recv, ``queue.get``, ``time.sleep``,
  ``subprocess``, ``future.result()``), built from a per-module
  lock-acquisition graph (the ``SPMDJob._rank_health`` class of race).
* **R2 signal-safety** — the call graph reachable from registered
  signal handlers must not acquire locks, log, or do unbounded
  allocation (the flight recorder's SIGTERM-deadlock class).
* **R3 RPC-handler discipline** — handlers wired into :class:`RpcServer`
  that (transitively) block must either be registered in the
  long-stall set (``_LONG_HANDLER_METHODS``) or bracket the blocking
  region with their own ``inflight()`` override.
* **R4 telemetry consistency** — metric names must route to a
  registered Prometheus family in ``telemetry/export.py`` or be
  documented; every family and every ``RAYDP_TPU_*`` env var read in
  code must appear in the port's docs (``raydp_tpu_torch/doc/`` and the
  README's section on the port).
* **R5 device hazards** — host syncs inside a captured CUDA graph step
  and inside training step and decode loops.
* **R6 clock-seam discipline** — the modules the simulator runs read
  time only through ``raydp_tpu_torch/utils/clock.py``.

Run it as ``python -m raydp_tpu_torch.analysis [paths]``. Findings can be
suppressed inline with ``# raydp: ignore[R1]`` (rule id or rule name)
on the offending line or the line above, or accepted wholesale into a
ratcheting baseline file (``--write-baseline``) so pre-existing debt
never regresses while new code ships clean. See
``raydp_tpu_torch/doc/analysis.md``.
"""
from raydp_tpu_torch.analysis.core import (  # noqa: F401
    AnalysisResult,
    Finding,
    run_analysis,
)

__all__ = ["Finding", "AnalysisResult", "run_analysis"]
