"""ETL ↔ ingest overlap accounting (driver side).

The port's copy of ``raydp_tpu/telemetry/overlap.py``; it leaves nothing
of it to a later slice.

The streaming pipelined executor exists to hide ETL tail latency behind
training ingest. Its evidence is this counter:

* ``pipeline/overlap_seconds`` — wall-clock during which at least one
  ETL stage task AND at least one ingest device transfer were in flight
  concurrently on the driver. Exported as the
  ``raydp_pipeline_overlap_seconds_total`` Prometheus family.

A strictly barriered run (``RAYDP_TPU_STREAMING=0``) reports 0 by
construction: ingest only starts after the last ETL partition lands.
Any positive value proves the first ``device_put`` shipped before ETL
finished.

Implementation: transition-based dual in-flight counts. Each begin/end
call closes the previous accounting interval; the elapsed time is
credited to the counter iff BOTH counts were positive across it. The
tracker lock guards only the counters — the metrics-registry add runs
outside it (raydpcheck R1 lock discipline).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Optional

from raydp_tpu_torch.utils.profiling import metrics

OVERLAP_COUNTER = "pipeline/overlap_seconds"


class OverlapTracker:
    """Counts concurrent ETL-task / ingest-transfer in-flight seconds."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._etl = 0
        self._ingest = 0
        self._since: Optional[float] = None

    def _shift(self, d_etl: int, d_ingest: int) -> None:
        now = time.perf_counter()
        credit = 0.0
        with self._mu:
            if self._since is not None:
                credit = now - self._since
                self._since = None
            self._etl = max(0, self._etl + d_etl)
            self._ingest = max(0, self._ingest + d_ingest)
            if self._etl > 0 and self._ingest > 0:
                self._since = now
        if credit > 0.0:
            metrics.counter_add(OVERLAP_COUNTER, credit)

    def etl_begin(self) -> None:
        self._shift(1, 0)

    def etl_end(self) -> None:
        self._shift(-1, 0)

    def ingest_begin(self) -> None:
        self._shift(0, 1)

    def ingest_end(self) -> None:
        self._shift(0, -1)

    @contextlib.contextmanager
    def ingest(self):
        """Bracket one ingest device transfer (a ``device_put``)."""
        self._shift(0, 1)
        try:
            yield
        finally:
            self._shift(0, -1)


#: Process-wide tracker: ETL stage tasks (scheduler) and ingest
#: transfers (loader / estimator) both run on the driver.
tracker = OverlapTracker()
