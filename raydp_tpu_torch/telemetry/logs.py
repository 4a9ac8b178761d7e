"""Trace-correlated structured logs: stdlib logging → JSONL shards.

The port's copy of ``raydp_tpu/telemetry/logs.py``; it leaves nothing
of it to a later slice.

:func:`install` attaches a :class:`JsonLogHandler` to the root logger.
Every record is appended to ``<telemetry_dir>/logs-<pid>.jsonl`` (one
shard per process, same sharding rule as spans) as one JSON object
stamped with the ambient ``trace_id``/``span_id`` from
:mod:`~raydp_tpu_torch.telemetry.propagation` — a log line emitted inside an
open span (or inside an RPC handler running under a propagated
context) joins that span's trace, so ``grep trace_id`` crosses the
span/log divide and the analyzer can interleave both.

WARNING-and-above records are additionally mirrored into the flight
recorder ring, so postmortem bundles carry the last few warnings even
when no telemetry dir is configured.

No-op without ``RAYDP_TPU_TELEMETRY_DIR`` (flight mirroring excepted);
console handlers installed by the app are left untouched.
"""
from __future__ import annotations

import glob
import json
import logging
import os
import threading
from typing import Any, Dict, List, Optional

from raydp_tpu_torch.telemetry import propagation as _prop
from raydp_tpu_torch.telemetry.export import append_jsonl, telemetry_dir

__all__ = ["JsonLogHandler", "install", "uninstall", "read_records"]


class JsonLogHandler(logging.Handler):
    """Append log records to a JSONL shard, trace-stamped."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._formatter = logging.Formatter()

    def emit(self, record: logging.LogRecord) -> None:
        try:
            entry: Dict[str, Any] = {
                "ts": record.created,
                "level": record.levelname,
                "logger": record.name,
                "message": record.getMessage(),
                "pid": os.getpid(),
                "tid": record.thread,
                "file": f"{record.module}:{record.lineno}",
            }
            ctx = _prop.current_context()
            if ctx is not None:
                entry["trace_id"] = ctx.trace_id
                entry["span_id"] = ctx.span_id
            if record.exc_info and record.exc_info[0] is not None:
                entry["exc"] = self._formatter.formatException(
                    record.exc_info
                )
            append_jsonl(self.path, [entry])
            if record.levelno >= logging.WARNING:
                from raydp_tpu_torch.telemetry import flight_recorder as _flight

                _flight.record(
                    "log", record.levelname.lower(),
                    logger=record.name,
                    message=record.getMessage()[:200],
                )
        except Exception:
            self.handleError(record)


_mu = threading.Lock()
_handler: Optional[JsonLogHandler] = None
_prev_root_level: Optional[int] = None


def install(directory: Optional[str] = None,
            level: int = logging.INFO) -> Optional[JsonLogHandler]:
    """Attach the JSONL handler to the root logger. Idempotent; returns
    the handler, or None when no telemetry directory is configured.

    Handler levels filter *after* the logger's own level: in a process
    that never configured logging, the root logger's default WARNING
    would silently drop INFO records before they reach the handler. So
    the root level is lowered to ``level`` when it would filter more
    than the handler does (and restored on :func:`uninstall`). Console
    output is unaffected — the app's own handlers and logging's
    last-resort handler keep their own levels.
    """
    global _handler, _prev_root_level
    directory = directory or telemetry_dir()
    if not directory:
        return None
    with _mu:
        if _handler is not None:
            return _handler
        from raydp_tpu_torch.telemetry.export import prune_shards_once

        prune_shards_once(directory, "logs")
        path = os.path.join(directory, f"logs-{os.getpid()}.jsonl")
        handler = JsonLogHandler(path)
        handler.setLevel(level)
        root = logging.getLogger()
        root.addHandler(handler)
        if root.getEffectiveLevel() > level:
            _prev_root_level = root.level
            root.setLevel(level)
        _handler = handler
        return handler


def uninstall() -> None:
    global _handler, _prev_root_level
    with _mu:
        if _handler is not None:
            logging.getLogger().removeHandler(_handler)
            _handler = None
        if _prev_root_level is not None:
            logging.getLogger().setLevel(_prev_root_level)
            _prev_root_level = None


def read_records(directory: Optional[str] = None) -> List[Dict[str, Any]]:
    """Parse every ``logs-*.jsonl`` shard under ``directory`` (default:
    the configured telemetry dir), tolerant of torn final lines."""
    directory = directory or telemetry_dir()
    if not directory:
        return []
    records: List[Dict[str, Any]] = []
    for path in sorted(glob.glob(os.path.join(directory, "logs-*.jsonl"))):
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    records.sort(key=lambda r: r.get("ts", 0.0))
    return records
