"""The port's progress plane (``raydp_tpu_torch/telemetry/progress.py``)
beyond ``tests/test_query_profiling.py``'s cases: the opt-in progress
logger the JAX package arms with ``RAYDP_TPU_PROGRESS_LOG=<seconds>``
(``raydp_tpu/telemetry/progress.py:294-322``), and the pruning of
``stats-<pid>.jsonl`` shards on a process's first write
(``:215-224``), each held to the reference's behaviour."""
import json
import logging
import os
import time

from raydp_tpu_torch.telemetry import progress as port_progress


def test_progress_logger_logs_active_stages(monkeypatch, caplog):
    monkeypatch.setenv(port_progress.PROGRESS_LOG_ENV, "0.2")
    caplog.set_level(logging.INFO, logger=port_progress.__name__)
    tracker = port_progress.ProgressTracker()
    tracker.stage_begin(7, "exchange[k]", 4)
    tracker.task_done(7, 3)
    deadline = time.monotonic() + 10
    lines = []
    while time.monotonic() < deadline and not lines:
        time.sleep(0.1)
        lines = [r.getMessage() for r in caplog.records
                 if r.getMessage().startswith("progress: stage")]
    tracker.stage_end(7)
    assert "progress: stage 7 exchange[k] 3/4 tasks" in lines
    # Armed once a tracker: a second stage starts no second thread.
    tracker.stage_begin(8, "map", 1)
    assert tracker._logger_armed
    tracker.stage_end(8)


def test_progress_logger_is_opt_in(monkeypatch):
    monkeypatch.delenv(port_progress.PROGRESS_LOG_ENV, raising=False)
    tracker = port_progress.ProgressTracker()
    tracker.stage_begin(1, "map", 2)
    tracker.stage_end(1)
    assert not tracker._logger_armed


def test_stats_shards_are_capped(tmp_path, monkeypatch):
    """A store's first write prunes the directory's ``stats-*.jsonl`` to
    the newest ``RAYDP_TPU_SHARD_KEEP`` before it opens its own shard,
    as the reference does: the cap holds for every earlier process."""
    monkeypatch.setenv(port_progress.STATS_DIR_ENV, str(tmp_path))
    monkeypatch.setenv("RAYDP_TPU_SHARD_KEEP", "2")
    now = time.time()
    for i, pid in enumerate((11, 12, 13, 14)):
        path = tmp_path / f"stats-{pid}.jsonl"
        path.write_text("{}\n")
        os.utime(path, (now - 100 + i, now - 100 + i))
    store = port_progress.StageStatsStore()
    store.record(port_progress.StageStats(stage_id=store.next_id(),
                                          op="map", executor="local",
                                          rows_out=3))
    left = sorted(p.name for p in tmp_path.glob("stats-*.jsonl"))
    own = f"stats-{os.getpid()}.jsonl"
    assert left == sorted(["stats-13.jsonl", "stats-14.jsonl", own]), left
    with open(tmp_path / own) as f:
        assert json.loads(f.readline())["rows_out"] == 3
