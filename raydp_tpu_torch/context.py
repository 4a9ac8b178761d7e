"""Framework lifecycle: ``init()`` / ``stop()`` (the port's copy of
``raydp_tpu/context.py``).

Semantics parity with the reference's context management
(reference: python/raydp/context.py:150-217): process-wide singleton guarded
by an RLock, re-init raises unless the previous session was stopped, atexit
teardown, and ``stop(del_obj_holder=False)`` keeps converted data alive in
the object store after the ETL workers are torn down (ownership transfer —
the holder outlives the cluster).

``init`` starts processes and the object store and does no device work,
so it takes no ``device=``; the fits keep theirs. Its arguments default
to ``None`` and resolve as explicit argument > ``RAYDP_TPU_*``
environment (the submit CLI's handoff, ``cli/submit.py``) > built-in
default; ``RAYDP_TPU_CONF_<key>`` entries merge under ``configs=``.
``connect`` attaches this process to another process's session as a
second driver (client mode); its ``stop()`` only disconnects.
"""
from __future__ import annotations

import atexit
import os
import threading
from typing import Any, Dict, Optional

from raydp_tpu_torch.config import ClusterConfig


def _env_default(name: str, explicit, default):
    """Explicit argument > RAYDP_TPU_* environment (the submit CLI's
    handoff, cli/submit.py; reference: bin/raydp-submit conf plumbing) >
    built-in default."""
    if explicit is not None:
        return explicit
    val = os.environ.get(name)
    return val if val is not None else default


def _env_confs() -> Dict[str, str]:
    prefix = "RAYDP_TPU_CONF_"
    return {
        k[len(prefix):]: v
        for k, v in os.environ.items()
        if k.startswith(prefix)
    }


_lock = threading.RLock()
_session: Optional["Session"] = None
# Sessions whose workers are stopped but whose holder still owns objects
# (stop(del_obj_holder=False) followed by a new init()). Kept reachable so
# atexit can release their holders — orphaning them would leak /dev/shm
# segments past process exit.
_lingering: list = []


class Session:
    """A live ETL-worker cluster + object store."""

    def __init__(self, cfg: ClusterConfig):
        from raydp_tpu_torch.cluster.cluster import Cluster

        self.config = cfg
        self.cluster = Cluster(cfg)
        self.cluster.start()
        self._workers_stopped = False
        self._holder_released = False

    @property
    def stopped(self) -> bool:
        """Workers down — the session no longer blocks a new init()."""
        return self._workers_stopped

    def stop(self, del_obj_holder: bool = True, fast: bool = False) -> None:
        """Idempotent, two-phase: workers stop once; the object holder can
        be released later by a second ``stop(del_obj_holder=True)`` after a
        ``stop(del_obj_holder=False)`` (else holder segments would leak)."""
        if not self._workers_stopped:
            self.cluster.shutdown(del_obj_holder=del_obj_holder, fast=fast)
            self._workers_stopped = True
            self._holder_released = del_obj_holder
        elif del_obj_holder and not self._holder_released:
            self.cluster.release_holder()
            self._holder_released = True


def init(
    app_name: Optional[str] = None,
    num_workers: Optional[int] = None,
    cores_per_worker: Optional[int] = None,
    memory_per_worker: "int | str | None" = None,
    placement_strategy: Optional[str] = None,
    placement_group: Optional[Any] = None,
    placement_bundle_indexes: Optional[list] = None,
    enable_native: bool = True,
    max_worker_restarts: int = 3,
    num_virtual_nodes: int = 0,
    bind_host: str = "127.0.0.1",
    advertise_host: Optional[str] = None,
    master_port: int = 0,
    launcher: Optional[Any] = None,
    configs: Optional[Dict[str, Any]] = None,
) -> Session:
    """Start the distributed ETL session (singleton): the AppMaster, the
    object store and ``num_workers`` worker processes.

    Raises if a live session already exists (same re-init guard as the
    reference: python/raydp/context.py:176-184).
    """
    global _session
    with _lock:
        if _session is not None and not _session.stopped:
            raise RuntimeError(
                "a raydp_tpu_torch session is already running; call "
                "raydp_tpu_torch.stop() first"
            )
        if _session is not None and not _session._holder_released:
            _lingering.append(_session)
        merged_confs = _env_confs()
        merged_confs.update(configs or {})
        cfg = ClusterConfig.from_args(
            app_name=_env_default("RAYDP_TPU_APP_NAME", app_name, "raydp-tpu"),
            num_workers=int(
                _env_default("RAYDP_TPU_NUM_WORKERS", num_workers, 2)
            ),
            cores_per_worker=int(
                _env_default(
                    "RAYDP_TPU_CORES_PER_WORKER", cores_per_worker, 1
                )
            ),
            memory_per_worker=_env_default(
                "RAYDP_TPU_MEMORY_PER_WORKER", memory_per_worker, "1GB"
            ),
            placement_strategy=_env_default(
                "RAYDP_TPU_PLACEMENT_STRATEGY", placement_strategy, None
            ),
            placement_group=placement_group,
            placement_bundle_indexes=placement_bundle_indexes,
            enable_native=enable_native,
            max_worker_restarts=max_worker_restarts,
            num_virtual_nodes=num_virtual_nodes,
            bind_host=bind_host,
            advertise_host=advertise_host,
            master_port=master_port,
            launcher=launcher,
            configs=merged_confs,
        )
        _session = Session(cfg)
        return _session


def connect(master_address: str):
    """Attach THIS process as a remote driver to a live AppMaster
    (client mode — reference: every test runs under ``ray://`` too,
    conftest.py:42-49). The DataFrame/MLDataset/estimator surface works
    unchanged; ``stop()`` merely disconnects."""
    global _session
    with _lock:
        if _session is not None and not _session.stopped:
            raise RuntimeError(
                "a raydp_tpu_torch session is already active in this "
                "process; call raydp_tpu_torch.stop() first"
            )
        from raydp_tpu_torch.cluster.client import ClientSession

        session = ClientSession(master_address)
        _session = session
        return session


def stop(del_obj_holder: bool = True) -> None:
    """Stop the session. With ``del_obj_holder=False`` the object-store
    holder keeps owned objects alive for later reads."""
    global _session
    with _lock:
        if _session is not None:
            _session.stop(del_obj_holder=del_obj_holder)
            if del_obj_holder:
                _session = None
        # del_obj_holder=False keeps _session so a later stop() can still
        # reach the holder and release its objects.


def current_session() -> Optional[Session]:
    with _lock:
        return _session if (_session and not _session.stopped) else None


def require_session() -> Session:
    s = current_session()
    if s is None:
        raise RuntimeError(
            "no live session; call raydp_tpu_torch.init() first")
    return s


@atexit.register
def _atexit_stop() -> None:
    # Fast path: CPython has already shut worker thread pools down before
    # atexit runs, so graceful stop RPCs would race executor teardown.
    with _lock:
        doomed = ([_session] if _session is not None else []) + _lingering
    for session in doomed:
        try:
            session.stop(del_obj_holder=True, fast=True)
        except Exception:
            pass
    _lingering.clear()
