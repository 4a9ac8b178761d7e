"""Entry point for one serving replica: ``python -m raydp_tpu_torch.serve.replica_main``.

The counterpart of ``raydp_tpu/serve/replica_main.py``. A replica is a
supervised child of the driver's
:class:`~raydp_tpu_torch.serve.group.ReplicaGroup`: it resolves its
device (``RAYDP_SERVE_DEVICE``; a replica asked for ``cuda`` on a machine
without a card raises here and never registers, so it never serves on
the CPU; a model function or engine factory that takes a ``device``
keyword is given this one), registers back with the driver (the
registration *reply* carries the pickled model function, so no model
bytes touch disk), then sits behind an RPC server executing
``ExecuteBatch`` envelopes, or in decode mode admitting sequences
(``AdmitSequences``) into a
:class:`~raydp_tpu_torch.serve.decode.DecodeLoop` whose round loop
pushes one ``DecodeEvents`` RPC to the driver per round.

SIGTERM routes through the drain path
(:func:`raydp_tpu_torch.fault.install_sigterm_drain`): the in-flight
batch finishes and its replies flow back to the driver, new batches are
refused with ``{"draining": True}`` (the driver requeues them on a
surviving replica), and the process exits cleanly once idle.
"""
from __future__ import annotations

import functools
import inspect
import logging
import os
import pickle
import sys
import threading
import time
from typing import Any, Callable, List

from raydp_tpu_torch import fault as _fault
from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer
from raydp_tpu_torch.serve.decode import DecodeLoop, ToyDecodeEngine
from raydp_tpu_torch.telemetry import events as _events
from raydp_tpu_torch.utils.device import resolve_device, set_exact_float32
from raydp_tpu_torch.utils.profiling import metrics

logger = logging.getLogger(__name__)

ENV_REPLICA = "RAYDP_SERVE_REPLICA"
ENV_INCARNATION = "RAYDP_SERVE_INCARNATION"
ENV_GROUP = "RAYDP_SERVE_GROUP"
ENV_MODE = "RAYDP_SERVE_MODE"
ENV_DEVICE = "RAYDP_SERVE_DEVICE"
ENV_SERVE_DRIVER_ADDR = "RAYDP_TPU_SERVE_DRIVER_ADDR"

SERVE_DRIVER_SERVICE = "raydp.ServeDriver"
REPLICA_SERVICE = "raydp.ServeReplica"

_HEARTBEAT_S = 2.0


def default_model(payloads: List[Any], bucket: int) -> List[Any]:
    """Fallback predictor when the group ships no model: pad each
    request's numeric sequence to the bucket length and return its sum."""
    out = []
    for p in payloads:
        try:
            seq = list(p)[:bucket]
        except TypeError:
            seq = [p]
        seq = seq + [0] * (bucket - len(seq))
        out.append(float(sum(seq)))
    return out


def on_device(fn: Callable, device) -> Callable:
    """``fn`` with its ``device`` keyword bound to ``device``, when it
    has one: a replica runs its model (or builds its decode engine) on
    the device the group resolved, whatever ``fn`` binds itself."""
    try:
        param = inspect.signature(fn).parameters.get("device")
    except (TypeError, ValueError):  # a callable without a signature
        return fn
    if param is None or param.kind in (param.POSITIONAL_ONLY,
                                       param.VAR_POSITIONAL):
        return fn
    return functools.partial(fn, device=device)


def _cuda_bytes() -> int:
    """Bytes this process holds on the card (0 before its first CUDA
    work, and on a machine without one)."""
    import torch

    return (torch.cuda.memory_allocated()
            if torch.cuda.is_initialized() else 0)


def _kernel_launches() -> dict:
    """The port's four flash kernel wrappers' launch counts in this
    process."""
    import importlib

    fa = importlib.import_module("raydp_tpu_torch.ops.flash_attention")
    return {"flash_fwd": fa.flash_attention.launches,
            "flash_bwd_delta": fa.flash_bwd_delta.launches,
            "flash_bwd_dq": fa.flash_bwd_dq.launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv.launches}


class ServeReplica:
    """RPC surface + drain discipline of one replica process."""

    def __init__(self, replica: int, incarnation: int, group: str,
                 driver_addr: str, mode: str = "batch",
                 device: str = "cuda"):
        self.replica = replica
        self.incarnation = incarnation
        self.group = group
        self.mode = mode
        # Resolved before registering: without the card asked for this
        # raises and the driver sees a replica that never came up.
        self.device = resolve_device(device)
        self.driver = RpcClient(driver_addr, SERVE_DRIVER_SERVICE)
        self.model: Callable[[List[Any], int], List[Any]] = default_model
        self._stop = threading.Event()
        # Monotonic count of requests this process has started: the
        # index serve_kill request= / latency nth= clauses match.
        self._request_seq = 0
        self._busy = 0
        self._mu = threading.Lock()
        self._decode_loop = None  # built after registration (decode mode)
        self._server = RpcServer(
            REPLICA_SERVICE,
            {
                "ExecuteBatch": self._on_execute_batch,
                "AdmitSequences": self._on_admit_sequences,
                "Ping": self._on_ping,
                "Stop": self._on_stop,
            },
        )

    # -- lifecycle ------------------------------------------------------

    def register(self) -> None:
        reply = self.driver.call(
            "RegisterReplica",
            {
                "replica": self.replica,
                "incarnation": self.incarnation,
                "addr": f"127.0.0.1:{self._server.port}",
                "pid": os.getpid(),
                "device": str(self.device),
            },
            timeout=10.0,
        )
        blob = reply.get("model")
        if blob is not None:
            self.model = on_device(pickle.loads(blob), self.device)
        if self.mode == "decode":
            # In decode mode the model blob is an *engine factory*
            # (zero-arg callable → prefill/step engine), built after
            # registering; until it is, AdmitSequences accepts nothing.
            # Float32 greedy streams are held token for token against a
            # reference forward, where TF32 products would flip near-ties.
            set_exact_float32()
            engine = self.model() if blob is not None else ToyDecodeEngine()
            self._decode_loop = DecodeLoop(
                engine, auto_requeue_evicted=False
            )

    def _on_ping(self, req: dict) -> dict:
        """Liveness, plus diagnostics: the device the model runs on,
        the bytes this process holds on the card, and its flash kernel
        launch counts."""
        out = {"pong": True, "replica": self.replica,
               "device": self.device.type, "cuda_bytes": _cuda_bytes(),
               "launches": _kernel_launches()}
        engine = getattr(self._decode_loop, "engine", None)
        if hasattr(engine, "graph_count"):
            out["graphs"] = engine.graph_count
        return out

    def _on_stop(self, req: dict) -> dict:
        self._stop.set()
        return {"ok": True}

    # -- execution ------------------------------------------------------

    def _on_execute_batch(self, req: dict) -> dict:
        """Run one assembled batch. Refused while draining so the
        driver retries it on a surviving replica; an in-flight batch
        always completes and replies before the drain exit."""
        if _fault.preemption_requested():
            return {"draining": True}
        with self._mu:
            self._busy += 1
            seqs = list(range(
                self._request_seq, self._request_seq + len(req["requests"])
            ))
            self._request_seq += len(req["requests"])
        try:
            # Fault hooks fire per request BEFORE the model runs: a
            # serve_kill clause kills this process mid-batch (its
            # requests are requeued driver-side), a latency clause
            # stalls the whole batch like a straggler step.
            for seq in seqs:
                _fault.on_serve_request(seq, replica=self.replica)
            payloads = [r["payload"] for r in req["requests"]]
            bucket = int(req.get("bucket") or max(
                (len(p) if hasattr(p, "__len__") else 1 for p in payloads),
                default=1,
            ))
            t0 = time.perf_counter()
            with metrics.timer("serve/replica_exec").time():
                results = self.model(payloads, bucket)
            exec_s = time.perf_counter() - t0
            metrics.counter_add("serve/replica_requests", len(payloads))
            return {
                "results": list(results),
                "exec_s": exec_s,
                "replica": self.replica,
            }
        finally:
            with self._mu:
                self._busy -= 1

    def _on_admit_sequences(self, req: dict) -> dict:
        """Decode-mode admission: each request claims a KV slot at the
        next round. Over-capacity requests are rejected (not queued) so
        the driver can route them to a sibling replica; refused outright
        while draining."""
        if self._decode_loop is None:
            if self.mode == "decode":
                # Registered, but the engine factory is still building:
                # admit nothing so the driver requeues and retries.
                return {"accepted": [], "replica": self.replica}
            return {"error": "replica is not in decode mode"}
        if _fault.preemption_requested():
            return {"draining": True}
        requests = req.get("requests") or []
        with self._mu:
            first = self._request_seq
            self._request_seq += len(requests)
        accepted: List[str] = []
        capacity = self._decode_loop.free_capacity()
        for offset, r in enumerate(requests):
            # Fault hooks fire per admission: a serve_kill clause kills
            # this process while earlier admissions are mid-decode;
            # their sequences requeue driver-side as prefills.
            _fault.on_serve_request(first + offset, replica=self.replica)
            if len(accepted) >= max(0, capacity):
                continue
            try:
                self._decode_loop.submit(
                    request_id=r["id"],
                    prompt=r["tokens"],
                    max_new=r.get("max_new"),
                    eos=r.get("eos"),
                    start_index=int(r.get("start_index") or 0),
                    deadline_s=r.get("deadline_s"),
                )
            except ValueError as exc:
                accepted.append(r["id"])  # claimed, but dies immediately
                self._decode_loop.cancel(r["id"])
                logger.warning(
                    "replica %d: rejecting sequence %s: %s",
                    self.replica, r["id"], exc,
                )
                continue
            accepted.append(r["id"])
        return {"accepted": accepted, "replica": self.replica}

    def _decode_rounds(self) -> None:
        """The decode round loop: one scheduler iteration, then one
        event RPC back to the driver (per round, not per token)."""
        loop = self._decode_loop
        linger = loop.config.round_linger_s
        while not self._stop.is_set():
            if _fault.preemption_requested():
                # Abandon in-flight sequences: the driver requeues them
                # as prefills on a surviving replica when this process
                # exits (recompute is the drain for decode).
                _fault.mark_drained()
                _events.emit("serve/drain", replica=self.replica,
                             group=self.group)
                self._stop.set()
                return
            try:
                stats = loop.run_round()
            except Exception:
                logger.exception(
                    "replica %d: decode round failed; exiting",
                    self.replica,
                )
                self._stop.set()
                return
            events = loop.drain_events()
            if events["tokens"] or events["done"]:
                self.driver.try_call(
                    "DecodeEvents",
                    {"replica": self.replica, **events},
                    timeout=5.0,
                )
            if stats["live"] == 0 and stats["pending"] == 0:
                time.sleep(linger)

    # -- background loops ----------------------------------------------

    def _heartbeat(self) -> None:
        """Orphan guard: a replica whose driver vanished exits instead of
        serving nobody forever."""
        misses = 0
        while not self._stop.wait(_HEARTBEAT_S):
            reply = self.driver.try_call(
                "Ping", {"replica": self.replica}, timeout=5.0
            )
            if reply is None:
                misses += 1
                if misses >= 2:
                    logger.warning(
                        "replica %d: driver unreachable; exiting",
                        self.replica,
                    )
                    self._stop.set()
                    return
            else:
                misses = 0

    def _drain_watch(self) -> None:
        """Once a preemption notice lands, wait for the in-flight batch
        to finish (its replies are already on the wire) and exit."""
        while not self._stop.is_set():
            if _fault.preemption_requested():
                while True:
                    with self._mu:
                        if self._busy == 0:
                            break
                    time.sleep(0.01)
                _fault.mark_drained()
                _events.emit("serve/drain", replica=self.replica,
                             group=self.group)
                print(
                    f"raydp-serve: replica {self.replica} drained; exiting",
                    file=sys.stderr, flush=True,
                )
                self._stop.set()
                return
            time.sleep(0.05)

    def run(self) -> None:
        self.register()
        threads = [
            threading.Thread(target=self._heartbeat, daemon=True),
        ]
        if self.mode == "decode":
            threads.append(
                threading.Thread(target=self._decode_rounds, daemon=True)
            )
        else:
            threads.append(
                threading.Thread(target=self._drain_watch, daemon=True)
            )
        for t in threads:
            t.start()
        self._stop.wait()
        self._server.stop(grace=0.5)


def main() -> None:
    logging.basicConfig(
        level=logging.INFO,
        format=f"[serve-replica-{os.environ.get(ENV_REPLICA, '?')}] "
               "%(asctime)s %(message)s",
    )
    _fault.install_sigterm_drain()
    replica = ServeReplica(
        replica=int(os.environ[ENV_REPLICA]),
        incarnation=int(os.environ.get(ENV_INCARNATION, "0")),
        group=os.environ.get(ENV_GROUP, "serve"),
        driver_addr=os.environ[ENV_SERVE_DRIVER_ADDR],
        mode=os.environ.get(ENV_MODE, "batch"),
        device=os.environ.get(ENV_DEVICE, "cuda"),
    )
    replica.run()


if __name__ == "__main__":
    main()
