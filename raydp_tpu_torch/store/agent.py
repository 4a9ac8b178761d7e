"""Per-node store agent: serves this node's shm objects over the RPC layer
(the port's copy of ``raydp_tpu/store/agent.py``).

The multi-host data plane. Role parity with Ray's per-node raylet/plasma
pair that the reference builds on (reference: ObjectStoreWriter.scala:58-79
``Ray.put`` makes objects cluster-visible; executors on any node can fetch
them): one agent process per host, lifetime tied to the *session* (not to
any worker), so holder-owned objects written on this node survive worker
death and remain fetchable cluster-wide — the external-shuffle-service
property (reference C16, RayExternalShuffleService.scala:26-57).

The driver node needs no agent subprocess: the AppMaster embeds the same
handlers for its own node (master.py).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import threading
import time
import traceback
from typing import Callable, Dict, Optional

from raydp_tpu_torch.store.object_store import ObjectStore

logger = logging.getLogger(__name__)

AGENT_SERVICE = "raydp.StoreAgent"
REGISTER_RETRIES = 5


def agent_handlers(store: ObjectStore) -> Dict[str, Callable[[dict], dict]]:
    """The fetch/unlink surface a node exposes; shared by standalone agents
    and the AppMaster's embedded driver-node agent."""

    def fetch(req: dict) -> dict:
        object_id = req["object_id"]
        return {"data": store.get_bytes(object_id)}

    def fetch_chunk(req: dict) -> dict:
        # Chunked-streaming fetch: resolvers pull big objects as a series
        # of bounded slices instead of one monolithic reply (which rode
        # the 512MB RPC frame cap and held one copy of the whole
        # object in the reply pickle). The slice is cut zero-copy from
        # the mmap'd segment; only the reply serialization copies it.
        object_id = req["object_id"]
        offset = int(req.get("offset", 0))
        length = int(req.get("length", 0))
        buf = store.get_buffer(object_id)
        total = buf.size
        if length <= 0 or offset + length > total:
            length = max(0, total - offset)
        return {
            "data": buf.slice(offset, length).to_pybytes(),
            "size": total,
        }

    def unlink(req: dict) -> dict:
        return {"deleted": store.delete(req["object_id"])}

    def destroy(req: dict) -> dict:
        store.destroy()
        return {}

    return {
        "FetchObject": fetch,
        "FetchObjectChunk": fetch_chunk,
        "UnlinkObject": unlink,
        "DestroyStore": destroy,
    }


class StoreAgent:
    """Standalone agent process body (non-driver nodes)."""

    def __init__(self, namespace: Optional[str], node_id: str,
                 master_address: str, bind_host: str = "127.0.0.1"):
        from raydp_tpu_torch.cluster.rpc import RpcClient, RpcServer

        self.node_id = node_id
        self.master = RpcClient(master_address, "raydp.AppMaster")
        if namespace is None:
            # Remote pods don't know the session namespace up front —
            # learn it from the master (Ping carries it).
            namespace = self.master.call("Ping", {}, timeout=30.0)["namespace"]
        self.store = ObjectStore(namespace=namespace, node_id=node_id)
        self._stop_event = threading.Event()
        handlers = agent_handlers(self.store)
        handlers["Ping"] = lambda req: {"pong": True, "node_id": node_id}
        handlers["Stop"] = self._on_stop
        self._server = RpcServer(AGENT_SERVICE, handlers, host=bind_host)

    def _on_stop(self, req: dict) -> dict:
        self._stop_event.set()
        return {"stopping": True}

    def register(self) -> None:
        last_exc = None
        for attempt in range(REGISTER_RETRIES):
            try:
                self.master.call(
                    "RegisterAgent",
                    {
                        "node_id": self.node_id,
                        "address": self._server.address,
                        "service": AGENT_SERVICE,
                        "pid": os.getpid(),
                    },
                )
                return
            except Exception as exc:
                last_exc = exc
                time.sleep(0.5 * (attempt + 1))
        raise RuntimeError(
            f"store agent {self.node_id} failed to register: {last_exc}"
        )

    def run(self) -> None:
        self.register()
        missed = 0
        # The agent outlives workers but not the master: when the master is
        # gone for good, segments in this namespace are torn down by the
        # driver (or leaked-on-crash, same as the reference's plasma) and
        # the agent exits rather than orbit forever.
        master_lost = False
        while not self._stop_event.wait(2.0):
            reply = self.master.try_call("Ping", {}, timeout=5.0)
            if reply is None:
                missed += 1
                if missed >= 5:
                    logger.warning(
                        "agent %s: master unreachable; exiting", self.node_id
                    )
                    master_lost = True
                    break
            else:
                missed = 0
        if master_lost:
            # The session died without telling us: nobody will ever send
            # DestroyStore, so reclaim this host's segments before exit.
            self.store.destroy()
        self._server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--namespace", default=None)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--master", required=True)
    parser.add_argument("--bind-host", default="127.0.0.1")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format=f"[agent-{args.node_id}] %(levelname)s %(message)s",
    )
    agent = StoreAgent(args.namespace, args.node_id, args.master,
                       args.bind_host)
    try:
        agent.run()
    except Exception:
        traceback.print_exc()
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
