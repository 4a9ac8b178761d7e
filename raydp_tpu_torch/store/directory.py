"""Cluster-wide object directory: node-aware lifecycle over per-node stores
(the port's copy of ``raydp_tpu/store/directory.py``).

Lives in the AppMaster. Extends the local ObjectStore (which doubles as the
driver node's storage) with knowledge of *where* every object lives and a
client to each node's store agent, so owner-death unlink, delete, and
session destroy reach segments on every host — the role Ray's distributed
ref counting plays for the reference (reference:
test_data_owner_transfer.py:34-78 OwnerDiedError semantics cluster-wide).
"""
from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from raydp_tpu_torch.store.object_store import DEFAULT_NODE, ObjectRef, ObjectStore

logger = logging.getLogger(__name__)


class DirectoryStore(ObjectStore):
    """The master's store: local node-0 storage + cluster directory."""

    def __init__(self, namespace: Optional[str] = None,
                 node_id: str = DEFAULT_NODE):
        super().__init__(namespace=namespace, node_id=node_id)
        self._agents: Dict[str, dict] = {}  # node_id -> {address, service}
        self._agent_clients: Dict[str, object] = {}
        self._agents_lock = threading.Lock()

    # -- agent registry -------------------------------------------------
    def register_agent(self, node_id: str, address: str, service: str) -> None:
        with self._agents_lock:
            stale = self._agents.get(node_id)
            if stale is not None and stale["address"] != address:
                old = self._agent_clients.pop(node_id, None)
                if old is not None:
                    old.close()
            self._agents[node_id] = {"address": address, "service": service}
        logger.info("store agent for %s @ %s", node_id, address)

    def agent_for(self, node_id: str) -> Optional[dict]:
        with self._agents_lock:
            return self._agents.get(node_id)

    def agents(self) -> Dict[str, dict]:
        with self._agents_lock:
            return dict(self._agents)

    def meta(self, object_id: str):
        """(ref, agent) for the resolver protocol."""
        ref = self.get_ref(object_id)
        agent = self.agent_for(ref.node_id) if ref is not None else None
        return ref, agent

    def _agent_client(self, node_id: str):
        from raydp_tpu_torch.cluster.rpc import RpcClient

        with self._agents_lock:
            client = self._agent_clients.get(node_id)
            if client is None:
                agent = self._agents.get(node_id)
                if agent is None:
                    return None
                client = RpcClient(agent["address"], agent["service"])
                self._agent_clients[node_id] = client
            return client

    # -- node-aware lifecycle -------------------------------------------
    def delete(self, ref_or_id) -> bool:
        object_id = self._object_id(ref_or_id)
        with self._lock:
            ref = self._objects.pop(object_id, None)
        if ref is None and isinstance(ref_or_id, ObjectRef):
            ref = ref_or_id
        node = ref.node_id if ref is not None else self.node_id
        if node == self.node_id:
            from raydp_tpu_torch.store import shm

            return shm.unlink(self._segment_name(object_id))
        client = self._agent_client(node)
        if client is None:
            logger.warning(
                "no agent for node %s; cannot unlink %s", node, object_id[:8]
            )
            return False
        reply = client.try_call("UnlinkObject", {"object_id": object_id},
                                timeout=10.0)
        return bool(reply and reply.get("deleted"))

    def destroy(self) -> None:
        """Session teardown: wipe every node's namespace."""
        for node_id in list(self.agents()):
            if node_id == self.node_id:
                continue  # local namespace is wiped below, not via RPC
            client = self._agent_client(node_id)
            if client is not None:
                client.try_call("DestroyStore", {}, timeout=10.0)
        super().destroy()
        with self._agents_lock:
            for client in self._agent_clients.values():
                client.close()
            self._agent_clients.clear()
