"""Host-local object store with ownership transfer (the port's copy of
``raydp_tpu/store/object_store.py``).

Replaces the reference's (Ray object store + ObjectRefHolder + named
"raydp_obj_holder" actor) triangle
(reference: core/.../ObjectStoreWriter.scala:58-79,189-228;
python/raydp/spark/dataset.py:482-504) with one component: an object
directory over shared-memory segments.

Lifecycle model:
  * every object has an **owner**: either a worker id (dies with the
    worker) or the distinguished holder ``OWNER_HOLDER`` (survives until
    the session is torn down with ``del_obj_holder=True``);
  * ``transfer_to_holder`` is the ownership-transfer primitive the
    reference implements via owner-aware ``Ray.put``;
  * when an owner dies, its objects are unlinked; holder-owned objects are
    not.

The directory itself lives in the AppMaster process, which serves it
over the RPC layer; this module is the in-process core, fully usable standalone for
single-process pipelines and tests.
"""
from __future__ import annotations

import os
import secrets
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

import pyarrow as pa

from raydp_tpu_torch.store import shm

OWNER_HOLDER = "__holder__"
DEFAULT_NODE = "node-0"

# Process-wide "ambient" store/resolver: set by worker processes at
# registration so shipped stage closures can resolve ObjectRefs (e.g.
# broadcast tables) without threading a context handle through every
# callable. The resolver (when set) additionally reaches objects on OTHER
# nodes via their store agents.
_current_store: "ObjectStore | None" = None
_current_resolver = None


def set_current_store(store: "ObjectStore") -> None:
    global _current_store
    _current_store = store


def get_current_store() -> "ObjectStore | None":
    return _current_store


def set_current_resolver(resolver) -> None:
    global _current_resolver
    _current_resolver = resolver


def get_current_resolver():
    return _current_resolver


# Small per-process cache for repeatedly-resolved shared tables (e.g. the
# broadcast side of a join is read by EVERY partition task on this
# worker; without the cache a remote worker re-fetches it over RPC once
# per partition). Tables are immutable; bounded FIFO eviction.
_AMBIENT_CACHE_MAX = 8
_ambient_cache: "dict[str, pa.Table]" = {}


def resolve_ambient_table(ref, cache: bool = True) -> pa.Table:
    """Read an Arrow table by ref using whatever this process has: the
    node-aware resolver if one is installed, else the plain local store.
    ``cache=True`` memoizes per object id (for broadcast-style reads)."""
    object_id = ref.object_id if isinstance(ref, ObjectRef) else ref
    if cache and object_id in _ambient_cache:
        return _ambient_cache[object_id]
    if _current_resolver is not None:
        table = _current_resolver.get_arrow_table(ref)
    elif _current_store is not None:
        table = _current_store.get_arrow_table(ref)
    else:
        raise RuntimeError("no ambient object store/resolver in this process")
    if cache:
        while len(_ambient_cache) >= _AMBIENT_CACHE_MAX:
            _ambient_cache.pop(next(iter(_ambient_cache)))
        _ambient_cache[object_id] = table
    return table


@dataclass(frozen=True)
class ObjectRef:
    """Handle to an immutable object in the store.

    ``node_id`` is the object's physical location — the basis of
    locality-aware scheduling and cross-host fetch (the reference threads
    the owner address through every ref for the same purpose,
    reference: ObjectStoreWriter.scala:49-53 RecordBatch.ownerAddress,
    rdd/RayDatasetRDD.scala:53-55 getPreferredLocations).
    """

    object_id: str  # 16-byte hex
    size: int
    owner: str
    num_rows: int = -1  # >=0 when the object is an Arrow IPC table
    node_id: str = DEFAULT_NODE

    def __repr__(self):
        return (
            f"ObjectRef({self.object_id[:8]}…, {self.size}B, "
            f"owner={self.owner}, node={self.node_id})"
        )


class ObjectStore:
    """Directory + shm segments under one namespace, scoped to one node.

    ``namespace`` isolates sessions; ``node_id`` isolates hosts: segment
    names are ``rdp-<namespace>-<node_id>-<object_id>``. On a real
    multi-host deployment each host's /dev/shm is physically separate; the
    node prefix makes single-machine tests behave the same way (a process
    configured for node A cannot open node B's segments), forcing the
    cross-host fetch path through the store agents.
    """

    def __init__(self, namespace: Optional[str] = None, node_id: str = DEFAULT_NODE):
        self.namespace = namespace or secrets.token_hex(4)
        self.node_id = node_id
        self._prefix = f"rdp-{self.namespace}-{node_id}-"
        self._lock = threading.RLock()
        self._objects: Dict[str, ObjectRef] = {}

    # -- write path -----------------------------------------------------
    def put(self, data, owner: str = OWNER_HOLDER, num_rows: int = -1) -> ObjectRef:
        """Copy ``data`` (bytes-like) into a new shm segment."""
        view = memoryview(data)
        try:
            flat = view.cast("B")
        except TypeError:
            flat = memoryview(bytes(view))
        object_id = secrets.token_hex(16)
        seg = shm.create(self._segment_name(object_id), flat.nbytes)
        try:
            if flat.nbytes:
                seg.buf[: flat.nbytes] = flat
        finally:
            seg.close()
        ref = ObjectRef(object_id, view.nbytes, owner, num_rows, self.node_id)
        with self._lock:
            self._objects[object_id] = ref
        return ref

    def put_arrow_table(self, table: pa.Table, owner: str = OWNER_HOLDER) -> ObjectRef:
        """Serialize an Arrow table as an IPC stream into the store."""
        sink = pa.BufferOutputStream()
        with pa.ipc.new_stream(sink, table.schema) as writer:
            writer.write_table(table)
        buf = sink.getvalue()
        return self.put(buf, owner=owner, num_rows=table.num_rows)

    # -- read path ------------------------------------------------------
    def get_buffer(self, ref_or_id) -> pa.Buffer:
        """Zero-copy view of the object (pa.Buffer over the mmap).

        pa.py_buffer holds the memoryview, the memoryview holds the mmap:
        the mapping stays valid for the buffer's lifetime, even if the
        segment name is unlinked meanwhile.
        """
        object_id = self._object_id(ref_or_id)
        seg = shm.open_segment(self._segment_name(object_id))
        return pa.py_buffer(seg.buf)

    def get_bytes(self, ref_or_id) -> bytes:
        return self.get_buffer(ref_or_id).to_pybytes()

    def get_arrow_table(self, ref_or_id) -> pa.Table:
        """Read an Arrow IPC stream object zero-copy (columns reference the
        shared-memory pages directly)."""
        buf = self.get_buffer(ref_or_id)
        reader = pa.ipc.open_stream(buf)
        return reader.read_all()

    def contains(self, ref_or_id) -> bool:
        return shm.exists(self._segment_name(self._object_id(ref_or_id)))

    # -- directory ------------------------------------------------------
    def register_ref(self, ref: ObjectRef) -> None:
        """Adopt an externally created object (e.g. written by a worker
        process) into this directory under its declared owner."""
        self._set_owner(ref, ref.owner)

    def get_ref(self, object_id: str) -> Optional[ObjectRef]:
        with self._lock:
            return self._objects.get(object_id)

    # -- lifecycle ------------------------------------------------------
    def transfer_to_holder(self, ref: ObjectRef) -> ObjectRef:
        """Re-own the object so it survives its creating worker."""
        return self._set_owner(ref, OWNER_HOLDER)

    def _set_owner(self, ref: ObjectRef, owner: str) -> ObjectRef:
        with self._lock:
            new_ref = ObjectRef(
                ref.object_id, ref.size, owner, ref.num_rows, ref.node_id
            )
            # Adopts the entry even if the object was created by another
            # process in this namespace.
            self._objects[ref.object_id] = new_ref
            return new_ref

    def delete(self, ref_or_id) -> bool:
        object_id = self._object_id(ref_or_id)
        with self._lock:
            self._objects.pop(object_id, None)
        return shm.unlink(self._segment_name(object_id))

    def on_owner_died(self, owner: str) -> List[str]:
        """Unlink all objects owned by ``owner`` (holder objects survive).

        This is the worker-death path: the reference relies on Ray ref
        counting + OwnerDiedError semantics
        (reference test: python/raydp/tests/test_data_owner_transfer.py:34-78).
        """
        with self._lock:
            doomed = [
                oid for oid, r in self._objects.items() if r.owner == owner
            ]
        for oid in doomed:
            self.delete(oid)
        return doomed

    def destroy(self) -> None:
        """Unlink every segment in this namespace (session teardown)."""
        with self._lock:
            self._objects.clear()
        for name in shm.list_segments(self._prefix):
            shm.unlink(name)

    def refs(self) -> List[ObjectRef]:
        with self._lock:
            return list(self._objects.values())

    def occupancy_bytes(self) -> int:
        """Bytes of shm this directory currently accounts for (sum of
        registered object sizes — the store's view, not a /dev/shm
        scan, so it is cheap enough for heartbeat-rate sampling)."""
        with self._lock:
            return sum(r.size for r in self._objects.values())

    # -- helpers --------------------------------------------------------
    def _segment_name(self, object_id: str) -> str:
        return f"{self._prefix}{object_id}"

    @staticmethod
    def _object_id(ref_or_id) -> str:
        return ref_or_id.object_id if isinstance(ref_or_id, ObjectRef) else ref_or_id
