"""The shared-memory object store: named /dev/shm segments, the holder
ownership, the AppMaster's directory and the per-node agents."""
from raydp_tpu_torch.store.object_store import (
    OWNER_HOLDER,
    ObjectRef,
    ObjectStore,
)

__all__ = ["ObjectStore", "ObjectRef", "OWNER_HOLDER"]
