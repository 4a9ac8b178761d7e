"""POSIX shared-memory segments via /dev/shm files (the port's copy of
``raydp_tpu/store/shm.py``).

The data-plane substrate replacing the reference's Ray object store
(reference: core/.../ObjectStoreWriter.scala:58-79 ``Ray.put``): immutable
byte blobs shared zero-copy between the driver, ETL workers, and trainer
processes on one host. Segments are named files under /dev/shm, so they
survive the creating process — the property that makes ownership transfer
(holder outliving workers) work without copying.

Deliberately not ``multiprocessing.shared_memory``: its resource tracker
unlinks segments when *any* attaching process exits, which is exactly the
wrong lifecycle for owner-transferred objects.
"""
from __future__ import annotations

import mmap
import os
import stat
from dataclasses import dataclass

_SHM_DIR = "/dev/shm" if os.path.isdir("/dev/shm") else None


def shm_dir() -> str:
    if _SHM_DIR is not None:
        return _SHM_DIR
    # Fallback (non-Linux dev machines): plain tmp files — same semantics,
    # no page-cache guarantee.
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"), "raydp_tpu_torch_shm")
    os.makedirs(path, exist_ok=True)
    return path


def _path(name: str) -> str:
    if "/" in name:
        raise ValueError(f"invalid segment name {name!r}")
    return os.path.join(shm_dir(), name)


@dataclass
class ShmSegment:
    """An open, mmapped shared-memory segment.

    The fd is closed at construction (an established mmap does not need
    it), so segment lifetime is exactly the mmap object's lifetime: any
    memoryview/pa.Buffer over ``buf`` keeps the mapping alive via Python
    references — the basis of zero-copy reads in the object store.
    """

    name: str
    size: int
    _mmap: "mmap.mmap | None"  # None for zero-byte segments (nothing to map)

    @property
    def buf(self) -> memoryview:
        if self._mmap is None:
            return memoryview(b"")
        return memoryview(self._mmap)

    def close(self) -> None:
        """Explicitly invalidate the mapping (only safe when no views
        remain); usually unnecessary — GC does it."""
        if self._mmap is not None:
            self._mmap.close()

    def __enter__(self) -> "ShmSegment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def create(name: str, size: int) -> ShmSegment:
    """Create a new segment of ``size`` bytes (fails if it exists).

    ``size=0`` is allowed: the name exists, nothing is mapped."""
    if size < 0:
        raise ValueError("segment size must be non-negative")
    fd = os.open(
        _path(name),
        os.O_CREAT | os.O_EXCL | os.O_RDWR,
        stat.S_IRUSR | stat.S_IWUSR,
    )
    try:
        mm = None
        if size > 0:
            os.ftruncate(fd, size)
            mm = mmap.mmap(fd, size)
    except BaseException:
        os.close(fd)
        os.unlink(_path(name))
        raise
    os.close(fd)
    return ShmSegment(name=name, size=size, _mmap=mm)


def open_segment(name: str, readonly: bool = True) -> ShmSegment:
    """Attach to an existing segment."""
    flags = os.O_RDONLY if readonly else os.O_RDWR
    fd = os.open(_path(name), flags)
    try:
        size = os.fstat(fd).st_size
        mm = None
        if size > 0:
            prot = (
                mmap.PROT_READ if readonly else (mmap.PROT_READ | mmap.PROT_WRITE)
            )
            mm = mmap.mmap(fd, size, prot=prot)
    finally:
        os.close(fd)
    return ShmSegment(name=name, size=size, _mmap=mm)


def exists(name: str) -> bool:
    return os.path.exists(_path(name))


def unlink(name: str) -> bool:
    """Remove the segment name; memory is freed once all maps close."""
    try:
        os.unlink(_path(name))
        return True
    except FileNotFoundError:
        return False


def list_segments(prefix: str) -> list:
    d = shm_dir()
    return sorted(n for n in os.listdir(d) if n.startswith(prefix))
