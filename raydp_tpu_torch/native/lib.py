"""ctypes bindings of the native host library, each beside its numpy twin.

``gather_matrix`` assembles a training chunk (rows ``indices`` of the
given numeric columns) into a contiguous row-major array, the loader's
pinned staging buffer. ``hash_bucket`` is the shuffle partitioner.

Each function takes ``native``: ``None`` uses the library where it
builds and loads and the numpy twin otherwise (a failed build is logged
once); ``True`` requires the library and raises its build error;
``False`` runs the twin. The twins compute the same values: bucket ids
bit for bit, gathers element for element.
"""
from __future__ import annotations

import ctypes
import logging
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from raydp_tpu_torch.native import build

DISABLE_ENV = "RAYDP_TPU_DISABLE_NATIVE"

_COL_TYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int64): 2,
    np.dtype(np.int32): 3,
    np.dtype(np.int16): 4,
    np.dtype(np.uint8): 5,
}

_log = logging.getLogger(__name__)
_lib: Optional[ctypes.CDLL] = None
_error: Optional[BaseException] = None
_tried = False


def _try_load() -> Optional[ctypes.CDLL]:
    global _lib, _error, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get(DISABLE_ENV) == "1":
        _error = RuntimeError(f"the native library is disabled by "
                              f"{DISABLE_ENV}=1")
        return None
    try:
        lib = ctypes.CDLL(build.ensure_built())
    except (RuntimeError, OSError, subprocess.SubprocessError) as exc:
        _error = exc
        _log.warning("native data-plane library unavailable, the numpy "
                     "twins run instead: %s", exc)
        return None
    lib.rdp_gather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p]
    for name in ("rdp_gather_matrix_f32", "rdp_gather_matrix_i32"):
        getattr(lib, name).argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
        ]
    lib.rdp_hash_bucket.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
    ]
    _lib = lib
    return _lib


def _library(native: Optional[bool]) -> Optional[ctypes.CDLL]:
    if native is False:
        return None
    lib = _try_load()
    if lib is None and native:
        raise RuntimeError(f"the native library was asked for and did not "
                           f"load: {_error}") from _error
    return lib


def native_available() -> bool:
    """Whether the library built and loaded (building it on first call)."""
    return _try_load() is not None


def _ptrs(cols):
    return (ctypes.c_void_p * len(cols))(
        *[c.ctypes.data_as(ctypes.c_void_p).value for c in cols])


def _types(cols) -> np.ndarray:
    return np.array([_COL_TYPES[c.dtype] for c in cols], dtype=np.int32)


def gather_matrix(columns: Sequence[np.ndarray], indices: np.ndarray,
                  out_dtype=np.float32, out: Optional[np.ndarray] = None,
                  native: Optional[bool] = None) -> np.ndarray:
    """``out[i, c] = columns[c][indices[i]]`` cast to ``out_dtype``.

    Columns must be 1-D, contiguous, numeric. ``out_dtype`` must be
    float32 or int32 (the two staging formats).
    """
    ncols = len(columns)
    if ncols == 0:
        raise ValueError("need at least one column")
    out_dtype = np.dtype(out_dtype)
    if out_dtype not in (np.dtype(np.float32), np.dtype(np.int32)):
        raise ValueError("out_dtype must be float32 or int32")
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    n = indices.shape[0]
    cols = [np.ascontiguousarray(c) for c in columns]
    _check_indices(indices, min(c.shape[0] for c in cols))
    if out is None:
        out = np.empty((n, ncols), dtype=out_dtype)
    elif (out.shape != (n, ncols) or out.dtype != out_dtype
          or not out.flags.c_contiguous):
        raise ValueError("out must be C-contiguous (n, ncols) of out_dtype")
    lib = _library(native)
    if lib is not None and all(c.dtype in _COL_TYPES for c in cols):
        fn = (lib.rdp_gather_matrix_f32 if out_dtype == np.float32
              else lib.rdp_gather_matrix_i32)
        fn(_ptrs(cols), _types(cols).ctypes.data_as(ctypes.c_void_p), ncols,
           indices.ctypes.data_as(ctypes.c_void_p), n,
           out.ctypes.data_as(ctypes.c_void_p))
        return out
    for c_idx, col in enumerate(cols):
        out[:, c_idx] = col[indices].astype(out_dtype, copy=False)
    return out


def _check_indices(indices: np.ndarray, n_src: int) -> None:
    """The native kernels do raw pointer arithmetic: validate here, with
    the IndexError the numpy twin would raise."""
    if indices.size and (indices.min() < 0 or indices.max() >= n_src):
        raise IndexError(f"gather indices out of range [0, {n_src}) "
                         f"(min={indices.min()}, max={indices.max()})")


def hash_bucket(columns: Sequence[np.ndarray], n_buckets: int,
                native: Optional[bool] = None) -> Optional[np.ndarray]:
    """Stable bucket id of every row from numeric key columns (the
    shuffle partitioner). ``None`` when a column's dtype is unsupported:
    the caller then hashes another way.

    Every partition of one exchange must send equal keys to equal
    buckets, so the result depends only on the values: the numpy twin
    of the splitmix64 kernel gives the same ids bit for bit.
    """
    if not columns:
        return None
    cols = []
    for c in columns:
        c = np.ascontiguousarray(c)
        if c.dtype not in _COL_TYPES or c.ndim != 1:
            return None
        cols.append(c)
    n = cols[0].shape[0]
    if any(c.shape[0] != n for c in cols):
        return None
    lib = _library(native)
    if lib is None:
        return _hash_bucket_numpy(cols, n_buckets)
    out = np.empty(n, dtype=np.int64)
    lib.rdp_hash_bucket(_ptrs(cols),
                        _types(cols).ctypes.data_as(ctypes.c_void_p),
                        len(cols), n, int(n_buckets),
                        out.ctypes.data_as(ctypes.c_void_p))
    return out


def _splitmix64_np(x: np.ndarray) -> np.ndarray:
    """Vectorised twin of the C++ ``rdp_mix64`` (bit-exact)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _load_bits_np(c: np.ndarray) -> np.ndarray:
    """Twin of the C++ ``load_bits``: the uint64 the kernel hashes."""
    if c.dtype == np.float32:
        c = np.where(c == 0.0, np.float32(0.0), c)  # -0.0 -> +0.0
        return c.view(np.uint32).astype(np.uint64)
    if c.dtype == np.float64:
        c = np.where(c == 0.0, 0.0, c)
        return c.view(np.uint64)
    if c.dtype == np.uint8:
        return c.astype(np.uint64)
    # signed integers: sign-extended as the C++ int64_t cast does
    return c.astype(np.int64).view(np.uint64)


def _hash_bucket_numpy(cols, n_buckets: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = np.full(cols[0].shape[0], 0x517CC1B727220A95, dtype=np.uint64)
        for i, c in enumerate(cols):
            v = _load_bits_np(c) + np.uint64(
                (0x100000001B3 * i) & 0xFFFFFFFFFFFFFFFF)
            h = _splitmix64_np(h ^ _splitmix64_np(v))
        return (h % np.uint64(n_buckets)).astype(np.int64)


def gather_rows(src: np.ndarray, indices: np.ndarray,
                native: Optional[bool] = None) -> np.ndarray:
    """Row gather of a 2-D contiguous array."""
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    if src.ndim != 2:
        raise ValueError("gather_rows expects a 2-D array")
    _check_indices(indices, src.shape[0])
    lib = _library(native)
    if lib is None or not src.flags.c_contiguous:
        return src[indices]
    out = np.empty((indices.shape[0], src.shape[1]), dtype=src.dtype)
    lib.rdp_gather(src.ctypes.data_as(ctypes.c_void_p),
                   indices.ctypes.data_as(ctypes.c_void_p), indices.shape[0],
                   src.strides[0], out.ctypes.data_as(ctypes.c_void_p))
    return out
