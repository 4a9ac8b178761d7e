"""Build of the native host library of the data plane.

Compiles ``raydp_tpu_torch/native/src/*.cpp`` with ``g++`` into one
shared library with a plain C interface, loaded with ``ctypes``. The
build runs at first use, into ``raydp_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the sources, the flags and the compiler's version, so
an edited source is rebuilt and an unchanged one is reused. The kernels
are OpenMP-parallel where the compiler has OpenMP; a g++ without it
(one whose ``-fopenmp`` fails on ``libgomp``) builds them single-threaded,
as the JAX package's build falls back, and says so in the log. Any other
failure raises (and is logged). Nothing here runs at import time.
"""
from __future__ import annotations

import functools
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from typing import List

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG_DIR, "native", "src")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

# Tried in order: OpenMP first, then without it.
FLAG_SETS = (("-O3", "-fopenmp", "-shared", "-fPIC"),
             ("-O3", "-shared", "-fPIC"))
# What g++ says when it has no OpenMP: only then is the second set tried.
_NO_OPENMP = ("libgomp", "fopenmp")

_log = logging.getLogger(__name__)


def sources() -> List[str]:
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith(".cpp"))


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the native data-plane "
                           "library is built from source at first use")
    return found


@functools.lru_cache(maxsize=None)
def _version(gxx: str) -> str:
    return subprocess.run([gxx, "-dumpfullversion"], capture_output=True,
                          text=True, check=True).stdout.strip()


def lib_path(flags=FLAG_SETS[0]) -> str:
    """The library's path for the current sources, ``flags`` and
    compiler."""
    gxx = _gxx()
    version = _version(gxx)
    digest = hashlib.sha256(" ".join((gxx, version) + tuple(flags)).encode())
    for path in sources():
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR,
                        f"libraydp_native-{digest.hexdigest()[:16]}.so")


def built_flags() -> tuple:
    """The flags of the library :func:`ensure_built` returns."""
    for flags in FLAG_SETS:
        if os.path.exists(lib_path(flags)):
            return flags
    raise RuntimeError("the native library is not built")


def ensure_built() -> str:
    """Build the library if its current version is missing; return its
    path. Raises ``RuntimeError`` when g++ is missing or fails. No lock
    is held while g++ runs: each build writes a temporary of its own and
    renames it into place, so two threads or processes that race on a
    first build each compile and the last rename wins (the same library;
    ``native/lib.py`` loads it once a process)."""
    for flags in FLAG_SETS:
        if os.path.exists(lib_path(flags)):
            return lib_path(flags)
    os.makedirs(BUILD_DIR, exist_ok=True)
    errors = []
    for flags in FLAG_SETS:
        target = lib_path(flags)
        # A private temporary, renamed into place: a concurrent build
        # never writes it and a reader never loads half a library.
        tmp = f"{target}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_gxx(), *flags, "-o", tmp, *sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode == 0:
            os.replace(tmp, target)
            if errors:
                _log.warning("g++ has no OpenMP here; the native "
                             "library is built single-threaded:\n%s",
                             errors[0])
            return target
        if os.path.exists(tmp):
            os.remove(tmp)
        errors.append(f"{' '.join(flags)}: exit {proc.returncode}\n"
                      f"{proc.stdout}{proc.stderr}")
        if not any(word in proc.stderr for word in _NO_OPENMP):
            break
    msg = "g++ failed on the native library:\n" + "\n".join(errors)
    _log.error(msg)
    raise RuntimeError(msg)
