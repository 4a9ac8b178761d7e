"""Build and load the port's hand-written CUDA kernels.

Each source under ``raydp_tpu_torch/csrc/`` is compiled with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, loaded with
``ctypes``. The build runs at first use, into ``raydp_tpu_torch/_build/``
(git-ignored), keyed by a hash of the source, every shared header
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt
and an unchanged one is reused. A failed build raises a
``CompileError`` (``utils/profiling.py``).
Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Tuple

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    # ptxas reports each kernel's registers, shared memory and spills;
    # the report is kept beside the library (``build_log``).
    "-Xptxas=-v",
)

# Every kernel source of the port; ``build_all`` compiles them together.
SOURCES = ("flash_fwd.cu", "flash_bwd.cu")

_mu = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError(
        "nvcc not found (searched PATH and $CUDA_HOME/bin): the port's CUDA "
        "kernels are built from source at first use"
    )


def _target(source: str) -> str:
    headers = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in [source] + headers:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            digest.update(name.encode() + b"\0" + f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _start(source: str) -> Tuple[str, str, subprocess.Popen]:
    target = _target(source)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return target, tmp, proc


def _finish(source: str, target: str, tmp: str,
            proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"nvcc failed on {source} (exit {proc.returncode}):\n{out}"
        )
    with open(f"{target}.log", "w") as f:
        f.write(out)
    os.replace(tmp, target)  # atomic: a reader never sees half a library


def build_all(sources: Iterable[str] = SOURCES) -> List[str]:
    """Compile every source that has no current library, one ``nvcc`` per
    source, all started together, as one compile
    (``utils/profiling.run_compile``: counted, billed, a failure raised
    as a ``CompileError``). Returns the library paths."""
    from raydp_tpu_torch.utils.profiling import run_compile

    os.makedirs(BUILD_DIR, exist_ok=True)
    sources = list(sources)
    missing = [src for src in sources if not os.path.exists(_target(src))]
    if missing:
        run_compile(_build, "nvcc:" + ",".join(missing), missing)
    return [_target(src) for src in sources]


def _build(sources: List[str]) -> None:
    running = [(src, *_start(src)) for src in sources]
    try:
        for src, target, tmp, proc in running:
            _finish(src, target, tmp, proc)
    finally:
        for _, _, _, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build_log(source: str) -> str:
    """What nvcc and ptxas printed when ``source``'s current library was
    built (empty if it was built before the log was kept)."""
    path = f"{_target(source)}.log"
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return f.read()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    with _mu:
        lib = _loaded.get(source)
        if lib is None:
            (path,) = build_all([source])
            lib = ctypes.CDLL(path)
            _loaded[source] = lib
        return lib
