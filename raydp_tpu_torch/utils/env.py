"""Environment-variable readers shared by the serve-plane configs
(the counterpart of the helpers in ``raydp_tpu/serve/batching.py``), and
the ``PYTHONPATH`` a child process is started with."""
from __future__ import annotations

import os
import sys


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if not raw:
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    return int(_env_float(name, float(default)))


def child_pythonpath() -> str:
    """This process's ``sys.path`` as a ``PYTHONPATH``, each entry made
    absolute: a child started with it (serve replicas, SPMD ranks)
    imports every module this process can, whatever its cwd."""
    return os.pathsep.join(
        os.path.abspath(p) if p else os.getcwd() for p in sys.path)
