"""Environment-variable readers shared by the serve-plane configs
(the counterpart of the helpers in ``raydp_tpu/serve/batching.py``)."""
from __future__ import annotations

import os


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
