"""Device selection, env readers and the metrics registry.

Imported lazily (PEP 562): the engine's modules import
``utils.profiling`` and must not pull in torch through ``utils.device``.
"""
import importlib

_EXPORTS = {
    "metrics": "raydp_tpu_torch.utils.profiling",
    "resolve_device": "raydp_tpu_torch.utils.device",
    "set_exact_float32": "raydp_tpu_torch.utils.device",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
