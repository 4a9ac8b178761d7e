"""Device selection, env readers, sizes, sharding plans, the metrics
registry and the profiler hooks.

Imported lazily (PEP 562): the engine's modules import
``utils.profiling`` and must not pull in torch through ``utils.device``.
"""
import importlib

_EXPORTS = {
    "parse_memory_size": "raydp_tpu_torch.utils.memory",
    "format_memory_size": "raydp_tpu_torch.utils.memory",
    "find_free_port": "raydp_tpu_torch.utils.net",
    "local_ip": "raydp_tpu_torch.utils.net",
    "BlockSlice": "raydp_tpu_torch.utils.sharding",
    "divide_blocks": "raydp_tpu_torch.utils.sharding",
    "assignment_sample_counts": "raydp_tpu_torch.utils.sharding",
    "split_sizes": "raydp_tpu_torch.utils.sharding",
    "MetricsRegistry": "raydp_tpu_torch.utils.profiling",
    "StepTimer": "raydp_tpu_torch.utils.profiling",
    "ThroughputMeter": "raydp_tpu_torch.utils.profiling",
    "annotate": "raydp_tpu_torch.utils.profiling",
    "metrics": "raydp_tpu_torch.utils.profiling",
    "trace": "raydp_tpu_torch.utils.profiling",
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


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
