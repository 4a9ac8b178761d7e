"""Device selection, env readers and the metrics registry."""
from raydp_tpu_torch.utils.device import resolve_device, set_exact_float32
from raydp_tpu_torch.utils.profiling import metrics

__all__ = ["metrics", "resolve_device", "set_exact_float32"]
