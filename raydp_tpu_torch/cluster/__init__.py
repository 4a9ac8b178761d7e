"""The worker cluster (``Cluster``, placement) and the control plane's
transport, the standard-library RPC layer.

``Cluster`` and the placement names load at first use (PEP 562): a
process that only needs the RPC layer does not import the session's
modules.
"""
import importlib

from raydp_tpu_torch.cluster.rpc import (
    RpcClient,
    RpcError,
    RpcServer,
    RpcTimeout,
    RpcUnavailable,
)

_EXPORTS = {
    "Cluster": "raydp_tpu_torch.cluster.cluster",
    "ClusterError": "raydp_tpu_torch.cluster.cluster",
    "NodeInfo": "raydp_tpu_torch.cluster.placement",
    "PlacementError": "raydp_tpu_torch.cluster.placement",
    "PlacementGroup": "raydp_tpu_torch.cluster.placement",
    "detect_nodes": "raydp_tpu_torch.cluster.placement",
    "place": "raydp_tpu_torch.cluster.placement",
}

__all__ = sorted(["RpcClient", "RpcError", "RpcServer", "RpcTimeout",
                  "RpcUnavailable", *_EXPORTS])


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value
